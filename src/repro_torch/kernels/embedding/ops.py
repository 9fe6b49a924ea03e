"""The port's embedding backward and the gather built on it.

``embedding_backward_groups(plan, grad_outs, rows)`` is the gradient of a
gather for one or more groups of tables read at the same keys (a CTR
model's fm and LR tables): for each group ``grad[r]`` sums the rows of its
``grad_out`` whose key is ``r``, keys outside ``[0, rows)`` dropped. The
keys come sorted (``plan``, a ``SortPlan``: ``sort_plan(keys)``, a stable
``torch.sort``, or one built from sorts the caller already made), and each
key's segment is summed in a fixed order that depends on the sorted keys
alone: on a CUDA tensor by the kernel of ``csrc/embedding_backward.cu``
(or the call raises), every group in one call, on a CPU tensor by its
plain version (``ref.py``), which sums in the same order. So its result
repeats bit for bit, where PyTorch's CUDA ``embedding_dense_backward``
does not, and a group's gradient is the same bits whatever groups run
beside it. ``.launches`` counts the kernel's runs (a run is one call of
its launcher: a launch per level of the sum); ``sort_plan.sorts`` counts
the sorts made for it. ``embedding_backward(keys, grad_out, rows)`` is
the one-group form, with its own sort.

``gather_fields(groups, ids, plan=None)`` is the forward that uses it:
for each group of ``F`` tables, ``out[b, f] = tables[f][min(ids[b, f],
V_f - 1)]``, ``[B, F, D_g]``, whose backward passes nothing for an id
``>= V_f`` (the reference's clamping gather and dropping scatter) and
computes every group's and every table's gradient in one call over all
``B * F`` rows: the tables' rows laid end to end in one buffer a group
(``FieldLayout``, which also lays out ``models.embedding.field_counts``),
each table's gradient a view of it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ..extension import build
from . import ref
from .ref import MAX_GROUPS
from .ref import embedding_backward_groups_reference as reference_groups
from .ref import embedding_backward_reference as reference

ALIGN_ROWS = 64


class SortPlan(NamedTuple):
    """The order the backward sums in: ``keys`` [N] int32, each key's
    positions contiguous (ascending but for dropped keys, which may end
    each field's block); ``perm`` [N] int64, the cotangent row of each
    sorted position."""

    keys: torch.Tensor
    perm: torch.Tensor


def sort_plan(keys: torch.Tensor) -> SortPlan:
    """The stable sort of ``[N]`` int32 ``keys`` (deterministic)."""
    if not isinstance(keys, torch.Tensor) or keys.dim() != 1 \
            or keys.dtype != torch.int32:
        raise TypeError("keys must be a 1-D int32 torch.Tensor")
    sort_plan.sorts += 1
    return SortPlan(*torch.sort(keys, stable=True))


sort_plan.sorts = 0


def embedding_backward_groups(plan: SortPlan, grad_outs: Sequence[torch.Tensor],
                              rows: int) -> list:
    """Each group's ``[rows, D_g]`` gradient of a gather whose output row
    ``i`` read row ``keys[i]``, from the keys' ``plan`` and each group's
    ``[N, D_g]`` cotangent (float32 on the card), in one call.
    Deterministic: the same inputs give the same bits."""
    keys, perm = plan
    if not isinstance(keys, torch.Tensor) or keys.dim() != 1 \
            or keys.dtype != torch.int32:
        raise TypeError("the plan's keys must be a 1-D int32 torch.Tensor")
    n = keys.shape[0]
    if not isinstance(perm, torch.Tensor) or perm.dtype != torch.int64 \
            or tuple(perm.shape) != (n,):
        raise TypeError(f"the plan's perm must be an int64 [{n}] tensor")
    grad_outs = list(grad_outs)
    if not 1 <= len(grad_outs) <= MAX_GROUPS:
        raise ValueError(f"1 to {MAX_GROUPS} groups, got {len(grad_outs)}")
    for g in grad_outs:
        if not isinstance(g, torch.Tensor) or g.dim() != 2 \
                or g.shape[0] != n:
            raise ValueError(f"each grad_out must be [{n}, D], got "
                             f"{tuple(getattr(g, 'shape', ()))}")
        if g.device != keys.device or perm.device != keys.device:
            raise ValueError(f"a grad_out or perm is on another device than "
                             f"the keys ({keys.device})")
    if not 0 <= rows < 2**31:
        raise ValueError(f"rows {rows} outside [0, 2**31)")
    dev = keys.device
    if dev.type == "cpu":
        return reference_groups(plan, grad_outs, rows)
    if dev.type != "cuda":
        raise ValueError(f"no embedding backward kernel for device {dev}")
    if any(g.dtype != torch.float32 for g in grad_outs):
        raise TypeError("the kernel takes float32 grad_outs")
    grad_outs = [g.contiguous() for g in grad_outs]
    dims = [g.shape[1] for g in grad_outs]
    # one zero fill for every group; each group's block starts 256 bytes
    # aligned, as an allocation of its own would
    sizes = [-(-rows * d // ALIGN_ROWS) * ALIGN_ROWS for d in dims]
    buf = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    grads = [b[:rows * d].view(rows, d)
             for b, d in zip(torch.split(buf, sizes), dims)]
    cap = ref.next_entries(n)
    scratch_keys = torch.empty((2, cap), dtype=torch.int32, device=dev)
    scratch_vals = torch.empty((2, cap * sum(dims)), dtype=torch.float32,
                               device=dev)
    build().embedding_backward(keys, perm, grad_outs, grads, scratch_keys,
                               scratch_vals)
    embedding_backward_groups.launches += 1
    return grads


embedding_backward_groups.launches = 0


def embedding_backward(keys: torch.Tensor, grad_out: torch.Tensor,
                       rows: int) -> torch.Tensor:
    """``[rows, D]`` gradient of a gather whose output row i read row
    ``keys[i]``: ``keys`` [N] int32, ``grad_out`` [N, D] float (float32
    on the card); one group, its own sort."""
    return embedding_backward_groups(sort_plan(keys), [grad_out], rows)[0]


class FieldLayout(NamedTuple):
    """Per-field rows laid end to end in one buffer of ``rows`` rows (a
    lookup's gradient, a batch's id counts): field f's ``vocabs[f]`` rows at
    ``starts[f]``, a multiple of ALIGN_ROWS (256 bytes at one float a row,
    so the fused kernel's aligned path takes every field's view).
    ``vocab_t``, ``start_t``: the same as int64 tensors on the ids'
    device, made once per layout, so a step copies nothing to the card."""

    vocabs: tuple
    starts: tuple
    rows: int
    vocab_t: torch.Tensor
    start_t: torch.Tensor

    def keys(self, ids: torch.Tensor) -> torch.Tensor:
        """``[B * F]`` int32 rows of the buffer that ``[B, F]`` ids read,
        row-major; an id outside ``[0, V_f)`` gets ``rows`` (dropped)."""
        ids = ids.to(torch.int64)
        inside = (ids >= 0) & (ids < self.vocab_t)
        return torch.where(inside, ids + self.start_t,
                           self.rows).to(torch.int32).reshape(-1)

    def split(self, buf: torch.Tensor) -> list:
        """Each field's ``[V_f, ...]`` rows: a view of ``buf``."""
        return [buf[s:s + v] for s, v in zip(self.starts, self.vocabs)]


@functools.cache
def field_layout(vocabs: tuple, device: torch.device) -> FieldLayout:
    starts, end = [], 0
    for v in vocabs:
        start = -(-end // ALIGN_ROWS) * ALIGN_ROWS
        starts.append(start)
        end = start + v
    return FieldLayout(tuple(vocabs), tuple(starts), end,
                       torch.tensor(vocabs, dtype=torch.int64, device=device),
                       torch.tensor(starts, dtype=torch.int64, device=device))


class _GatherFields(torch.autograd.Function):
    """For each group, ``out[b, f] = tables[f][min(ids[b, f], V_f - 1)]``;
    the backward is one ``embedding_backward_groups`` call over all the
    groups and fields, with ``plan`` or else a sort of its own."""

    @staticmethod
    def forward(ctx, ids, plan, *tables):
        n = ids.shape[1]
        ctx.save_for_backward(ids)
        ctx.plan = plan
        ctx.vocabs = tuple(t.shape[0] for t in tables[:n])
        if _is_dtensor(ids):
            return _sharded_lookup(ids, tables)
        cols = [torch.clamp_max(ids[:, f], t.shape[0] - 1)
                for f, t in enumerate(tables[:n])]
        return tuple(
            torch.stack([F.embedding(c, t)
                         for c, t in zip(cols, tables[i:i + n])], dim=1)
            for i in range(0, len(tables), n))

    @staticmethod
    def backward(ctx, *grads):
        if not any(ctx.needs_input_grad[2:]):
            return (None,) * len(ctx.needs_input_grad)
        ids, = ctx.saved_tensors
        if _is_dtensor(ids):
            return (None, None, *_sharded_table_grads(ctx.vocabs, ids,
                                                      grads))
        return (None, None, *_table_grads(ctx.plan, ctx.vocabs, ids, grads))


def _table_grads(plan, vocabs, ids, grads) -> list:
    """Every table's gradient from one ``embedding_backward_groups``
    call (``plan``, or a sort of ``ids``' keys). On fake tensors (the
    dry-run's trace) the segmented sum's writes, whose number depends on
    the ids' values, cannot run; ``_traced_stand_in`` takes its place."""
    from torch._subclasses.fake_tensor import is_fake

    if is_fake(ids):
        return _traced_stand_in(vocabs, ids, grads)
    layout = field_layout(vocabs, ids.device)
    plan = plan if plan is not None else sort_plan(layout.keys(ids))
    gs = embedding_backward_groups(
        plan, [g.reshape(-1, g.shape[-1]) for g in grads], layout.rows)
    return [t for g in gs for t in layout.split(g)]


def _traced_stand_in(vocabs, ids, grads) -> list:
    """What the dry-run counts for the backward on fake tensors: each
    field's rows added into a zero table gradient (``index_add_``, the
    reference's transpose of its gather), the same bytes in and out as
    the segmented sum without its data-dependent run writes."""
    out = []
    for g in grads:
        for f, v in enumerate(vocabs):
            col = torch.clamp_max(ids[:, f].to(torch.int64), v - 1)
            out.append(torch.zeros((v, g.shape[-1]), dtype=g.dtype,
                                   device=g.device).index_add_(
                0, col, g[:, f]))
    return out


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _sharded_lookup(ids, tables) -> tuple:
    """``_GatherFields``' forward with DTensor ids split over the batch
    and tables split by rows (the dry-run), as an SPMD partitioner does a
    gather from a row-sharded table: each table all-gathered over the mesh
    dims that split the batch; on the dims that split its rows each rank
    looks its batch's ids up in its own block (ids outside it read zeros)
    and the output is a partial sum over those dims (a table not split
    over one of them counts on its first rank only)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = ids.device_mesh
    n = ids.shape[1]
    batch = [isinstance(p, Shard) and p.dim == 0 for p in ids.placements]
    ids_pl = [Shard(0) if b else Replicate() for b in batch]
    rows = [[not b and isinstance(p, Shard) and p.dim == 0
             for b, p in zip(batch, t.placements)] for t in tables]
    row_dims = [any(r[m] for r in rows) for m in range(mesh.ndim)]
    coord = [mesh.get_local_rank(m) for m in range(mesh.ndim)]
    sizes = list(mesh.shape)

    def local(ids, *blocks):
        outs = []
        for i in range(0, len(blocks), n):
            cols = []
            for f in range(n):
                t, split = blocks[i + f], rows[i + f]
                c = torch.clamp_max(ids[:, f], tables[f].shape[0] - 1)
                block, own = 0, True
                for m in range(mesh.ndim):
                    if split[m]:
                        block = block * sizes[m] + coord[m]
                    elif row_dims[m]:
                        own = own and coord[m] == 0
                idx = c - block * t.shape[0]
                ok = (idx >= 0) & (idx < t.shape[0]) & own
                cols.append(F.embedding(idx.clamp(0, t.shape[0] - 1), t)
                            * ok[:, None].to(t.dtype))
            outs.append(torch.stack(cols, dim=1))
        return tuple(outs)

    out = [Partial() if r else (Shard(0) if b else Replicate())
           for b, r in zip(batch, row_dims)]
    in_pl = [ids_pl] + [[Shard(0) if r else Replicate() for r in split]
                        for split in rows]
    return local_map(local, out_placements=(out,) * (len(tables) // n),
                     in_placements=tuple(in_pl), device_mesh=mesh,
                     redistribute_inputs=True)(ids, *tables)


def _sharded_table_grads(vocabs, ids, grads) -> list:
    """``_table_grads`` with the ids and the output gradients as DTensors
    split over the batch (the dry-run): each rank runs the backward on
    its own rows of the batch into a whole-table gradient, a partial sum
    over the mesh dims that split the batch (``sharding.act.
    batch_partial``)."""
    from ...sharding.act import batch_partial

    return list(batch_partial(
        lambda ids, *gs: tuple(_table_grads(None, vocabs, ids, gs)),
        len(grads) * len(vocabs), ids, *grads))


def gather_fields(groups: Sequence[Sequence[torch.Tensor]], ids: torch.Tensor,
                  plan: Optional[SortPlan] = None) -> tuple:
    """One ``[B, F, D_g]`` output a group: ``F`` tables (``[V_f, D_g]``
    each, one dtype and D a group; field f's V_f the same in every group)
    at ``[B, F]`` ids, column f from table f: an id ``>= V_f`` reads the
    last row and passes no gradient back. Every group's tables get their
    gradients from one ``embedding_backward_groups`` call, which sums in
    ``plan``'s order: it must sort ``field_layout(vocabs).keys(ids)`` as
    a stable sort would, up to the place of dropped keys; None sorts."""
    groups = [list(g) for g in groups]
    if not 1 <= len(groups) <= MAX_GROUPS:
        raise ValueError(f"1 to {MAX_GROUPS} groups, got {len(groups)}")
    if any(len(g) != ids.shape[1] for g in groups) or ids.dim() != 2:
        raise ValueError(f"ids must be [B, F] with F tables a group, got "
                         f"{tuple(ids.shape)} and {[len(g) for g in groups]}")
    vocabs = [[t.shape[0] for t in g] for g in groups]
    if any(v != vocabs[0] for v in vocabs):
        raise ValueError(f"the groups' tables differ in rows: {vocabs}")
    return _GatherFields.apply(ids, plan, *[t for g in groups for t in g])
