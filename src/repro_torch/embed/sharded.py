"""Row-sharded embedding placement: the per-rank math of the sharded steps.

A port of ``repro.embed.sharded``. Tables are partitioned by row (id) over
the grid's ``"model"`` axis while the batch splits over ``"data"``; the
dense tower is replicated. CowClip's clip, the coupled L2 decay and Adam
are row-local, so once a rank holds its rows' gradient and batch counts
its update needs no communication.

Two id -> (shard, local row) mappings, both over a padded ``rows_per_shard
= ceil(vocab / n_shards)``:

* ``div`` (contiguous): shard ``id // R``, local ``id % R``;
* ``mod`` (round-robin): shard ``id % S``, local ``id // S`` (spreads the
  hot low ids of a frequency-sorted vocabulary over the shards).

Where the JAX package runs one process over the whole grid and holds each
table as one global array, the port runs one process a rank, and a rank
holds only its own rows: ``[rows_per_shard, D]`` of w, m and v for each
(group, field), in physical order (``prepare`` pads the logical table as
``pad_rows`` does and keeps the rank's block: rows ``[r*R, (r+1)*R)``
under ``div``, rows ``local*S + r`` under ``mod``). ``export`` all-gathers
the blocks over ``"model"``, inverts the layout and strips the pads, so
checkpoints and eval see ``[vocab, D]`` tables. The reference permutes
the whole table logical -> physical -> logical around every ``mod`` step;
the port keeps the physical layout between steps instead: a permutation
moves values without rounding them, so the bits are the same.

Per rank, the forward lookup is mask-and-sum: ids of other shards read a
local row and are zeroed, then one ``all_reduce`` SUM over ``"model"``
assembles the ``[batch_local, F, D]`` embedding. The backward is the
transpose: the embedding cotangent of owned ids summed onto local rows (the
port's embedding backward, foreign ids keyed to be dropped), then an
``all_reduce`` SUM over ``"data"`` adds every batch slice's contribution.

The placement rule of the reference's ``sharding.specs.ctr_param_spec``
(tables' rows over ``"model"``, padded when they do not divide; the tower
whole) is ``ctr_param_spec`` here.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.tree import tree_map
from ..kernels.embedding import field_layout

SCHEMES = ("div", "mod")


def _owner_and_row(ids: torch.Tensor, rows_per_shard, n_shards: int,
                   scheme: str):
    """The one id -> ``(shard, local row)`` mapping; ``rows_per_shard`` an
    int or a tensor that broadcasts against ``ids`` (one a field)."""
    if scheme == "div":
        return ids // rows_per_shard, ids % rows_per_shard
    return ids % n_shards, ids // n_shards


@dataclasses.dataclass(frozen=True)
class RowShardPlan:
    """Static id -> (shard, local row) mapping for one field's table."""

    vocab: int
    n_shards: int
    scheme: str = "div"

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown partition scheme {self.scheme!r}; "
                             f"expected one of {SCHEMES}")
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")

    @property
    def rows_per_shard(self) -> int:
        return math.ceil(self.vocab / self.n_shards)

    @property
    def padded_vocab(self) -> int:
        return self.rows_per_shard * self.n_shards

    def shard_of(self, ids: torch.Tensor) -> torch.Tensor:
        return _owner_and_row(ids, self.rows_per_shard, self.n_shards,
                              self.scheme)[0]

    def local_row(self, ids: torch.Tensor) -> torch.Tensor:
        return _owner_and_row(ids, self.rows_per_shard, self.n_shards,
                              self.scheme)[1]

    # physical = the shards' blocks end to end; logical = row i holds id i

    @property
    def is_identity_layout(self) -> bool:
        return self.scheme == "div" or self.n_shards == 1

    def logical_of_physical(self) -> np.ndarray:
        """perm with physical_table = logical_padded[perm]."""
        p = np.arange(self.padded_vocab)
        if self.is_identity_layout:
            return p
        r, loc = p // self.rows_per_shard, p % self.rows_per_shard
        return loc * self.n_shards + r

    def physical_of_logical(self) -> np.ndarray:
        """perm with logical_padded = physical_table[perm]."""
        inv = np.empty(self.padded_vocab, dtype=np.int64)
        inv[self.logical_of_physical()] = np.arange(self.padded_vocab)
        return inv

    def shard_rows(self, shard: int) -> np.ndarray:
        """The padded logical rows shard ``shard`` holds, in its physical
        order."""
        r = self.rows_per_shard
        return self.logical_of_physical()[shard * r:(shard + 1) * r]


def make_plans(vocab_sizes: Sequence[int], n_shards: int,
               scheme: str = "div") -> Dict[str, RowShardPlan]:
    return {f"field_{i}": RowShardPlan(v, n_shards, scheme)
            for i, v in enumerate(vocab_sizes)}


def pad_rows(table: torch.Tensor, padded_vocab: int) -> torch.Tensor:
    """Zero-pad a ``[vocab, ...]`` table to ``padded_vocab`` rows. Pad rows
    start at zero and stay there: zero gradient, zero count, and the
    coupled-L2 decay of a zero row is zero."""
    extra = padded_vocab - table.shape[0]
    if extra == 0:
        return table
    return torch.cat([table, table.new_zeros((extra,) + table.shape[1:])])


def unpad_rows(table: torch.Tensor, vocab: int) -> torch.Tensor:
    return table if table.shape[0] == vocab else table[:vocab]


def _permute(table: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    return table[torch.as_tensor(perm, device=table.device)]


def ctr_param_spec(path: str, shape: tuple, n_model: int) -> tuple:
    """The placement of one CTR param / Adam moment / ``last_step`` leaf, as
    the axis each dimension splits over (the reference's
    ``PartitionSpec``): a field table's rows over ``"model"`` when they
    divide it, else replicated (the sharded bundles pad first, so the row
    rule always fits); everything else, the dense tower first, replicated
    whole."""
    name = path.split("/")[-1]
    if re.match(r"field_\d+$", name) and len(shape) in (1, 2) \
            and shape[0] % n_model == 0:
        return ("model",) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


# ---------------------------------------------------------------------------
# per-rank building blocks
# ---------------------------------------------------------------------------


def owned_mask_and_rows(ids_col: torch.Tensor, plan: RowShardPlan,
                        shard: int):
    """``owned_rows`` of one field's batch column on shard ``shard``:
    ``(mine, local)``, ``mine`` the ids it owns, ``local`` their int64
    local row and ``rows_per_shard`` for a foreign id."""
    mine, local = owned_rows(ids_col[:, None], [plan], shard)
    return mine[:, 0], local[:, 0]


def decay_scale(last_step: torch.Tensor, step: torch.Tensor,
                factor: float) -> torch.Tensor:
    """Each row's pending decay at the start of step ``step``:
    ``factor**k`` for ``k = (step - 1) - last_step > 0``, exactly 1.0
    otherwise, as f32. The base is a 0-dim tensor filled on the rows'
    device (no copy from the host, so a CUDA graph may capture it), raised
    to a float exponent elementwise: ``powf``, as the catch-up kernel
    (``csrc/sparse_catchup.cu``) computes the same power."""
    k = (step - 1) - last_step.to(torch.int32)
    base = torch.full((), factor, dtype=torch.float32, device=k.device)
    return torch.where(k > 0, base ** k.to(torch.float32),
                       torch.ones((), dtype=torch.float32, device=k.device))


def _read_rows(table, rows, last_step=None, step=None, factor=None):
    """``table[rows]``; with ``last_step``, each row times its pending
    decay (``decay_scale``)."""
    out = table[rows]
    if last_step is not None:
        out = out * decay_scale(last_step[rows], step, factor)[:, None]
    return out


def decayed_lookup_partial(table: torch.Tensor, last_step: torch.Tensor,
                           ids_col: torch.Tensor, plan: RowShardPlan,
                           shard: int, step: torch.Tensor,
                           factor: float) -> torch.Tensor:
    """This shard's additive part of one field's lookup, owned ids' rows
    (zeros elsewhere; a SUM over ``"model"`` completes the gather), with
    each row's pending lazy-L2 decay applied inline, so the forward reads
    the raw tables: rows with no pending decay pass through bit for
    bit."""
    mine, local = owned_mask_and_rows(ids_col, plan, shard)
    rows = _read_rows(table, torch.clamp_max(local, table.shape[0] - 1),
                      last_step, step, factor)
    return torch.where(mine[:, None], rows, torch.zeros_like(rows))


def rowgrad_partial(g_col: torch.Tensor, ids_col: torch.Tensor,
                    plan: RowShardPlan, shard: int) -> torch.Tensor:
    """This batch slice's ``[rows_per_shard, D]`` gradient of one field's
    rows (the transpose of the masked lookup); a SUM over ``"data"``
    adds the other slices'. The plain form of one field: the step sums
    every field and group in one call of the embedding backward."""
    from ..kernels.embedding import embedding_backward

    _, keys = owned_mask_and_rows(ids_col, plan, shard)
    return embedding_backward(keys.to(torch.int32), g_col,
                              plan.rows_per_shard)


def counts_partial(ids_col: torch.Tensor, plan: RowShardPlan,
                   shard: int) -> torch.Tensor:
    """This batch slice's occurrence count of each owned id (CowClip's
    ``cnt`` on the shard); a SUM over ``"data"`` globalizes it."""
    _, keys = owned_mask_and_rows(ids_col, plan, shard)
    out = torch.zeros(plan.rows_per_shard + 1, dtype=torch.float32,
                      device=ids_col.device)
    out.index_add_(0, keys, torch.ones(keys.shape[0], dtype=torch.float32,
                                       device=ids_col.device))
    return out[:plan.rows_per_shard]


def shard_update(w, g, cnt, m, v, step, *, clip=True, r=1.0, zeta=1e-5,
                 lr=1e-4, l2=1e-5, b1=0.9, b2=0.999, eps=1e-8):
    """The dense update of one table shard, in place: the reference's
    ``shard_update`` (touched rows CowClip -> coupled L2 -> Adam, absent
    rows one decay step with the moments held) is the fused CowClip
    kernel's function, so it runs kernel 1 (``kernels.cowclip
    .fused_cowclip_adam``: the CUDA kernel on the card, its plain version
    on the CPU). ``step`` is the step's ``StepScalars``. The kernel always
    clips a table with D >= 2; ``clip=False`` passes ``zeta = +inf``, so
    a touched row's threshold ``cnt * max(r*|w|, zeta)`` is infinite and
    its gradient is scaled by exactly ``min(1, inf) = 1``. Returns
    ``(w, m, v)``."""
    from ..kernels.cowclip import fused_cowclip_adam

    return fused_cowclip_adam(w, g, cnt, m, v, step, r=r,
                              zeta=zeta if clip else math.inf, lr=lr, l2=l2,
                              b1=b1, b2=b2, eps=eps)


@functools.cache
def _rows_a_shard(rows: tuple, device: torch.device) -> torch.Tensor:
    """``[F]`` int64 rows a shard, on ``device``, made once (a step copies
    nothing to the card)."""
    return torch.tensor(rows, dtype=torch.int64, device=device)


def owned_rows(ids: torch.Tensor, plans: Sequence[RowShardPlan],
               shard: int):
    """Shard ``shard``'s owned ids of every field at once: ``[B, F]`` ids ->
    ``(mine, local)``, ``local`` int64 with every foreign id at its field's
    ``rows_per_shard`` (past the shard: a key the embedding backward and
    the counts drop, a row the gather clamps)."""
    rows_t = _rows_a_shard(tuple(p.rows_per_shard for p in plans),
                           ids.device)
    owner, loc = _owner_and_row(ids.to(torch.int64), rows_t,
                                plans[0].n_shards, plans[0].scheme)
    mine = owner == shard
    return mine, torch.where(mine, loc, rows_t)


def local_layout(plans: Sequence[RowShardPlan], device):
    """The ``FieldLayout`` of a rank's local rows: field f's
    ``rows_per_shard`` rows at their aligned start in one buffer (the
    embedding backward's gradient, the counts)."""
    return field_layout(tuple(p.rows_per_shard for p in plans),
                        torch.device(device))


def lookup_groups(groups: Sequence[dict], mine: torch.Tensor,
                  local: torch.Tensor, model_group, *, last_steps=None,
                  step=None, factor=None) -> list:
    """The assembled ``[B, F, D_g]`` embedding of each group of local
    tables: each rank's masked partial lookup (with ``last_steps``, each
    owned row's pending decay applied inline, ``decayed_lookup_partial``),
    summed over ``"model"`` by one ``all_reduce`` a group. No autograd:
    the step takes its gradients w.r.t. the assembled embedding."""
    outs = []
    with torch.no_grad():
        n = local.shape[1]
        for gi, group in enumerate(groups):
            cols = []
            for f in range(n):
                t = group[f"field_{f}"]
                ls = None if last_steps is None else last_steps[gi][
                    f"field_{f}"]
                cols.append(_read_rows(
                    t, torch.clamp_max(local[:, f], t.shape[0] - 1), ls,
                    step, factor))
            part = torch.where(mine[..., None], torch.stack(cols, dim=1),
                               0.0)
            dist.all_reduce(part, op=dist.ReduceOp.SUM, group=model_group)
            outs.append(part)
    return outs


def _keep_block(padded: torch.Tensor, plan: RowShardPlan,
                shard: int) -> torch.Tensor:
    """Shard ``shard``'s block of a padded logical ``[padded_vocab, ...]``
    leaf, in its physical order (a new contiguous tensor)."""
    rows = plan.rows_per_shard
    if plan.is_identity_layout:
        return padded[shard * rows:(shard + 1) * rows].contiguous()
    return _permute(padded, plan.shard_rows(shard)).contiguous()


def _gather_logical(block: torch.Tensor, plan: RowShardPlan,
                    mesh) -> torch.Tensor:
    """The padded logical ``[padded_vocab, ...]`` leaf from every rank's
    block: an all-gather over ``"model"`` (a collective), then the inverse
    of the layout. The pad rows stay."""
    parts = [torch.empty_like(block) for _ in range(mesh.model)]
    dist.all_gather(parts, block.contiguous(), group=mesh.model_group)
    physical = torch.cat(parts)
    if plan.is_identity_layout:
        return physical
    return _permute(physical, plan.physical_of_logical())


def _map_tables(tree: dict, fn) -> dict:
    """``fn(leaf, plan_name)`` over a ``{group: {field: leaf}}`` tree."""
    return {g: {f: fn(w, f) for f, w in tables.items()}
            for g, tables in tree.items()}


def make_prepare_export(plans: Dict[str, RowShardPlan], mesh):
    """The layout pair of the sharded placements. ``prepare`` takes the
    logical params, pads every table to ``rows_per_shard * n_shards`` rows
    and keeps this rank's block in physical order (the dense tower as it
    is, replicated: every rank starts from the same params); ``export``
    all-gathers the blocks over ``"model"``, inverts the layout and strips
    the pad rows, so a checkpoint or an eval sees ``[vocab, D]`` tables on
    every rank. Both leave ``params["dense"]`` as it is."""
    shard = mesh.model_rank

    def prepare(params):
        return dict(params, embed=_map_tables(
            params["embed"], lambda w, f: _keep_block(
                pad_rows(w, plans[f].padded_vocab), plans[f], shard)))

    def export(params):
        return dict(params, embed=_map_tables(
            params["embed"], lambda w, f: unpad_rows(
                _gather_logical(w, plans[f], mesh), plans[f].vocab)))

    return prepare, export


def make_state_export_import(plans: Dict[str, RowShardPlan], mesh,
                             row_keys: Sequence[str]):
    """The snapshot layout pair of a sharded state, whose ``row_keys``
    entries (``m``, ``v`` and, lazily decayed, ``last_step``) are trees
    of this rank's blocks shaped like ``params["embed"]``.

    ``export_state`` gives the reference's raw state layout: each of those
    leaves all-gathered over ``"model"`` and put back in logical row
    order, padded to ``rows_per_shard * n_shards`` rows (the reference's
    ``pad_embed_tree`` order; a collective: every rank calls it, and
    every rank gets the whole state); the step counter and the dense
    tower's state as they are. ``import_state(state, flat)`` is its
    inverse for a resume: the path-keyed arrays of a snapshot overlaid on
    a template of those padded logical shapes (``checkpoint._fill_like``:
    a missing leaf raises ``KeyError``, another shape ``ValueError``, as
    the reference's overlay does, so a snapshot of a grid whose padded
    sizes differ is refused), then this rank's block of each row leaf kept
    on its device. The overlay runs on the host, so the card never holds
    more than the rank's blocks; no collective."""
    from ..train import checkpoint

    shard = mesh.model_rank

    def export_state(state):
        return dict(state, **{k: _map_tables(
            state[k], lambda w, f: _gather_logical(w, plans[f], mesh))
            for k in row_keys})

    def import_state(state, flat):
        def logical_like(w, f):
            return torch.empty((plans[f].padded_vocab,) + tuple(w.shape[1:]),
                               dtype=w.dtype, device="meta")

        template = dict(state, **{k: _map_tables(state[k], logical_like)
                                  for k in row_keys})
        host = checkpoint._fill_like(template, flat, "snapshot state",
                                     device="cpu")
        local = {k: (_map_tables(v, lambda w, f: _keep_block(
            w, plans[f], shard)) if k in row_keys else v)
            for k, v in host.items()}
        return tree_map(lambda new, old: new.to(old.device), local, state)

    return export_state, import_state
