"""Activation sharding constraints that are no-ops off a mesh, as in
``repro.sharding.act``.

Model code calls ``constrain(x, "batch", None, "model")`` with *logical*
axis names. Inside ``with use_mesh(mesh):`` (the dry-run; the port's
counterpart of the reference's ``with mesh:``) a DTensor ``x`` is
redistributed to those axes of the mesh — "batch" resolves to ("pod",
"data") on a pod mesh, a dim that does not divide evenly stays
replicated. Without a mesh, for a plain tensor, or when the rank does not
match, the call returns ``x`` itself, so the same model code runs on one
card and on the CPU unchanged.

Regions that DTensor has no working sharding rule for run on each rank's
blocks instead: ``local_region`` (a function of a rank's batch rows and
heads, laid out by logical axes) and ``batch_partial`` (a sum over the
batch into a table-shaped partial result). Off a mesh both call the
function itself.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_STATE = threading.local()


def current_mesh():
    """The mesh of the innermost ``use_mesh``, or None."""
    stack = getattr(_STATE, "stack", None)
    return stack[-1] if stack else None


def axis_size(name: str) -> int:
    """The size of the current mesh's axis ``name`` (1 off a mesh, or
    when it has no such axis)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(name, 1)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh`` with named dims) the one
    ``constrain`` resolves against, for the body of the ``with``."""
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    _STATE.stack.append(mesh)
    try:
        yield mesh
    finally:
        _STATE.stack.pop()


def _resolve(axis, names):
    if axis is None:
        return None
    if axis == "batch":
        return ("pod", "data") if "pod" in names else ("data",)
    if axis in names:
        return (axis,)
    return None


def constrain(x, *logical_axes):
    """``x`` redistributed to the logical axes on the current mesh, and
    its gradient to the same layout in the backward; ``x`` itself without
    a mesh, for a tensor that is not a DTensor, or when
    ``len(logical_axes) != x.ndim``. A sharded dim that does not divide
    evenly is replicated."""
    mesh = current_mesh()
    if mesh is None or len(logical_axes) != x.ndim:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, placements(x.shape, logical_axes, mesh))


class _Constrain(torch.autograd.Function):
    """``redistribute`` to ``placements`` whose backward lays the gradient
    out the same way, as the reference's ``with_sharding_constraint``
    constrains the cotangent too (DTensor's own ``redistribute`` hands the
    gradient back in the input's layout, and its op-by-op choices in the
    backward then drift from the forward's)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        if list(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if list(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def placements(shape, logical_axes, mesh) -> list:
    """DTensor placements on ``mesh`` of a ``shape`` tensor laid out over
    ``logical_axes`` (``constrain``'s resolution: "batch" over the data
    axes, a dim that does not divide evenly replicated)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    out = [Replicate()] * len(names)
    for d, (dim, axis) in enumerate(zip(shape, logical_axes)):
        axes = _resolve(axis, names)
        if axes is None:
            continue
        size = 1
        for a in axes:
            size *= sizes[a]
        if dim % size:
            continue
        for a in axes:
            out[names.index(a)] = Shard(d)
    return out


def local_region(fn, in_axes, outs):
    """``fn`` as a function of DTensors on the current mesh that runs on
    each rank's blocks (``torch.distributed.tensor.experimental.
    local_map``): its tensor arguments are redistributed to ``in_axes``
    (one tuple of logical axes an argument; None for an argument that is
    not a DTensor; an argument not laid out over "batch", a weight, gets
    its gradient back as a partial sum over the mesh dims that split the
    batch) and its results read back as laid out by ``outs``: a
    ``(global shape, logical axes)`` pair, or a list of them for a tuple
    of results. For regions that are local under the reference's
    constraints (each rank's batch rows and heads) and that DTensor has
    no sharding rule for. Off a mesh, or on plain tensors, ``fn`` itself
    runs."""
    def run(*args):
        mesh = current_mesh()
        from torch.distributed.tensor import DTensor

        if mesh is None or not any(isinstance(a, DTensor) for a in args):
            return fn(*args)
        from torch.distributed.tensor import Partial, Replicate
        from torch.distributed.tensor.experimental import local_map

        # a plain tensor made in the model (a zero state) is the same on
        # every rank: replicated, then cut to its block
        args = tuple(
            DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor)
            and axes is not None else a
            for a, axes in zip(args, in_axes))
        in_pl = tuple(
            None if axes is None or not isinstance(a, DTensor)
            else placements(a.shape, axes, mesh)
            for a, axes in zip(args, in_axes))
        # the mesh dims that split the batch: an argument not laid out
        # over the batch (a weight) gets a partial sum over them back
        split = [any(pl is not None and "batch" in axes
                     and pl[m].is_shard()
                     for pl, axes in zip(in_pl, in_axes))
                 for m in range(mesh.ndim)]
        grad_pl = tuple(
            pl if pl is None or "batch" in axes else
            [Partial() if split[m] else p for m, p in enumerate(pl)]
            for pl, axes in zip(in_pl, in_axes))
        if isinstance(outs, list):
            out_pl = tuple(placements(shape, axes, mesh)
                           for shape, axes in outs)
        else:
            out_pl = placements(*outs, mesh)

        def local(*blocks):
            return fn(*[_ContiguousGrad.apply(t)
                        if isinstance(t, torch.Tensor) and t.requires_grad
                        else t for t in blocks])

        return local_map(local, out_placements=out_pl, in_placements=in_pl,
                         in_grad_placements=grad_pl, device_mesh=mesh,
                         redistribute_inputs=True)(*args)

    return run


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: a
    block's gradient leaves ``local_map`` in a layout that DTensor's views
    of it can take (a permute inside the region would leave it strided)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def batch_partial(fn, n_out: int, lead, *rest):
    """``fn(lead, *rest)`` on DTensors whose dim 0 is the batch: run on
    each rank's rows of the batch (``local_map``: every argument laid out
    as ``lead``'s dim 0 is, replicated otherwise), its ``n_out`` outputs
    read back as partial sums over the mesh dims that split the batch.
    For a sum over the batch into a table-shaped result (an embedding's
    gradient, the batch's id counts), which the optimizer's placement
    then reduce-scatters."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    lay = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
           for p in lead.placements]
    out = [Partial() if isinstance(p, Shard) else Replicate() for p in lay]
    return local_map(fn, out_placements=(out,) * n_out,
                     in_placements=(lay,) * (1 + len(rest)),
                     device_mesh=lead.device_mesh,
                     redistribute_inputs=True)(lead, *rest)
