"""Public wrappers for the CowClip + coupled-L2 + Adam updates.

``fused_cowclip_adam`` updates a whole ``[V, D]`` table's ``(w, m, v)`` in
place; ``sparse_gather_catchup`` gathers a batch's unique-id slot rows with
their pending decay applied, and ``sparse_update_scatter`` updates those
rows into the tables in place. ``sparse_gather_catchup_tables`` and
``sparse_update_scatter_tables`` do the same for a list of tables in one
launch (the sparse train step's form); the single-table wrappers launch
it for a list of one (a row shard's form, with its ``row_offset``). A CUDA
tensor goes through the hand-written kernel (``cowclip.py``,
``sparse.py``) or the call raises; a CPU tensor takes the plain PyTorch
version (``ref.py``) and copies its result back, so both devices share
one in-place contract. Each wrapper's ``.launches`` counts its kernel's
launches (only those), so a run can show that its main path went through
the kernel.
"""

from __future__ import annotations

import torch

from . import ref, sparse
from .cowclip import cowclip_adam_update
from .ref import cowclip_adam_reference as reference


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, w on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, got "
                         f"{list(t.shape)}")


def _check_table(w):
    if not isinstance(w, torch.Tensor) or w.dim() != 2:
        raise ValueError("w must be a [V, D] torch.Tensor")
    return w.shape


def _check_step(step):
    if int(step) < 1:
        raise ValueError(f"step is 1-based, got {step}")


def _validate(w, g, cnt, m, v, step):
    vocab, dim = _check_table(w)
    for name, t in (("w", w), ("g", g), ("m", m), ("v", v)):
        _check(name, t, torch.float32, (vocab, dim), w.device)
    _check("cnt", cnt, torch.float32, (vocab,), w.device)
    _check_step(step)


def fused_cowclip_adam(
    w, g, cnt, m, v, step, *,
    r=1.0, zeta=1e-5, lr=1e-4, l2=1e-5, b1=0.9, b2=0.999, eps=1e-8,
):
    """One CowClip + coupled-L2 + Adam step of a ``[V, D]`` table, in place.

    ``cnt`` is the ``[V]`` f32 per-id batch count, ``step`` the 1-based
    Python-int step. Returns ``(w, m, v)``.
    """
    _validate(w, g, cnt, m, v, step)
    kw = dict(r=r, zeta=zeta, lr=lr, l2=l2, b1=b1, b2=b2, eps=eps)
    with torch.no_grad():
        if w.device.type == "cpu":
            nw, nm, nv = reference(w, g, cnt, m, v, step, **kw)
            w.copy_(nw)
            m.copy_(nm)
            v.copy_(nv)
            return w, m, v
        if w.device.type != "cuda":
            raise ValueError(f"no fused CowClip kernel for device {w.device}")
        cowclip_adam_update(w, g, cnt, m, v, int(step), **kw)
        fused_cowclip_adam.launches += 1
    return w, m, v


fused_cowclip_adam.launches = 0


def _validate_sparse(w, m, v, last_step, uids, counts, step, rows=()):
    vocab, dim = _check_table(w)
    for name, t in (("w", w), ("m", m), ("v", v)):
        _check(name, t, torch.float32, (vocab, dim), w.device)
    _check("last_step", last_step, torch.int32, (vocab,), w.device)
    if not isinstance(uids, torch.Tensor) or uids.dim() != 1:
        raise ValueError("uids must be a [cap] torch.Tensor")
    cap = uids.shape[0]
    _check("uids", uids, torch.int32, (cap,), w.device)
    _check("counts", counts, torch.float32, (cap,), w.device)
    for name, t in rows:
        _check(name, t, torch.float32, (cap, dim), w.device)
    _check_step(step)


def _kernel_device(w, lr, l2):
    if w.device.type != "cuda":
        raise ValueError(f"no sparse CowClip kernel for device {w.device}")
    if callable(lr) or callable(l2):
        raise ValueError(
            "the sparse CUDA kernels take a constant lr and l2 (the closed "
            "form); a scheduled lr/l2 has only the plain version's replay "
            "window, on the CPU")


def sparse_gather_catchup(
    w, m, v, last_step, uids, counts, step, *,
    lr=1e-4, l2=1e-5, b1=0.9, b2=0.999, eps=1e-8, row_offset=0,
):
    """The ``[cap, D]`` slot rows of ``uids - row_offset``, with each row's
    pending decay applied through ``step - 1`` in closed form, ``w *
    (1 - lr*l2)**k``; m and v rows unchanged. ``uids`` are the raw slot uids
    (pads hold ``vocab``, count 0); a pad slot's rows are a don't-care
    (finite). Returns new f32 ``(w_rows, m_rows, v_rows)``.
    """
    _validate_sparse(w, m, v, last_step, uids, counts, step)
    with torch.no_grad():
        if w.device.type == "cpu":
            return ref.sparse_gather_catchup_reference(
                w, m, v, last_step, uids, int(step), lr=lr, l2=l2, b1=b1,
                b2=b2, eps=eps, row_offset=row_offset)
        _kernel_device(w, lr, l2)
        rows, _ = sparse.sparse_gather_catchup_tables(
            [w], [m], [v], [last_step], [uids], [counts], int(step), lr=lr,
            l2=l2, row_offsets=[row_offset], with_depth=False)
        sparse_gather_catchup.launches += 1
    return rows[0]


def sparse_update_scatter(
    w, m, v, last_step, uids, counts, w_rows, g_rows, m_rows, v_rows, step,
    *, r=1.0, zeta=1e-5, lr=1e-4, l2=1e-5, b1=0.9, b2=0.999, eps=1e-8,
    clip=True, row_offset=0,
):
    """CowClip (when ``clip`` and D >= 2) + coupled L2 + Adam on the
    caught-up slot rows, written in place into ``w, m, v`` at ``uids -
    row_offset`` with ``last_step = step``; pad slots and rows of absent ids
    are not touched (their decay stays pending). Returns ``(w, m, v,
    last_step)``.
    """
    _validate_sparse(w, m, v, last_step, uids, counts, step, rows=(
        ("w_rows", w_rows), ("g_rows", g_rows), ("m_rows", m_rows),
        ("v_rows", v_rows)))
    kw = dict(r=r, zeta=zeta, lr=lr, l2=l2, b1=b1, b2=b2, eps=eps,
              clip=clip, row_offset=row_offset)
    with torch.no_grad():
        if w.device.type == "cpu":
            new = ref.sparse_update_scatter_reference(
                w, m, v, last_step, uids, counts, w_rows, g_rows, m_rows,
                v_rows, int(step), **kw)
            for table, value in zip((w, m, v, last_step), new):
                table.copy_(value)
            return w, m, v, last_step
        _kernel_device(w, lr, l2)
        row_offset = kw.pop("row_offset")
        sparse.sparse_update_scatter_tables(
            [w], [m], [v], [last_step], [uids], [counts], [w_rows], [g_rows],
            [m_rows], [v_rows], int(step), row_offsets=[row_offset], **kw)
        sparse_update_scatter.launches += 1
    return w, m, v, last_step


def _validate_tables(lists, step, rows=()):
    """Check a grouped call's parallel lists: one length, every table as
    the single-table wrapper checks it, all on the first table's device.
    Returns the device and the number of tables."""
    n = len(lists[0])
    if n == 0 or any(len(x) != n for x in lists + tuple(r for _, r in rows)):
        raise ValueError("the table lists must be non-empty and of one "
                         "length")
    for i in range(n):
        _validate_sparse(*(x[i] for x in lists), step,
                         rows=[(name, r[i]) for name, r in rows])
        if lists[0][i].device != lists[0][0].device:
            raise ValueError(f"table {i} is on {lists[0][i].device}, table 0 "
                             f"on {lists[0][0].device}")
    return lists[0][0].device, n


def _offsets(row_offsets, n):
    offsets = [0] * n if row_offsets is None else list(row_offsets)
    if len(offsets) != n:
        raise ValueError(f"{len(offsets)} row offsets for {n} tables")
    return offsets


def sparse_gather_catchup_tables(
    ws, ms, vs, last_steps, uids, counts, step, *,
    lr=1e-4, l2=1e-5, b1=0.9, b2=0.999, eps=1e-8, row_offsets=None,
):
    """``sparse_gather_catchup`` over a list of tables at once (index i of
    every list is table i; ``row_offsets`` defaults to 0 each): on the card
    one kernel launch (one per ``sparse.MAX_TABLES`` tables), counted by
    ``.launches``. Returns ``(rows, depth)``: the f32 ``(w_rows, m_rows,
    v_rows)`` of each table, and ``depth``, a 0-dim int32 tensor, the
    largest number of pending decay-only steps ``max(step - 1 -
    last_step[row], 0)`` over the real slots of all tables (0 with none):
    the sparse step's ``catchup_depth_max``.
    """
    lists = (ws, ms, vs, last_steps, uids, counts)
    device, n = _validate_tables(lists, step)
    offsets = _offsets(row_offsets, n)
    if device.type == "cpu":   # the plain versions, table by table
        rows = [sparse_gather_catchup(
                    *(x[i] for x in lists), step, lr=lr, l2=l2, b1=b1, b2=b2,
                    eps=eps, row_offset=offsets[i]) for i in range(n)]
        return rows, ref.catchup_depth_reference(
            last_steps, uids, counts, int(step), row_offsets=offsets)
    with torch.no_grad():
        _kernel_device(ws[0], lr, l2)
        out = sparse.sparse_gather_catchup_tables(
            *lists, int(step), lr=lr, l2=l2, row_offsets=offsets)
        sparse_gather_catchup_tables.launches += sparse.launches_for(n)
    return out


def sparse_update_scatter_tables(
    ws, ms, vs, last_steps, uids, counts, w_rows, g_rows, m_rows, v_rows,
    step, *, r=1.0, zeta=1e-5, lr=1e-4, l2=1e-5, b1=0.9, b2=0.999, eps=1e-8,
    clip=True, row_offsets=None,
):
    """``sparse_update_scatter`` over a list of tables at once, in place:
    on the card one kernel launch (one per ``sparse.MAX_TABLES`` tables),
    counted by ``.launches``. The uids of each table must be distinct (a
    dedup's slot set)."""
    lists = (ws, ms, vs, last_steps, uids, counts)
    device, n = _validate_tables(lists, step, rows=(
        ("w_rows", w_rows), ("g_rows", g_rows), ("m_rows", m_rows),
        ("v_rows", v_rows)))
    offsets = _offsets(row_offsets, n)
    kw = dict(r=r, zeta=zeta, lr=lr, l2=l2, b1=b1, b2=b2, eps=eps,
              clip=clip)
    if device.type == "cpu":   # the plain versions, table by table
        for i in range(n):
            sparse_update_scatter(
                *(x[i] for x in lists), w_rows[i], g_rows[i], m_rows[i],
                v_rows[i], step, row_offset=offsets[i], **kw)
        return
    with torch.no_grad():
        _kernel_device(ws[0], lr, l2)
        sparse.sparse_update_scatter_tables(
            *lists, w_rows, g_rows, m_rows, v_rows, int(step),
            row_offsets=offsets, **kw)
        sparse_update_scatter_tables.launches += sparse.launches_for(n)


sparse_gather_catchup.launches = 0
sparse_update_scatter.launches = 0
sparse_gather_catchup_tables.launches = 0
sparse_update_scatter_tables.launches = 0
