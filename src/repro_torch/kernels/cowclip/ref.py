"""Plain PyTorch versions of the CowClip + coupled-L2 + Adam updates.

A port of ``repro.kernels.cowclip.ref``. ``cowclip_adam_reference``
composes ``core.cowclip.cowclip_table`` with coupled L2 and bias-corrected
Adam, in the reference's op order; rows absent from the batch (``cnt ==
0``) take one geometric L2 decay step, ``w *= 1 - lr*l2``, with the moments
held. The sparse versions compose ``core.optim.decay_catchup_rows`` and
``sparse_adam_rows`` on gathered unique rows. They are the CPU paths of
``ops`` and the oracles the CUDA kernels are held to on the card.

Index conventions, the reference's: a gather clamps an out-of-range row
index into the table, a scatter drops it.

``step`` is the ``StepScalars`` block the kernels read (its step, and its
guard's flag: a guarded update whose flag is 0 changes nothing), so a
plain version takes what its kernel takes.
"""

from __future__ import annotations

import torch

from ...core.cowclip import cowclip_rows, cowclip_table
from ...core.optim import decay_catchup_rows, decay_factor, sparse_adam_rows


def cowclip_adam_reference(
    w, g, cnt, m, v, step, *,
    r=1.0, zeta=1e-5, lr=1e-4, l2=1e-5, b1=0.9, b2=0.999, eps=1e-8,
):
    """Returns new ``(w, m, v)``; the inputs are not modified."""
    step, ok = step.step, step.ok
    w32 = w.to(torch.float32)
    m_in = m.to(torch.float32)
    v_in = v.to(torch.float32)
    g32 = g.to(torch.float32)
    g32 = cowclip_table(g32, w32, cnt, r=r, zeta=zeta)
    g32 = g32 + l2 * w32

    m32 = b1 * m_in + (1.0 - b1) * g32
    v32 = b2 * v_in + (1.0 - b2) * torch.square(g32)
    t = step.to(torch.float32)
    m_hat = m32 / (1.0 - b1 ** t)
    v_hat = v32 / (1.0 - b2 ** t)
    touched = (cnt > 0.0)[:, None]
    w32 = torch.where(touched,
                      w32 - lr * m_hat / (torch.sqrt(v_hat) + eps),
                      w32 * decay_factor(lr, l2))
    m32 = torch.where(touched, m32, m_in)
    v32 = torch.where(touched, v32, v_in)
    if ok is not None:
        w32, m32, v32 = (torch.where(ok, a, b.to(torch.float32))
                         for a, b in ((w32, w), (m32, m), (v32, v)))
    return w32.to(w.dtype), m32.to(m.dtype), v32.to(v.dtype)


# ---------------------------------------------------------------------------
# sparse unique-id path
# ---------------------------------------------------------------------------


def sparse_gather_catchup_reference(
    w, m, v, last_step, uids, step, *,
    lr=1e-4, l2=1e-5, b1=0.9, b2=0.999, eps=1e-8, row_offset=0,
):
    """Gather the slots' rows at ``uids - row_offset`` (clamped into the
    table, so a pad slot reads a row nothing uses) and apply their pending
    decay through ``step - 1``: the rows as the dense path sees them at the
    start of step ``step``. Returns f32 ``(w_rows, m_rows, v_rows)``."""
    step = step.step
    loc = torch.clamp(uids.to(torch.int64) - row_offset, 0, w.shape[0] - 1)
    return decay_catchup_rows(
        w[loc], m[loc], v[loc], last_step[loc], step - 1,
        lr=lr, l2=l2, b1=b1, b2=b2, eps=eps)


def catchup_depth_reference(last_steps, uids, counts, step, *,
                            row_offsets=None):
    """The deepest pending catch-up among the real slots of a list of
    tables: ``max(step - 1 - last_step[row], 0)`` over every slot with a
    count, its row ``uid - row_offset`` clamped into the table as the
    gather clamps it; 0 with no real slot. A 0-dim int32 tensor. (The
    reference step's ``catchup_depth_max``, whose rows are never ahead of
    ``step - 1``.)"""
    step = step.step
    offsets = [0] * len(uids) if row_offsets is None else row_offsets
    depth = torch.zeros((), dtype=torch.int32, device=counts[0].device)
    for ls, u, c, off in zip(last_steps, uids, counts, offsets):
        if u.numel() == 0:
            continue
        loc = torch.clamp(u.to(torch.int64) - off, 0, ls.shape[0] - 1)
        k = torch.clamp_min((step - 1) - ls[loc], 0)
        depth = torch.maximum(depth, torch.where(c > 0, k, 0).max()
                              .to(torch.int32))
    return depth


def sparse_update_scatter_reference(
    w, m, v, last_step, uids, counts, w_rows, g_rows, m_rows, v_rows, step,
    *, r=1.0, zeta=1e-5, lr=1e-4, l2=1e-5, b1=0.9, b2=0.999, eps=1e-8,
    clip=True, row_offset=0,
):
    """CowClip + coupled L2 + Adam on caught-up rows, written back into
    copies of the tables at ``uids - row_offset`` with ``last_step = step``.
    Pad slots (``counts == 0``) and out-of-range rows are dropped. Returns
    new ``(w, m, v, last_step)``; the inputs are not modified."""
    step, ok = step.step, step.ok
    loc = uids.to(torch.int64) - row_offset
    keep = (counts > 0) & (loc >= 0) & (loc < w.shape[0])
    if ok is not None:
        keep = keep & ok
    g32 = g_rows.to(torch.float32)
    if clip:
        g32 = cowclip_rows(g32, w_rows, counts, r=r, zeta=zeta)
    new = sparse_adam_rows(g32, w_rows, m_rows, v_rows, step,
                           lr=lr, l2=l2, b1=b1, b2=b2, eps=eps)
    rows = loc[keep]
    out = []
    for table, row_vals in zip((w, m, v), new):
        table = table.clone()
        table[rows] = row_vals[keep].to(table.dtype)
        out.append(table)
    last_step = last_step.clone()
    last_step[rows] = step.to(last_step.dtype)
    return (*out, last_step)


def sparse_cowclip_adam_reference(
    w, m, v, last_step, uids, counts, g_rows, step, *,
    r=1.0, zeta=1e-5, lr=1e-4, l2=1e-5, b1=0.9, b2=0.999, eps=1e-8,
    row_offset=0,
):
    """The whole sparse step (gather, catch-up, clip, Adam, scatter) given
    the task-loss gradient on gathered rows; per step it equals
    ``cowclip_adam_reference`` over the whole table once pending decay is
    applied."""
    kw = dict(lr=lr, l2=l2, b1=b1, b2=b2, eps=eps, row_offset=row_offset)
    w_rows, m_rows, v_rows = sparse_gather_catchup_reference(
        w, m, v, last_step, uids, step, **kw)
    return sparse_update_scatter_reference(
        w, m, v, last_step, uids, counts, w_rows, g_rows, m_rows, v_rows,
        step, r=r, zeta=zeta, clip=True, **kw)
