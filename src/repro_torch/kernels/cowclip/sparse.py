"""Launch the CUDA sparse unique-id CowClip kernels.

They replace the TPU kernels of ``repro/kernels/cowclip/sparse.py``: the
update of the sparse placement runs on the ``[capacity, dim]`` rows of a
batch's unique ids, gather -> lazy-decay catch-up -> (forward/backward) ->
CowClip -> coupled L2 -> Adam -> scatter, so its device-memory traffic is
O(batch) instead of O(vocab). It is split in two kernels because the
task-loss gradient is computed between the catch-up and the clip:

* ``sparse_gather_catchup`` (``csrc/sparse_catchup.cu``): each slot's
  ``(w, m, v)`` row, with ``w`` scaled by ``factor**k`` for its ``k``
  pending decay-only steps, and the deepest ``k`` of a real slot.
* ``sparse_update_scatter`` (``csrc/sparse_update.cu``): CowClip, coupled
  L2 and Adam on each real slot's rows, written in place into the tables,
  ``last_step`` stamped with the step.

Each kernel takes a list of tables in one launch (up to ``MAX_TABLES``; a
longer list takes several), so a step's 52 deepfm-criteo tables cost one
launch of each; a single table is a list of one.

Both take ``row_offset``, subtracted from every uid: the form a row-shard
of a partitioned table uses. The TPU kernels also needed ``safe_uids`` to
keep pad slots' block indices in range; the CUDA kernels read each slot's
count and skip pads themselves. Constant scalars are rounded on the host
as for the fused kernel (``cowclip.py``); the step, its bias corrections
and the guard's flag come from the step's ``StepScalars`` block in device
memory. The built extension is ``kernels.extension.build()``.

Each call builds the kernels' table descriptors on the host and passes
them by value, so a captured CUDA graph replays its capture's: right
because a graph's tables, slot sets and row buffers are the same tensors
at every replay, while what changes (the step) is read on the card.
"""

from __future__ import annotations

import torch

from ...core.optim import decay_factor
from ..extension import build
from .cowclip import _f32


def safe_uids(uids: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Pad slots (count 0) remapped to the last real slot's uid, so every
    slot indexes a real row. The TPU kernels' wrappers needed it, and the
    reference's sharded_sparse placement gathers each slot's shard-local
    state through it; the CUDA kernels skip pad slots themselves, so the
    port's sharded_sparse placement passes its slot sets as they are."""
    n_real = torch.clamp_min(torch.sum((counts > 0).to(torch.int64)), 1)
    last_real = uids[n_real - 1]
    return torch.where(counts > 0, uids, last_real).to(torch.int32)


# kSparseMaxTables of csrc/sparse_cowclip.h: the tables one launch takes
MAX_TABLES = 64


def launches_for(n_tables: int) -> int:
    """Kernel launches of one grouped call over ``n_tables`` tables."""
    return -(-n_tables // MAX_TABLES)


def sparse_gather_catchup_tables(ws, ms, vs, last_steps, uids, counts, step,
                                 *, lr: float, l2: float, row_offsets,
                                 with_depth: bool = True):
    """Launch the catch-up kernel over the tables (index i of every list
    is table i), ``launches_for(len(ws))`` launches: each table's slot rows
    caught up through ``step - 1`` (``step`` a ``StepScalars`` on the
    tables' device). Returns ``(rows, depth)``: a new f32
    ``(w_rows, m_rows, v_rows)`` of ``[cap, dim]`` per table (pad slots'
    rows zero) and the deepest pending catch-up of a real slot, a 0-dim
    int32 tensor (None without ``with_depth``, which spares the single-table
    wrapper the depth's memset and atomics). The depth is zeroed by the
    first launch, on the stream (inside a captured graph: at every replay,
    into the graph's own buffer, which lives as long as the graph). Inputs
    are checked by the caller (``ops.sparse_gather_catchup_tables``) and
    again by the binding."""
    rows = [tuple(torch.empty((u.shape[0], w.shape[1]), dtype=torch.float32,
                              device=w.device) for _ in range(3))
            for w, u in zip(ws, uids)]
    depth = (torch.empty((), dtype=torch.int32, device=ws[0].device)
             if with_depth else None)
    ext, factor = build(), decay_factor(lr, l2)
    for lo in range(0, len(ws), MAX_TABLES):
        part = slice(lo, lo + MAX_TABLES)
        outs = [[r[i] for r in rows[part]] for i in range(3)]
        ext.sparse_gather_catchup(
            ws[part], ms[part], vs[part], last_steps[part], uids[part],
            counts[part], *outs, [int(o) for o in row_offsets[part]],
            step.words, factor, depth, lo == 0)
    return rows, depth


def sparse_update_scatter_tables(ws, ms, vs, last_steps, uids, counts,
                                 w_rows, g_rows, m_rows, v_rows, step, *,
                                 r: float, zeta: float, lr: float, l2: float,
                                 b1: float, b2: float, eps: float,
                                 clip: bool, row_offsets) -> None:
    """Launch the update kernel over the tables, ``launches_for(len(ws))``
    launches: every table's ``w, m, v, last_step`` updated in place, at the
    step of ``step`` (a ``StepScalars``; nothing written where its guard's
    flag is 0). Inputs are checked by the caller
    (``ops.sparse_update_scatter_tables``) and again by the binding."""
    scalars = (_f32(r), _f32(zeta), _f32(lr), _f32(l2), _f32(b1), _f32(b2),
               _f32(1.0 - b1), _f32(1.0 - b2), _f32(eps), bool(clip))
    ext = build()
    for lo in range(0, len(ws), MAX_TABLES):
        part = slice(lo, lo + MAX_TABLES)
        ext.sparse_update_scatter_(
            ws[part], ms[part], vs[part], last_steps[part], uids[part],
            counts[part], w_rows[part], g_rows[part], m_rows[part],
            v_rows[part], [int(o) for o in row_offsets[part]], step.words,
            step.guarded, *scalars)
