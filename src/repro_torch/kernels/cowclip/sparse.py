"""Launch the CUDA sparse unique-id CowClip kernels.

They replace the TPU kernels of ``repro/kernels/cowclip/sparse.py``: the
update of the sparse placement runs on the ``[capacity, dim]`` rows of a
batch's unique ids, gather -> lazy-decay catch-up -> (forward/backward) ->
CowClip -> coupled L2 -> Adam -> scatter, so its device-memory traffic is
O(batch) instead of O(vocab). It is split in two kernels because the
task-loss gradient is computed between the catch-up and the clip:

* ``sparse_gather_catchup`` (``csrc/sparse_catchup.cu``): each slot's
  ``(w, m, v)`` row, with ``w`` scaled by ``factor**k`` for its ``k``
  pending decay-only steps.
* ``sparse_update_scatter`` (``csrc/sparse_update.cu``): CowClip, coupled
  L2 and Adam on each real slot's rows, written in place into the tables,
  ``last_step`` stamped with the step.

Both take ``row_offset``, subtracted from every uid: the form a row-shard
of a partitioned table uses. The TPU kernels also needed ``safe_uids`` to
keep pad slots' block indices in range; the CUDA kernels read each slot's
count and skip pads themselves. Scalars are rounded on the host as for the
fused kernel (``cowclip.py``). The built extension is ``cowclip.build()``.
"""

from __future__ import annotations

import torch

from ...core.optim import decay_factor
from .cowclip import _f32, bias_corrections, build


def safe_uids(uids: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Pad slots (count 0) remapped to the last real slot's uid, so every
    slot indexes a real row. The TPU kernels' wrappers needed it; the CUDA
    kernels do not. The sharded_sparse placement (ROADMAP queue 1 item 7)
    gathers each slot's shard-local state through it, as
    ``repro/embed/sharded_sparse.py`` does."""
    n_real = torch.clamp_min(torch.sum((counts > 0).to(torch.int64)), 1)
    last_real = uids[n_real - 1]
    return torch.where(counts > 0, uids, last_real).to(torch.int32)


def sparse_gather_catchup(w, m, v, last_step, uids, counts, step, *,
                          lr: float, l2: float, row_offset: int = 0):
    """Launch the catch-up kernel: rows caught up through ``step - 1``.
    Returns new f32 ``(w_rows, m_rows, v_rows)``, ``[cap, dim]``; pad
    slots' rows are zero. Inputs are checked by the caller
    (``ops.sparse_gather_catchup``) and again by the binding."""
    shape = (uids.shape[0], w.shape[1])
    out = [torch.empty(shape, dtype=torch.float32, device=w.device)
           for _ in range(3)]
    build().sparse_gather_catchup(w, m, v, last_step, uids, counts, *out,
                                  int(row_offset), int(step) - 1,
                                  decay_factor(lr, l2))
    return tuple(out)


def sparse_update_scatter(w, m, v, last_step, uids, counts, w_rows, g_rows,
                          m_rows, v_rows, step, *, r: float = 1.0,
                          zeta: float = 1e-5, lr: float = 1e-4,
                          l2: float = 1e-5, b1: float = 0.9,
                          b2: float = 0.999, eps: float = 1e-8,
                          clip: bool = True, row_offset: int = 0) -> None:
    """Launch the update kernel: ``w, m, v, last_step`` updated in place.
    Inputs are checked by the caller (``ops.sparse_update_scatter``) and
    again by the binding."""
    bc1, bc2 = bias_corrections(step, b1, b2)
    build().sparse_update_scatter_(
        w, m, v, last_step, uids, counts, w_rows, g_rows, m_rows, v_rows,
        int(row_offset), int(step), _f32(r), _f32(zeta), _f32(lr), _f32(l2),
        _f32(b1), _f32(b2), _f32(1.0 - b1), _f32(1.0 - b2), _f32(eps), bc1,
        bc2, bool(clip))
