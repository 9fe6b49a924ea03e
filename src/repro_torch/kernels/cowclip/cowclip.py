"""Build the CUDA CowClip kernels; launch the fused CowClip + coupled-L2 +
Adam kernel.

The fused kernel (``csrc/cowclip_adam.cu``) replaces the TPU kernel
``repro/kernels/cowclip/cowclip.py:cowclip_adam_update``; the sparse pair
(``csrc/sparse_catchup.cu``, ``csrc/sparse_update.cu``, launched from
``sparse.py``) replace ``repro/kernels/cowclip/sparse.py``'s two kernels.
Each source says what bounds it and how. All three are compiled, with
the port's other kernels, into the one extension of
``kernels/extension.py``, at first use.

The host computes every scalar the way the JAX kernel rounds it: Python
floats rounded to f32, ``1 - b1`` and ``1 - b2`` in double and then
rounded, the bias corrections ``1/(1 - b^t)`` in f32, and the absent-row
factor through ``decay_factor``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.optim import decay_factor, f32
from ..extension import build


def bias_corrections(step: int, b1: float, b2: float) -> tuple:
    """``(1/(1 - b1^t), 1/(1 - b2^t))`` in f32, as Python floats."""
    t = f32(step)
    return (float(1.0 / (1.0 - b1 ** t)), float(1.0 / (1.0 - b2 ** t)))


def _f32(x: float) -> float:
    return float(np.float32(x))


def cowclip_adam_update(
    w: torch.Tensor,          # [V, D] table, updated in place
    g: torch.Tensor,          # [V, D] task-loss gradient
    cnt: torch.Tensor,        # [V]    per-id batch occurrence counts
    m: torch.Tensor,          # [V, D] Adam first moment, updated in place
    v: torch.Tensor,          # [V, D] Adam second moment, updated in place
    step: int,                # 1-based
    *,
    r: float = 1.0,
    zeta: float = 1e-5,
    lr: float = 1e-4,
    l2: float = 1e-5,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> None:
    """Launch the kernel on PyTorch's current stream. Inputs are checked by
    the caller (``ops.fused_cowclip_adam``) and again by the binding."""
    bc1, bc2 = bias_corrections(step, b1, b2)
    build().cowclip_adam_(
        w, g, cnt, m, v, _f32(r), _f32(zeta), _f32(lr), _f32(l2), _f32(b1),
        _f32(b2), _f32(1.0 - b1), _f32(1.0 - b2), _f32(eps), bc1, bc2,
        decay_factor(lr, l2))
