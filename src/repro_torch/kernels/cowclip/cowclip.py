"""Build the CUDA CowClip kernels; launch the fused CowClip + coupled-L2 +
Adam kernel.

The fused kernel (``csrc/cowclip_adam.cu``) replaces the TPU kernel
``repro/kernels/cowclip/cowclip.py:cowclip_adam_update``; the sparse pair
(``csrc/sparse_catchup.cu``, ``csrc/sparse_update.cu``, launched from
``sparse.py``) replace ``repro/kernels/cowclip/sparse.py``'s two kernels.
Each source says what bounds it and how. All three are compiled, with
the port's other kernels, into the one extension of
``kernels/extension.py``, at first use.

The host rounds the constant scalars the way the JAX kernel rounds them:
Python floats rounded to f32, ``1 - b1`` and ``1 - b2`` in double and then
rounded, and the absent-row factor through ``decay_factor``. What changes
from step to step (the step, its bias corrections ``1/(1 - b^t)`` in f32,
and the non-finite guard's flag) the kernels read from a small block in
device memory, a ``StepScalars``, which the train step fills on the card
from its step counter: a captured CUDA graph then takes each replay's
step, where a value passed by value would be frozen at the capture's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...core import optim
from ...core.optim import decay_factor, f32
from ..extension import build


def bias_corrections(step: int, b1: float, b2: float) -> tuple:
    """``(1/(1 - b1^t), 1/(1 - b2^t))`` in f32, as Python floats (the host's
    rounding, which ``core.optim.bias_corrections`` gives on every
    device)."""
    t = f32(step)
    return (float(1.0 / (1.0 - b1 ** t)), float(1.0 / (1.0 - b2 ** t)))


class StepScalars(NamedTuple):
    """A step's scalars as the CowClip kernels read them from device
    memory: ``words``, 4 int32 on the tables' device (the ``CowclipStep``
    of ``csrc/cowclip_adam.h``): the 1-based step, the f32 bits of its two
    bias corrections, and the guard's flag; ``guarded`` False when the step
    has no guard (the kernels then get a null flag and read none). The
    plain versions read the same words."""

    words: torch.Tensor
    guarded: bool = False

    @property
    def step(self) -> torch.Tensor:
        """The 1-based step, a 0-dim int32 tensor."""
        return self.words[0]

    @property
    def ok(self):
        """The guard's flag as a 0-dim bool tensor (None unguarded)."""
        return self.words[3] != 0 if self.guarded else None


def step_scalars(step, *, b1: float = 0.9, b2: float = 0.999, ok=None,
                 device=None) -> StepScalars:
    """The ``StepScalars`` of ``step``: a 0-dim int tensor (a train step's
    counter; the words are computed on its device with no host read, so a
    CUDA graph may capture this) or an int >= 1 (made on ``device``,
    default the CPU: a copy to the card, outside any capture). ``ok``: the
    guard's 0-dim bool flag, or None for no guard. ``b1``, ``b2`` must be
    the kernel call's."""
    if not isinstance(step, torch.Tensor):
        if int(step) < 1:
            raise ValueError(f"step is 1-based, got {step}")
        step = torch.tensor(int(step), dtype=torch.int32, device=device)
    step = step.to(torch.int32)
    bc1, bc2 = optim.bias_corrections(step, b1, b2)
    flag = (torch.ones_like(step) if ok is None else ok.to(torch.int32))
    words = torch.stack([step, bc1.view(torch.int32), bc2.view(torch.int32),
                         flag])
    return StepScalars(words, ok is not None)


def _f32(x: float) -> float:
    return float(np.float32(x))


def cowclip_adam_update(
    w: torch.Tensor,          # [V, D] table, updated in place
    g: torch.Tensor,          # [V, D] task-loss gradient
    cnt: torch.Tensor,        # [V]    per-id batch occurrence counts
    m: torch.Tensor,          # [V, D] Adam first moment, updated in place
    v: torch.Tensor,          # [V, D] Adam second moment, updated in place
    step: StepScalars,        # the step's block, on w's device
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
    build().cowclip_adam_(
        w, g, cnt, m, v, step.words, step.guarded, _f32(r), _f32(zeta),
        _f32(lr), _f32(l2), _f32(b1), _f32(b2), _f32(1.0 - b1),
        _f32(1.0 - b2), _f32(eps), decay_factor(lr, l2))
