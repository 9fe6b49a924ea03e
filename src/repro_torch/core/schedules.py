"""Learning-rate schedules: functions of the Python-int step counter that
return 0-dim float32 tensors, computed in f32 as ``repro.core.schedules``
computes them."""

from __future__ import annotations

import torch

from .optim import f32


def constant(value: float):
    def schedule(count):
        del count
        return f32(value)

    return schedule


def linear_warmup(base: float, warmup_steps: int):
    """Linear 0 -> base over ``warmup_steps``, then constant (the paper's
    one-epoch warmup on the dense tower only)."""
    if warmup_steps <= 0:
        return constant(base)

    def schedule(count):
        frac = torch.clamp_max((f32(count) + 1.0) / warmup_steps, 1.0)
        return base * frac

    return schedule
