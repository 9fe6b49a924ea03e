"""Learning-rate schedules: functions of the step counter (a 0-dim int32
tensor) that return 0-dim float32 tensors on the counter's device,
computed in f32 as ``repro.core.schedules`` computes them, with no host
read."""

from __future__ import annotations

import torch


def constant(value: float):
    def schedule(count):
        return torch.full((), value, dtype=torch.float32,
                          device=count.device)

    return schedule


def linear_warmup(base: float, warmup_steps: int):
    """Linear 0 -> base over ``warmup_steps``, then constant (the paper's
    one-epoch warmup on the dense tower only)."""
    if warmup_steps <= 0:
        return constant(base)

    def schedule(count):
        frac = torch.clamp_max((count.to(torch.float32) + 1.0)
                               / warmup_steps, 1.0)
        return base * frac

    return schedule
