"""Learning-rate schedules: functions of the step counter (a 0-dim int32
tensor) that return 0-dim float32 tensors on the counter's device,
computed in f32 as ``repro.core.schedules`` computes them, with no host
read."""

from __future__ import annotations

import math

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


def cosine_decay(base: float, total_steps: int, warmup_steps: int = 0,
                 floor: float = 0.0):
    """Linear warmup over ``warmup_steps``, then cosine decay from ``base``
    to ``floor * base`` at ``total_steps``; in f32 from the counter on its
    device."""

    def schedule(count):
        c = count.to(torch.float32)
        warm = torch.clamp_max((c + 1.0) / max(1.0, warmup_steps), 1.0)
        t = torch.clamp((c - warmup_steps)
                        / max(1.0, total_steps - warmup_steps), 0.0, 1.0)
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * t))
        return base * warm * cos

    return schedule
