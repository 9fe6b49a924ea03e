"""Transformer building blocks, as in ``repro.models.layers``. Only
RMSNorm is ported (the RWKV-6 path needs nothing else); attention, MLP
and rope come with the other LM archs (ROADMAP queue 1 item 8).

Params are plain dicts of tensors; activations run in the compute dtype,
params stay f32, norms accumulate in f32.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device


def init_rmsnorm(d: int, *, lead: tuple = (), device="cuda") -> dict:
    """``lead`` prepends stacking dims (``[n_repeats]`` in ``lm.init``)."""
    return {"scale": torch.ones(lead + (d,), dtype=torch.float32,
                                device=resolve_device(device))}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True)
                         + eps)
    return (y * params["scale"]).to(dt)
