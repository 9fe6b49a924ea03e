"""Public wrapper for the fused CowClip + coupled-L2 + Adam update.

``fused_cowclip_adam`` updates ``(w, m, v)`` in place and returns them. A
CUDA tensor goes through the hand-written kernel (``cowclip.py``) or the
call raises; a CPU tensor takes the plain PyTorch version (``ref.py``) and
copies its result back, so both devices share one in-place contract.
``fused_cowclip_adam.launches`` counts kernel launches (only those), so a
run can show that its main path went through the kernel.
"""

from __future__ import annotations

import torch

from .cowclip import cowclip_adam_update
from .ref import cowclip_adam_reference as reference


def _validate(w, g, cnt, m, v, step):
    tensors = {"w": w, "g": g, "cnt": cnt, "m": m, "v": v}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w.dim() != 2:
        raise ValueError(f"w must be [V, D], got shape {tuple(w.shape)}")
    for name in ("g", "m", "v"):
        if tensors[name].shape != w.shape:
            raise ValueError(f"{name} shape {tuple(tensors[name].shape)} != "
                             f"w shape {tuple(w.shape)}")
    if cnt.shape != (w.shape[0],):
        raise ValueError(f"cnt must be [{w.shape[0]}], got {tuple(cnt.shape)}")
    if int(step) < 1:
        raise ValueError(f"step is 1-based, got {step}")


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
