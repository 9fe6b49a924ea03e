"""Public wrapper for the chunked RWKV-6 WKV scan.

``wkv6`` takes r/k/v/w ``[BH, S, N]`` and u ``[BH, N]``, all f32. A CUDA
tensor goes through the hand-written kernel (``wkv6.py``) or the call
raises; a CPU tensor takes the plain chunked version (``ref.py``), so both
devices compute the same factorisation. ``wkv6.launches`` counts the
calls that launch the kernels (only those), each 1 kernel, or 3 (segment
pass, carry, scan) when BH is short of the SMs, so a run can show that
its main path went through them.
"""

from __future__ import annotations

import torch

from . import wkv6 as cuda_wkv6
from .ref import chunked_wkv6_reference, wkv6_reference as reference


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, r on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, got "
                         f"{list(t.shape)}")


def wkv6(r, k, v, w, u, *, chunk: int = 16):
    """The chunked WKV6 scan: ``(y [BH, S, N], final_state [BH, N, N])``,
    both f32. Raises ``ValueError`` when S is not a multiple of ``chunk``,
    N > 64 or ``chunk`` is outside [1, 16] (the kernel's limits, held on
    both devices). No gradient flows through the kernel: on the card an
    input that requires one is refused."""
    if not isinstance(r, torch.Tensor) or r.dim() != 3:
        raise ValueError("r must be a [BH, S, N] torch.Tensor")
    bh, seq, n = r.shape
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check(name, t, (bh, seq, n), r.device)
    _check("u", u, (bh, n), r.device)
    if n > cuda_wkv6.MAX_N:
        raise ValueError(f"head size {n} > {cuda_wkv6.MAX_N}")
    if not 1 <= chunk <= cuda_wkv6.MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside [1, {cuda_wkv6.MAX_CHUNK}]")
    if seq % chunk:
        raise ValueError(f"seq len {seq} must be a multiple of chunk {chunk}")
    if r.device.type == "cpu":
        return chunked_wkv6_reference(r, k, v, w, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 kernel for device {r.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        raise ValueError("the wkv6 kernel has no backward (ROADMAP queue 1 "
                         "item 8): call it under torch.no_grad()")
    out = cuda_wkv6.chunked_wkv6(r, k, v, w, u, chunk=chunk)
    wkv6.launches += 1
    return out


wkv6.launches = 0
