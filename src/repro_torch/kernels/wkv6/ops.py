"""Public wrapper for the chunked RWKV-6 WKV scan.

``wkv6`` takes r/k/v/w ``[BH, S, N]`` and u ``[BH, N]``, all f32. A CUDA
tensor goes through the hand-written kernel (``wkv6.py``) or the call
raises; a CPU tensor takes the plain chunked version (``ref.py``), so both
devices compute the same factorisation. ``wkv6.launches`` counts the
calls that launch the kernels (only those: forward launches), each 1
kernel, or 3 (segment pass, carry, scan) when BH is short of the SMs, so
a run can show that its main path went through them.

Gradients flow through ``wkv6`` as through the reference's jnp twin
(``repro/models/rwkv.py:_wkv_chunked``, which JAX differentiates; the JAX
package has no backward kernel). The forward is the kernel on detached
inputs (the plain version on the CPU); the backward recomputes the plain
chunked version (``ref.chunked_wkv6_reference``) from the saved inputs
under autograd and returns its gradients of r, k, v, w and u. So the
gradient is the plain chunked version's on both devices: the ``+-25``
clip passes zero gradient outside its range, as ``jnp.clip`` does.
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
    both devices). Differentiable in r, k, v, w and u: the backward is the
    plain chunked version's, recomputed (module docstring)."""
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
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no wkv6 kernel for device {r.device}")
    return _WKV6.apply(r, k, v, w, u, chunk)


class _WKV6(torch.autograd.Function):
    """Forward: the kernel on the card, the plain chunked version on the
    CPU; backward by the plain chunked version, recomputed under autograd from
    the saved inputs. A gradient of y or of the final state that autograd
    does not pass counts as zero."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        if r.device.type == "cpu":
            return chunked_wkv6_reference(r, k, v, w, u, chunk=chunk)
        out = cuda_wkv6.chunked_wkv6(r, k, v, w, u, chunk=chunk)
        wkv6.launches += 1
        return out

    @staticmethod
    def backward(ctx, gy, gs):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = chunked_wkv6_reference(*inputs, chunk=ctx.chunk)
        pairs = [(o, g) for o, g in zip(outs, (gy, gs)) if g is not None]
        if not pairs:
            return (None,) * 6
        grads = torch.autograd.grad([o for o, _ in pairs], inputs,
                                    [g for _, g in pairs], allow_unused=True)
        return (*grads, None)


wkv6.launches = 0
