"""Public wrapper for the chunked RWKV-6 WKV scan.

``wkv6`` takes r/k/v/w ``[BH, S, N]`` and u ``[BH, N]``, all f32. A CUDA
tensor goes through the hand-written kernels (``wkv6.py``) or the call
raises; a CPU tensor takes the plain chunked version (``ref.py``), so both
devices compute the same factorisation. ``wkv6.launches`` counts the
calls that launch the forward kernels, each 1 kernel, or 3 (segment pass,
carry, scan) when BH is short of the SMs; ``wkv6.backward_launches`` the
launches of the backward kernel; so a run can show that its main path
went through them.

Gradients flow through ``wkv6`` as through the reference's jnp twin
(``repro/models/rwkv.py:_wkv_chunked``, which JAX differentiates; the JAX
package has no backward kernel). On the card the forward kernel also
keeps the state entering each chunk, and the backward kernel
(``csrc/wkv6_backward.cu``) runs the reverse chunk scan from it: its
gradients are held within 1e-4 of each one's largest magnitude to the
plain version's autograd (they sum in another order), and two runs give
the same bits. On the CPU the backward recomputes the plain chunked
version (``ref.chunked_wkv6_reference``) from the saved inputs under
autograd, so there the gradient is autograd's through it, bit for bit.
Both pass zero gradient through the ``+-25`` clip outside its range, as
``jnp.clip`` does. Without a gradient to flow (``torch.no_grad``, or no
input that needs one) the forward keeps nothing.
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
    both devices). Differentiable in r, k, v, w and u: on the card the
    backward kernel runs from the chunk states the forward kernel kept, on
    the CPU autograd through the plain chunked version, recomputed (module
    docstring)."""
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
    ins = (r, k, v, w, u)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return _WKV6.apply(*ins, chunk)
    return _forward(*ins, chunk)


def _forward(r, k, v, w, u, chunk, chunk_states=False):
    """The forward kernel on the card, the plain chunked version on the
    CPU."""
    if r.device.type == "cpu":
        return chunked_wkv6_reference(r, k, v, w, u, chunk=chunk)
    out = cuda_wkv6.chunked_wkv6(r, k, v, w, u, chunk=chunk,
                                 chunk_states=chunk_states)
    wkv6.launches += 1
    return out


class _WKV6(torch.autograd.Function):
    """Forward: the kernel on the card, keeping the state entering each
    chunk, the plain chunked version on the CPU. Backward: the backward
    kernel on the card; on the CPU the plain chunked version, recomputed
    under autograd from the saved inputs. A gradient of y or of the final
    state that autograd does not pass counts as zero."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        if r.device.type == "cpu":
            ctx.save_for_backward(r, k, v, w, u)
            return _forward(r, k, v, w, u, chunk)
        y, s_fin, s_chunks = _forward(r, k, v, w, u, chunk,
                                      chunk_states=True)
        ctx.save_for_backward(r, k, v, w, u, s_chunks)
        return y, s_fin

    @staticmethod
    def backward(ctx, gy, gs):
        if gy is None and gs is None:
            return (None,) * 6
        saved = ctx.saved_tensors   # once: a checkpoint unpacks it once
        if saved[0].device.type == "cuda":
            r, k, v, w, u, s_chunks = saved
            bh, _, n = r.shape
            gy = torch.zeros_like(r) if gy is None else gy.contiguous()
            gs = (r.new_zeros((bh, n, n)) if gs is None
                  else gs.contiguous())
            grads = cuda_wkv6.chunked_wkv6_backward(
                r, k, v, w, u, s_chunks, gy, gs, chunk=ctx.chunk)
            wkv6.backward_launches += 1
            return (*grads, None)
        inputs = [t.detach().requires_grad_() for t in saved]
        with torch.enable_grad():
            outs = chunked_wkv6_reference(*inputs, chunk=ctx.chunk)
        pairs = [(o, g) for o, g in zip(outs, (gy, gs)) if g is not None]
        grads = torch.autograd.grad([o for o, _ in pairs], inputs,
                                    [g for _, g in pairs], allow_unused=True)
        return (*grads, None)


wkv6.launches = 0
wkv6.backward_launches = 0
