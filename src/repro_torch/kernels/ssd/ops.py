"""Public wrapper for the Mamba-2 (SSD) selective scan.

``ssd_scan`` takes xs ``[B,S,H,P]``, b and c ``[B,S,N]``, dt ``[B,S,H]``,
A_log and D ``[H]``, all f32, and returns ``(y [B,S,H,P], final state
[B,H,P,N])``. It is two operators of the ``repro_torch`` library:

* ``repro_torch::ssd_scan_fwd``: a CUDA tensor launches the forward
  kernels (``ssd.py``: the chunk form on tensor cores, one kernel, or three
  with sequence segments), a CPU tensor runs the plain token loop
  (``ref.ssd_scan_reference``); with ``save`` it also returns the state at
  the start of every ``ref.CHUNK``-token chunk, for the backward.
* ``repro_torch::ssd_scan_bwd``: the backward kernels on the card (the
  reverse chunk form on tensor cores, ``ref.
  ssd_scan_backward_chunked_reference`` in plain PyTorch, and the sums
  across heads), the written-out reverse recurrence
  (``ref.ssd_scan_backward_reference``) on the CPU.

Each has a shape function (``register_fake``), so a trace on fake tensors
(the dry-run) runs the scan as one op whatever S is, and a FLOP formula
(``register_flop_formula``) that counts what ``FlopCounterMode`` counts
for the plain version: its ``states @ c`` product, ``2 B S H P N``
forward, twice that backward. Under autograd ``ssd_scan`` is a
``torch.autograd.Function`` over the two; without a gradient to flow it
calls the forward alone and keeps no state. ``ssd_scan.launches`` counts
the forward's launches (one a call, however many kernels it runs),
``ssd_scan.backward_launches`` the backward's (a launch of its two
kernels), so a run can show that its main path went through them.
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from . import ssd as cuda_ssd
from .ref import (n_chunks, ssd_scan_backward_reference,
                  ssd_scan_reference)


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, xs on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, got "
                         f"{list(t.shape)}")


@torch.library.custom_op("repro_torch::ssd_scan_fwd", mutates_args=())
def ssd_scan_fwd(xs: Tensor, bmat: Tensor, cmat: Tensor, dt: Tensor,
                 a_log: Tensor, d_skip: Tensor,
                 save: bool) -> tuple[Tensor, Tensor, Tensor]:
    """(y, final state, chunk states: zero chunks unless ``save``)."""
    if xs.device.type == "cuda":
        out = cuda_ssd.forward(xs, bmat, cmat, dt, a_log, d_skip, save)
        ssd_scan.launches += 1
        return out
    if save:
        return ssd_scan_reference(xs, bmat, cmat, dt, a_log, d_skip,
                                  chunk_states=True)
    y, s_fin = ssd_scan_reference(xs, bmat, cmat, dt, a_log, d_skip)
    b, _, h, p = xs.shape
    return y, s_fin, xs.new_empty((b, h, 0, p, bmat.shape[-1]))


@ssd_scan_fwd.register_fake
def _(xs, bmat, cmat, dt, a_log, d_skip, save):
    b, s, h, p = xs.shape
    n = bmat.shape[-1]
    return (xs.new_empty((b, s, h, p)), xs.new_empty((b, h, p, n)),
            xs.new_empty((b, h, n_chunks(s) if save else 0, p, n)))


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def ssd_scan_bwd(xs: Tensor, bmat: Tensor, cmat: Tensor, dt: Tensor,
                 a_log: Tensor, d_skip: Tensor, s_chunks: Tensor,
                 gy: Tensor, gs: Tensor) -> tuple[Tensor, Tensor, Tensor,
                                                  Tensor, Tensor, Tensor]:
    """(g_x, g_b, g_c, g_dt, g_A_log, g_D)."""
    if xs.device.type == "cuda":
        out = cuda_ssd.backward(xs, bmat, cmat, dt, a_log, d_skip,
                                s_chunks, gy, gs)
        ssd_scan.backward_launches += 1
        return out
    return ssd_scan_backward_reference(xs, bmat, cmat, dt, a_log, d_skip,
                                       s_chunks, gy, gs)


@ssd_scan_bwd.register_fake
def _(xs, bmat, cmat, dt, a_log, d_skip, s_chunks, gy, gs):
    return tuple(torch.empty_like(t) for t in (xs, bmat, cmat, dt, a_log,
                                               d_skip))


@register_flop_formula(torch.ops.repro_torch.ssd_scan_fwd)
def _fwd_flops(xs_shape, bmat_shape, *args, **kwargs) -> int:
    b, s, h, p = xs_shape
    return 2 * b * s * h * p * bmat_shape[-1]


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _bwd_flops(xs_shape, bmat_shape, *args, **kwargs) -> int:
    b, s, h, p = xs_shape
    return 4 * b * s * h * p * bmat_shape[-1]


def ssd_scan(xs, bmat, cmat, dt, a_log, d_skip):
    """The selective scan from a zero state: ``(y [B,S,H,P], final state
    [B,H,P,N])``, f32. Raises ``ValueError`` when S is 0, N > 64 (the
    kernels' limit, held on both devices) or the tensors are not on a CPU
    or CUDA device. Differentiable in all six inputs."""
    if not isinstance(xs, torch.Tensor) or xs.dim() != 4:
        raise ValueError("xs must be a [B, S, H, P] torch.Tensor")
    b, s, h, p = xs.shape
    n = bmat.shape[-1] if isinstance(bmat, torch.Tensor) else 0
    _check("xs", xs, (b, s, h, p), xs.device)
    _check("bmat", bmat, (b, s, n), xs.device)
    _check("cmat", cmat, (b, s, n), xs.device)
    _check("dt", dt, (b, s, h), xs.device)
    _check("a_log", a_log, (h,), xs.device)
    _check("d_skip", d_skip, (h,), xs.device)
    if s < 1:
        raise ValueError("the scan needs at least one token")
    if not 1 <= n <= cuda_ssd.MAX_N:
        raise ValueError(f"state size {n} outside [1, {cuda_ssd.MAX_N}]")
    if xs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no ssd_scan kernel for device {xs.device}")
    ins = (xs, bmat, cmat, dt, a_log, d_skip)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return _SSDScan.apply(*ins)
    y, s_fin, _ = ssd_scan_fwd(*ins, False)
    return y, s_fin


class _SSDScan(torch.autograd.Function):
    """The forward op keeping the chunk states, the backward op on them.
    A gradient of y or of the final state that autograd does not pass
    counts as zero."""

    @staticmethod
    def forward(ctx, xs, bmat, cmat, dt, a_log, d_skip):
        y, s_fin, s_chunks = ssd_scan_fwd(xs, bmat, cmat, dt, a_log,
                                          d_skip, True)
        ctx.save_for_backward(xs, bmat, cmat, dt, a_log, d_skip, s_chunks)
        ctx.set_materialize_grads(False)
        return y, s_fin

    @staticmethod
    def backward(ctx, gy, gs):
        xs, bmat, cmat, dt, a_log, d_skip, s_chunks = ctx.saved_tensors
        b, _, h, p = xs.shape
        gy = torch.zeros_like(xs) if gy is None else gy.contiguous()
        gs = (xs.new_zeros((b, h, p, bmat.shape[-1])) if gs is None
              else gs.contiguous())
        return ssd_scan_bwd(xs, bmat, cmat, dt, a_log, d_skip, s_chunks,
                            gy, gs)


ssd_scan.launches = 0
ssd_scan.backward_launches = 0
