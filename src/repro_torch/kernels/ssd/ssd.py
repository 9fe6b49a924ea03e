"""Launch the CUDA Mamba-2 scan kernels (``csrc/ssd_scan.cu``).

They replace no TPU kernel: the reference runs its scan as a
``jax.lax.scan`` over ``repro/models/mamba.py:_ssm_step``, which XLA
compiles and differentiates. The source says what bounds them and how.
They are compiled, with the port's other kernels, into the one extension
of ``kernels/extension.py``, at first use and never at import.

The forward is one kernel; the backward two: the reverse scan writes each
block's share of the sums across heads and P tiles into scratch, and a
second kernel adds them in a fixed order (no float atomics, so two runs
give the same bits).
"""

from __future__ import annotations

import torch

from ..extension import build
from .ref import n_chunks

MAX_N = 64        # state size the kernels take (csrc/ssd_scan.h)
P_TILE = 16       # rows of the state a block holds


def forward(xs, bmat, cmat, dt, a_log, d_skip, save: bool):
    """Launch the forward kernel on PyTorch's current stream: new f32
    ``(y [B,S,H,P], final state [B,H,P,N], chunk states
    [B,H,n_chunks(S),P,N])``, the last of zero chunks unless ``save``.
    Inputs are checked by the caller (``ops.ssd_scan``) and again by the
    binding."""
    bsz, seq, n_heads, head_dim = xs.shape
    n = bmat.shape[-1]
    y = torch.empty_like(xs)
    s_fin = torch.empty((bsz, n_heads, head_dim, n), dtype=torch.float32,
                        device=xs.device)
    s_chunks = torch.empty((bsz, n_heads, n_chunks(seq) if save else 0,
                            head_dim, n), dtype=torch.float32,
                           device=xs.device)
    build().ssd_scan_forward(xs, bmat, cmat, dt, a_log, d_skip, y, s_fin,
                             s_chunks)
    return y, s_fin, s_chunks


def backward(xs, bmat, cmat, dt, a_log, d_skip, s_chunks, gy, gs):
    """Launch the backward kernels on PyTorch's current stream: new f32
    ``(g_x, g_b, g_c, g_dt, g_A_log, g_D)``."""
    bsz, seq, n_heads, head_dim = xs.shape
    n = bmat.shape[-1]
    tiles = -(-head_dim // P_TILE)
    dev = xs.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    grads = (torch.empty_like(xs), torch.empty_like(bmat),
             torch.empty_like(cmat), torch.empty_like(dt),
             torch.empty_like(a_log), torch.empty_like(d_skip))
    # each block's share of the sums across blocks
    part_b, part_c = empty(bsz, seq, n_heads, tiles, n), \
        empty(bsz, seq, n_heads, tiles, n)
    part_dt = empty(bsz, seq, n_heads, tiles)
    part_h = empty(2, bsz, n_heads, tiles)          # A_log's, D's
    build().ssd_scan_backward(xs, bmat, cmat, dt, a_log, d_skip, s_chunks,
                              gy, gs, *grads, part_b, part_c, part_dt,
                              part_h)
    return grads
