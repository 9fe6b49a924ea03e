"""Launch the CUDA Mamba-2 scan kernels (``csrc/ssd_scan.cu``).

They replace no TPU kernel: the reference runs its scan as a
``jax.lax.scan`` over ``repro/models/mamba.py:_ssm_step``, which XLA
compiles and differentiates. The source says what bounds them and how.
They are compiled, with the port's other kernels, into the one extension
of ``kernels/extension.py``, at first use and never at import.

The forward is the chunk form of the recurrence on tensor cores
(``ref.ssd_scan_chunked_reference`` is the same decomposition): a block
per (b, h, 64 state rows) walks its 16-token chunks with the state in
registers, so the chunks' chain sets its time. When those blocks are too
few for the card, each (b, h)'s chunks are cut into segments
(``segment_chunks``): a pass from a zero state gives each segment but the
last its own state and log decay, a carry kernel walks the segments in
order, and the scan runs every segment from its incoming state; one call
still counts one launch (``ops.ssd_scan.launches``). The backward is the
reverse of the same chunk form on tensor cores
(``ref.ssd_scan_backward_chunked_reference`` is the same decomposition):
a block per (b, h, 64 state rows) walks the chunks backward with the
state's cotangent in registers and writes g_x, g_dt and each head's
share of g_b and g_c (the heads share b and c); a second kernel adds
those shares in a fixed order (no float atomics, so two runs give the
same bits).
"""

from __future__ import annotations

import torch

from ..extension import build
from .ref import n_chunks

MAX_N = 64        # state size the kernels take (csrc/ssd_scan.h)
ROWS = 64         # rows of the state a block holds, forward and backward
BLOCKS_PER_SM = 2     # forward blocks to aim for on each SM when the
                      # (b, h, rows) blocks alone are too few


def segment_chunks(blocks: int, chunks: int, sm_count: int) -> int:
    """Chunks per segment of the forward: the whole sequence when its
    ``blocks`` (b, h, rows) blocks give every SM one, else short enough
    that blocks x segments fill about ``BLOCKS_PER_SM`` blocks an SM
    (``scripts/time_torch_kernels.py --kernels ssd`` times the choices)."""
    if chunks <= 1 or blocks >= sm_count:
        return max(chunks, 1)
    segs = min(chunks, -(-BLOCKS_PER_SM * sm_count // blocks))
    return -(-chunks // segs)


def forward(xs, bmat, cmat, dt, a_log, d_skip, save: bool, segment=None):
    """Launch the forward kernels on PyTorch's current stream: new f32
    ``(y [B,S,H,P], final state [B,H,P,N], chunk states
    [B,H,n_chunks(S),P,N])``, the last of zero chunks unless ``save``.
    ``segment`` (chunks per segment) defaults to ``segment_chunks`` for
    this card. Inputs are checked by the caller (``ops.ssd_scan``) and
    again by the binding."""
    bsz, seq, n_heads, head_dim = xs.shape
    n = bmat.shape[-1]
    chunks = n_chunks(seq)
    if segment is None:
        sms = torch.cuda.get_device_properties(
            xs.device).multi_processor_count
        segment = segment_chunks(bsz * n_heads * -(-head_dim // ROWS),
                                 chunks, sms)
    segs = -(-chunks // segment)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=xs.device)

    y = torch.empty_like(xs)
    s_fin = empty(bsz, n_heads, head_dim, n)
    s_chunks = empty(bsz, n_heads, chunks if save else 0, head_dim, n)
    # scratch of the segment carry: each segment's own state and log decay
    # (the first pass), then each segment's incoming state (the carry)
    s_loc, s_in = (empty(bsz, n_heads, segs - 1, head_dim, n)
                   for _ in range(2))
    log_decay = empty(bsz, n_heads, segs - 1)
    build().ssd_scan_forward(xs, bmat, cmat, dt, a_log, d_skip, y, s_fin,
                             s_chunks, s_loc, log_decay, s_in, int(segment))
    return y, s_fin, s_chunks


def backward(xs, bmat, cmat, dt, a_log, d_skip, s_chunks, gy, gs):
    """Launch the backward kernels on PyTorch's current stream: new f32
    ``(g_x, g_b, g_c, g_dt, g_A_log, g_D)``."""
    bsz, seq, n_heads, head_dim = xs.shape
    n = bmat.shape[-1]
    groups = -(-head_dim // ROWS)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=xs.device)

    grads = (torch.empty_like(xs), torch.empty_like(bmat),
             torch.empty_like(cmat), torch.empty_like(dt),
             torch.empty_like(a_log), torch.empty_like(d_skip))
    # each (b, h, group of rows)'s share of the sums across blocks: g_b's
    # and g_c's over heads, g_dt's over groups (none with one group: the
    # scan writes g_dt), A_log's and D's
    part_b, part_c = (empty(bsz, seq, n_heads, groups, n) for _ in range(2))
    part_dt = empty(bsz, seq, n_heads, groups if groups > 1 else 0)
    part_h = empty(2, bsz, n_heads, groups)
    build().ssd_scan_backward(xs, bmat, cmat, dt, a_log, d_skip, s_chunks,
                              gy, gs, *grads, part_b, part_c, part_dt,
                              part_h)
    return grads
