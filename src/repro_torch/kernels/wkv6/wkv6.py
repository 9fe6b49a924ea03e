"""Launch the CUDA chunked WKV6 kernels (``csrc/wkv6.cu``).

They replace the TPU kernel ``repro/kernels/wkv6/wkv6.py:chunked_wkv6``;
the source says what bounds them and how. They are compiled, with the
port's other kernels, into the one extension of ``kernels/extension.py``,
at first use and never at import.

Each bh's chunks are cut into segments of whole chunks
(``segment_chunks``): pass 1 gives each segment but the last its own
state contribution and total decay, a short carry gives each segment its
incoming state, and pass 2 runs the scan of every segment from it
(``ref.segmented_wkv6_reference`` is the same decomposition in plain
PyTorch). With one segment a bh, only pass 2 runs.
"""

from __future__ import annotations

import torch

from ..extension import build

MAX_N = 64        # head size the kernel takes (csrc/wkv6.h)
MAX_CHUNK = 16    # chunk length the kernel takes
BLOCKS_PER_SM = 2     # pass-2 blocks an SM holds (its shared memory)
WAVES = 8             # waves of blocks to aim for when BH alone is too few


def segment_chunks(bh: int, n_chunks: int, sm_count: int) -> int:
    """Chunks per segment: the whole sequence when ``bh`` gives every SM a
    block (a second segment would add pass 1's work: at [256, 4096, 64]
    one segment beats two, ``scripts/time_torch_kernels.py``), else short
    enough that ``bh`` x segments fills the card's ``BLOCKS_PER_SM *
    sm_count`` slots about ``WAVES`` times."""
    if n_chunks <= 1 or bh >= sm_count:
        return max(n_chunks, 1)
    segs = min(n_chunks, -(-WAVES * BLOCKS_PER_SM * sm_count // bh))
    return -(-n_chunks // segs)


def chunked_wkv6(r, k, v, w, u, *, chunk: int = 16, segment=None):
    """Launch the kernels on PyTorch's current stream: returns new f32
    ``(y [BH, S, N], final_state [BH, N, N])``. ``segment`` (chunks per
    segment) defaults to ``segment_chunks`` for this card. Inputs are
    checked by the caller (``ops.wkv6``) and again by the binding."""
    bh, seq, n = r.shape
    n_chunks = seq // chunk
    if segment is None:
        sms = torch.cuda.get_device_properties(r.device).multi_processor_count
        segment = segment_chunks(bh, n_chunks, sms)
    segs = max(1, -(-n_chunks // segment))
    y = torch.empty_like(r)
    s_fin = torch.empty((bh, n, n), dtype=torch.float32, device=r.device)
    # scratch of the segment carry: each segment's own state and decay
    # (pass 1), then each segment's incoming state (the carry)
    s_loc = torch.empty((bh, segs - 1, n, n), dtype=torch.float32,
                        device=r.device)
    p_seg = torch.empty((bh, segs - 1, n), dtype=torch.float32,
                        device=r.device)
    s_in = torch.empty_like(s_loc)
    build().wkv6_chunked(r, k, v, w, u, y, s_fin, s_loc, p_seg, s_in,
                         int(chunk), int(segment))
    return y, s_fin
