"""Launch the CUDA chunked WKV6 kernel (``csrc/wkv6.cu``).

It replaces the TPU kernel ``repro/kernels/wkv6/wkv6.py:chunked_wkv6``;
the source says what bounds it and how. It is compiled, with the port's
other kernels, into the one extension of ``kernels/extension.py``, at
first use and never at import.
"""

from __future__ import annotations

import torch

from ..extension import build

MAX_N = 64        # head size the kernel takes (csrc/wkv6.h)
MAX_CHUNK = 16    # chunk length the kernel takes


def chunked_wkv6(r, k, v, w, u, *, chunk: int = 16):
    """Launch the kernel on PyTorch's current stream: returns new f32
    ``(y [BH, S, N], final_state [BH, N, N])``. Inputs are checked by the
    caller (``ops.wkv6``) and again by the binding."""
    bh, seq, n = r.shape
    y = torch.empty_like(r)
    s_fin = torch.empty((bh, n, n), dtype=torch.float32, device=r.device)
    build().wkv6_chunked(r, k, v, w, u, y, s_fin, int(chunk))
    return y, s_fin
