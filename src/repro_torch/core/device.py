"""Device resolution for the port's entry points.

Entry points take an explicit ``device`` that defaults to ``"cuda"``.
Without a CUDA device that default raises: a run never carries on on the
CPU unless the caller asked for the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (--device cpu) to run on the CPU")
    return dev
