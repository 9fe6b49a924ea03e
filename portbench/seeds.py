"""Seeds of a run: every stream of random numbers comes from ``--seed``.

Each purpose (the traffic, the weights, the epochs' shuffles) gets a seed
of its own, drawn from ``--seed`` by a hash, so that two purposes of one
run, or one purpose of two runs with neighbouring seeds, never share a
stream. ``--seed`` may be any whole number, beyond 32 bits too.
"""

from __future__ import annotations

import hashlib

import torch


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` from the run's ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def generator(seed: int, purpose: str, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded for ``purpose``."""
    return torch.Generator(device=torch.device(device)).manual_seed(
        derive(seed, purpose))
