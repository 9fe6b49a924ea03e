"""Embedding substrate: per-field tables, lookup, and batch id counts.

A port of the dense-placement half of ``repro.models.embedding``. One table
per categorical field, ``[vocab_f, dim]``: an id's vector is a *row* (the
paper's "column"). The lookup is ``F.embedding``, whose backward builds the
dense ``[vocab, dim]`` gradient by a sorted segment reduction on CUDA
(deterministic, unlike an atomic ``index_add_``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def init_field_tables(
    generator: torch.Generator,
    vocab_sizes: Sequence[int],
    dim: int,
    sigma: float = 1e-4,
    *,
    device="cuda",
    dtype=torch.float32,
) -> dict:
    """N(0, sigma) tables, one per field, drawn from ``generator`` (which
    must live on ``device``)."""
    return {
        f"field_{i}": (sigma * torch.randn((v, dim), generator=generator,
                                           device=device)).to(dtype)
        for i, v in enumerate(vocab_sizes)
    }


def lookup(tables: dict, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Gather per-field embeddings: ``{"field_i": [vocab_i, dim]}`` and
    ``[batch, n_fields]`` ids -> ``[batch, n_fields, dim]``. ``dtype`` casts
    each gathered column (mixed precision: the f32 master tables stay put)."""
    cols = [F.embedding(ids[:, i], tables[f"field_{i}"])
            for i in range(ids.shape[1])]
    if dtype is not None:
        cols = [c.to(dtype) for c in cols]
    return torch.stack(cols, dim=1)


def field_counts(ids: torch.Tensor, vocab_sizes: Sequence[int]) -> dict:
    """Per-field id occurrence counts in the batch (CowClip's ``cnt``):
    ``{"field_i": [vocab_i] float32}``, the ``cnt`` the fused kernel
    reads."""
    return {
        f"field_{i}": torch.bincount(ids[:, i], minlength=v).to(torch.float32)
        for i, v in enumerate(vocab_sizes)
    }
