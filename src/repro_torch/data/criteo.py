"""Criteo Display-Advertising-Challenge format loader.

Format: ``label \t I1..I13 \t C1..C26`` per line, tab-separated; integer
features may be empty, categorical features are 8-hex-digit strings.

We hash categorical values into per-field buckets (industry-standard trick;
keeps table sizes configurable) and apply ``log(1+x)`` to integer features
(the paper follows the DeepCTR preprocessing, which does the same).

Hashing is FNV-1a over the bytes of ``"{field}:{token}"``, vectorized across
rows: each field's token column is packed into a fixed-width byte matrix
(``np.frombuffer`` view) and the FNV chain runs once per byte *position*
over all rows at once, instead of once per character per row in Python —
the difference between a CPU-bound and an IO-bound pass over the 45M-row
TSV. ``_hash_token`` keeps the scalar definition; ``hash_tokens`` must (and
is tested to) agree with it exactly, so stored datasets stay stable.

The real 45M-row dataset is not shipped in this offline container; this
loader exists so the framework is deployable against it unchanged, and is
unit-tested against a tiny synthetic file in criteo format.

The port's own copy of ``repro.data.criteo`` (pure Python / NumPy), kept
verbatim so that ``repro_torch`` imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .synthetic import CTRDataset

N_INT = 13
N_CAT = 26

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_MASK32 = np.uint64(0xFFFFFFFF)


def _hash_token(field: int, token: str, vocab: int) -> int:
    """Scalar FNV-1a over (field, token); stable across runs/processes.

    Reference definition — the batched ``hash_tokens`` must match it.
    """
    h = _FNV_OFFSET
    for ch in f"{field}:{token}":
        h = ((h ^ ord(ch)) * _FNV_PRIME) & 0xFFFFFFFF
    return h % vocab


def hash_tokens(field: int, tokens: Sequence[str], vocab: int) -> np.ndarray:
    """Vectorized FNV-1a of one field's token column -> [n] int32 ids.

    The per-field prefix ``"{field}:"`` is folded into the seed once; the
    remaining chain runs per byte position across all rows (tokens carry no
    NUL bytes, so fixed-width padding is detectable as 0).
    """
    seed = _FNV_OFFSET
    for ch in f"{field}:":
        seed = ((seed ^ ord(ch)) * _FNV_PRIME) & 0xFFFFFFFF

    fixed = np.asarray(tokens, dtype=np.bytes_)      # [n] fixed-width bytes
    width = fixed.dtype.itemsize
    mat = np.frombuffer(fixed.tobytes(), np.uint8).reshape(len(fixed), width)

    h = np.full(len(fixed), seed, np.uint64)
    prime = np.uint64(_FNV_PRIME)
    for j in range(width):
        c = mat[:, j].astype(np.uint64)
        mixed = ((h ^ c) * prime) & _MASK32
        h = np.where(c != 0, mixed, h)               # 0 = padding: done
    return (h % np.uint64(vocab)).astype(np.int32)


def load_criteo_tsv(
    path: str,
    vocab_per_field: int = 100_000,
    max_rows: int | None = None,
) -> CTRDataset:
    labels, ints = [], []
    cat_cols: list[list[str]] = [[] for _ in range(N_CAT)]
    with open(path) as f:
        for row, line in enumerate(f):
            if max_rows is not None and row >= max_rows:
                break
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 1 + N_INT + N_CAT:
                raise ValueError(
                    f"{path}:{row}: expected {1+N_INT+N_CAT} cols, got {len(parts)}"
                )
            labels.append(float(parts[0]))
            ints.append(
                [float(x) if x else 0.0 for x in parts[1 : 1 + N_INT]]
            )
            for i, x in enumerate(parts[1 + N_INT :]):
                cat_cols[i].append(x if x else "<missing>")
    ids = np.stack(
        [hash_tokens(i, col, vocab_per_field)
         for i, col in enumerate(cat_cols)],
        axis=1,
    )
    dense = np.log1p(np.maximum(np.asarray(ints, np.float32), 0.0))
    return CTRDataset(
        ids=ids.astype(np.int32),
        dense=dense,
        labels=np.asarray(labels, np.float32),
        vocab_sizes=tuple([vocab_per_field] * N_CAT),
    )
