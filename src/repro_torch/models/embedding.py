"""Embedding substrate: per-field tables, lookup, and batch id counts.

A port of ``repro.models.embedding``. One table per categorical field,
``[vocab_f, dim]``: an id's vector is a *row* (the paper's "column"). Every
lookup goes through ``kernels.embedding.gather_fields``, all fields at once:
its forward gathers, and its backward builds the tables' dense ``[vocab,
dim]`` gradients in one call of the port's own embedding backward (a
stable sort of the batch's rows, then a segmented sum in a fixed order: a
CUDA kernel on the card, its plain version on the CPU), so a step's
gradients repeat bit for bit under PyTorch's default algorithms. PyTorch's
CUDA ``embedding_dense_backward`` did not, at large batches on fields whose
ids repeat heavily.

Sparse unique-id layer
----------------------
A batch touches only the ids that occur in it, so the sparse placement
works on ``[n_unique, dim]`` gathered rows. ``unique_ids`` deduplicates one
field's batch column into a **static padded capacity**:

* slots ``[0, n_unique)`` hold the batch's distinct ids ascending; pad
  slots hold ``vocab`` (one past the last row) and count 0;
* the dedup is a sort, a run-length rank and scatters, with no host sync
  (``torch.unique`` would read its output size on the host, 26 times a
  step at Criteo width);
* **overflow** (more distinct ids than ``capacity``): the ``capacity``
  smallest ids are kept and ``inv`` keeps the true rank, ``>= capacity``
  for a dropped id. ``lookup_rows`` then reads the last kept slot for it in
  the forward and drops its gradient in the backward, as the reference's
  clamping gather and dropping scatter do; dropped ids get no update.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..kernels.embedding import field_layout, gather_fields


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
    the gathered rows after the gather (mixed precision: the f32 master
    tables stay put and their gradients come back f32)."""
    out = gather_fields([tables[f"field_{i}"] for i in range(ids.shape[1])],
                        ids)
    return out if dtype is None else out.to(dtype)


def field_counts(ids: torch.Tensor, vocab_sizes: Sequence[int]) -> dict:
    """Per-field id occurrence counts in the batch (CowClip's ``cnt``):
    ``{"field_i": [vocab_i] float32}``, the ``cnt`` the fused kernel
    reads. Ids outside ``[0, vocab_i)`` are dropped, as the reference's
    ``segment_sum`` drops them. All fields go through one ``index_add_`` of
    ones into a static-size buffer laid out as the lookup's gradient
    (``kernels.embedding.field_layout``, with one drop bin past its end),
    so nothing is read back to the host; sums of ones are exact in f32
    below 2**24 in any order, so the counts are deterministic on the card
    too."""
    layout = field_layout(tuple(vocab_sizes), ids.device)
    keys = layout.keys(ids)
    counts = torch.zeros(layout.rows + 1, dtype=torch.float32,
                         device=ids.device)
    counts.index_add_(0, keys, torch.ones(keys.numel(), dtype=torch.float32,
                                          device=ids.device))
    return {f"field_{i}": c for i, c in enumerate(layout.split(counts))}


class UniqueField(NamedTuple):
    """Static-size dedup of one field's batch ids.

    uids:   [capacity] int32, distinct batch ids ascending; pad slots hold
            ``vocab``.
    inv:    [batch] int32, slot of each batch element's id; ``>= capacity``
            for an id dropped on overflow.
    counts: [capacity] float32 batch occurrence count per slot (0 on pads).
    """

    uids: torch.Tensor
    inv: torch.Tensor
    counts: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.uids.shape[0]

    def n_unique(self) -> torch.Tensor:
        """Number of real (non-pad) slots, as a 0-dim tensor."""
        return torch.sum((self.counts > 0).to(torch.int32))


def unique_ids(ids_col: torch.Tensor, vocab: int,
               capacity: int) -> UniqueField:
    """Deduplicate one field's batch column into a padded-capacity slot
    set, on the column's device and without a host sync."""
    n = ids_col.shape[0]
    sorted_ids, perm = torch.sort(ids_col)
    first = torch.ones(n, dtype=torch.int64, device=ids_col.device)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    rank = torch.cumsum(first, 0) - 1              # slot of each sorted id
    inv = torch.empty_like(rank).scatter_(0, perm, rank)
    size = max(n, capacity)
    # duplicate ranks write the same id, so the scatter is deterministic;
    # the integer count sums are exact in any order
    uids = torch.full((size,), vocab, dtype=ids_col.dtype,
                      device=ids_col.device).scatter_(0, rank, sorted_ids)
    counts = torch.zeros(size, dtype=torch.int32,
                         device=ids_col.device).index_add_(
        0, rank, torch.ones(n, dtype=torch.int32, device=ids_col.device))
    return UniqueField(uids=uids[:capacity].to(torch.int32),
                       inv=inv.to(torch.int32),
                       counts=counts[:capacity].to(torch.float32))


def batch_unique(ids: torch.Tensor, vocab_sizes: Sequence[int],
                 capacity: int = 0) -> dict:
    """Per-field dedup of a ``[batch, n_fields]`` id matrix:
    ``{"field_i": UniqueField}``. ``capacity <= 0`` selects the exact
    default ``min(batch, vocab_f)``; a positive value caps every field at
    ``min(capacity, vocab_f)``."""
    b = ids.shape[0]
    return {
        f"field_{i}": unique_ids(ids[:, i], v,
                                 min(b, v) if capacity <= 0
                                 else min(capacity, v))
        for i, v in enumerate(vocab_sizes)
    }


def gather_rows(tables: dict, uniq: dict) -> dict:
    """Each field's unique rows, ``{"field_i": [capacity_i, dim]}``. Pad
    slots read the last row: values nothing reads back or scatters (and
    whose gradient, if any, is dropped). Differentiable through the port's
    embedding backward, a field at a time."""
    return {f: gather_fields([tables[f]], u.uids[:, None])[:, 0]
            for f, u in uniq.items()}


def scatter_rows(tables: dict, uniq: dict, rows: dict) -> dict:
    """New tables with the unique rows written back; pad slots (uid out of
    range) are dropped."""
    out = {}
    for f, t in tables.items():
        keep = uniq[f].uids < t.shape[0]
        new = t.clone()
        new[uniq[f].uids[keep].to(torch.int64)] = rows[f][keep].to(t.dtype)
        out[f] = new
    return out


def lookup_rows(rows: dict, uniq: dict, dtype=None) -> torch.Tensor:
    """Forward lookup from gathered unique rows -> ``[batch, n_fields,
    dim]``, every field at once: batch row b of field f reads slot
    ``inv[b]`` of ``rows["field_f"]``. A slot index past the capacity (an
    id dropped on overflow) reads the last slot and passes no gradient
    back, as the reference's clamping gather and dropping scatter do: the
    embedding backward drops it. ``dtype`` casts after the lookup, so the
    row gradients (what CowClip clips and Adam reads) stay f32."""
    n = len(uniq)
    inv = torch.stack([uniq[f"field_{i}"].inv for i in range(n)], dim=1)
    out = gather_fields([rows[f"field_{i}"] for i in range(n)], inv)
    return out if dtype is None else out.to(dtype)
