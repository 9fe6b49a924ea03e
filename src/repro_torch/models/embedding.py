"""Embedding substrate: per-field tables, lookup, and batch id counts.

A port of ``repro.models.embedding``. One table per categorical field,
``[vocab_f, dim]``: an id's vector is a *row* (the paper's "column"). The
lookup is ``F.embedding``, whose backward builds the dense ``[vocab, dim]``
gradient by a sorted segment reduction on CUDA. Under PyTorch's default
algorithms that backward is not deterministic run to run at large batches
on fields whose ids repeat heavily (131,072 rows of deepfm-criteo: the
fields of 306 ids or fewer; ROADMAP queue 3); under
``torch.use_deterministic_algorithms`` it is.

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

import functools
from typing import NamedTuple, Sequence

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


_COUNT_ALIGN = 64        # floats: each field's counts start 256-B aligned


@functools.cache
def _count_layout(vocab_sizes: tuple, device: torch.device):
    """Where each field's counts live in the one bin buffer of
    ``field_counts``: field i's id 0 at ``starts[i]``, a multiple of
    _COUNT_ALIGN (so the fused kernel's aligned path takes every field),
    with a drop bin just below it (ids < 0) and one at ``starts[i] +
    vocab_i`` (ids >= vocab_i). Returns the starts as a list, then as
    int64 tensors on ``device`` the clamp bounds ``-1`` and ``vocab_i`` and
    the starts (made once per layout, so a step copies nothing to the
    card), and the buffer's length."""
    starts, end = [], 0
    for v in vocab_sizes:
        start = -(-(end + 1) // _COUNT_ALIGN) * _COUNT_ALIGN
        starts.append(start)
        end = start + v + 1

    def on_device(values):
        return torch.tensor(values, dtype=torch.int64, device=device)

    return (starts, on_device([-1] * len(starts)),
            on_device(list(vocab_sizes)), on_device(starts), end)


def field_counts(ids: torch.Tensor, vocab_sizes: Sequence[int]) -> dict:
    """Per-field id occurrence counts in the batch (CowClip's ``cnt``):
    ``{"field_i": [vocab_i] float32}``, the ``cnt`` the fused kernel
    reads. Ids outside ``[0, vocab_i)`` are dropped, as the reference's
    ``segment_sum`` drops them. All fields go through one ``index_add_`` of
    ones into a static-size buffer, so nothing is read back to the host;
    sums of ones are exact in f32 below 2**24 in any order, so the counts
    are deterministic on the card too."""
    starts, lows, highs, offsets, size = _count_layout(
        tuple(vocab_sizes), ids.device)
    bins = torch.clamp(ids, lows, highs) + offsets
    counts = torch.zeros(size, dtype=torch.float32, device=ids.device)
    counts.index_add_(0, bins.reshape(-1),
                      torch.ones(bins.numel(), dtype=torch.float32,
                                 device=ids.device))
    return {f"field_{i}": counts[s:s + v]
            for i, (s, v) in enumerate(zip(starts, vocab_sizes))}


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


def _clamped(uids: torch.Tensor, rows: int) -> torch.Tensor:
    """Slot uids as in-range row indices: a pad (``vocab``) reads the last
    row, as the reference's clamping gather does."""
    return torch.clamp_max(uids.to(torch.int64), rows - 1)


def gather_rows(tables: dict, uniq: dict) -> dict:
    """Each field's unique rows, ``{"field_i": [capacity_i, dim]}``. Pad
    slots read the last row: values nothing reads back or scatters."""
    return {f: tables[f][_clamped(u.uids, tables[f].shape[0])]
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


def _lookup_slots(rows: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``rows[inv]`` with the reference's overflow semantics: a slot index
    past the last row reads the last row in the forward and passes no
    gradient back. The gradient reaches ``rows`` through ``F.embedding``'s
    sorted segment sum, which on CUDA is bitwise repeatable only under
    ``torch.use_deterministic_algorithms`` (the module note says when)."""
    cap = rows.shape[0]
    # int32 indices: the backward's sort then runs on 32-bit keys
    out = F.embedding(torch.clamp_max(inv, cap - 1), rows)
    if inv.shape[0] <= cap:      # every slot index is in range
        return out
    return torch.where((inv < cap)[:, None], out, out.detach())


def lookup_rows(rows: dict, uniq: dict, dtype=None) -> torch.Tensor:
    """Forward lookup from gathered unique rows -> ``[batch, n_fields,
    dim]``. ``dtype`` casts each column after the lookup, so the row
    gradients (what CowClip clips and Adam reads) stay f32."""
    cols = [_lookup_slots(rows[f"field_{i}"], uniq[f"field_{i}"].inv)
            for i in range(len(uniq))]
    if dtype is not None:
        cols = [c.to(dtype) for c in cols]
    return torch.stack(cols, dim=1)
