"""Embedding substrate: per-field tables, lookup, and batch id counts.

A port of ``repro.models.embedding``. One table per categorical field,
``[vocab_f, dim]``: an id's vector is a *row* (the paper's "column"). Every
lookup goes through ``kernels.embedding.gather_fields``, all fields and
every group of tables read at the same ids (a CTR model's fm and LR
tables) at once: its forward gathers, and its backward builds every
table's dense ``[vocab, dim]`` gradient in one call of the port's own
embedding backward (a stable sort of the batch's rows, then a segmented
sum in a fixed order: a CUDA kernel on the card, its plain version on the
CPU), so a step's gradients repeat bit for bit under PyTorch's default
algorithms. PyTorch's CUDA ``embedding_dense_backward`` did not, at large
batches on fields whose ids repeat heavily.

Sparse unique-id layer
----------------------
A batch touches only the ids that occur in it, so the sparse placement
works on ``[n_unique, dim]`` gathered rows. ``unique_ids`` deduplicates one
field's batch column into a **static padded capacity**:

* slots ``[0, n_unique)`` hold the batch's distinct ids ascending; pad
  slots hold ``vocab`` (one past the last row) and count 0;
* the dedup is a stable sort, a run-length rank and scatters, with no host
  sync (``torch.unique`` would read its output size on the host, 26 times
  a step at Criteo width); it keeps its sort (``order``, ``rank``), so
  ``lookup_rows`` hands the embedding backward its order without a sort
  of its own (``slot_plan``);
* **overflow** (more distinct ids than ``capacity``): the ``capacity``
  smallest ids are kept and ``inv`` keeps the true rank, ``>= capacity``
  for a dropped id. ``lookup_rows`` then reads the last kept slot for it in
  the forward and drops its gradient in the backward, as the reference's
  clamping gather and dropping scatter do; dropped ids get no update.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..kernels.embedding import (FieldLayout, SortPlan, field_layout,
                                 gather_fields)


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


def _fields(group: dict, n: int) -> list:
    return [group[f"field_{i}"] for i in range(n)]


def lookup(groups: Sequence[dict], ids: torch.Tensor, dtype=None) -> list:
    """Gather per-field embeddings of each group of tables read at the same
    ids: ``{"field_i": [vocab_i, dim_g]}`` a group and ``[batch, n_fields]``
    ids -> a ``[batch, n_fields, dim_g]`` output a group; every group's
    gradients come from one backward call. ``dtype`` casts the gathered
    rows after the gather (mixed precision: the f32 master tables stay put
    and their gradients come back f32)."""
    outs = gather_fields([_fields(g, ids.shape[1]) for g in groups], ids)
    return [o if dtype is None else o.to(dtype) for o in outs]


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


def token_counts(tokens: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Occurrence counts of each vocab id in an LM batch (``[B, S]`` ints)
    -> ``[vocab_size]`` float32, the token table's CowClip ``cnt``: the
    batch as one field of ``field_counts`` (one ``index_add_``, ids outside
    ``[0, vocab_size)`` dropped, no host read)."""
    return field_counts(tokens.reshape(-1, 1), (vocab_size,))["field_0"]


class UniqueField(NamedTuple):
    """Static-size dedup of one field's batch ids.

    uids:   [capacity] int32, distinct batch ids ascending; pad slots hold
            ``vocab``.
    inv:    [batch] int32, slot of each batch element's id; ``>= capacity``
            for an id dropped on overflow.
    counts: [capacity] float32 batch occurrence count per slot (0 on pads).
    order:  [batch] int64, the batch elements by id, ties in batch order
            (the dedup's stable sort).
    rank:   [batch] int64, the slot of each element of ``order``
            (``inv[order]``, ascending).
    """

    uids: torch.Tensor
    inv: torch.Tensor
    counts: torch.Tensor
    order: torch.Tensor
    rank: torch.Tensor

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
    sorted_ids, perm = torch.sort(ids_col, stable=True)
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
                       counts=counts[:capacity].to(torch.float32),
                       order=perm, rank=rank)


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


def unique_owned_ids(ids_col: torch.Tensor, owned: torch.Tensor, vocab: int,
                     capacity: int):
    """Dedup the subset of a batch column that ``owned`` flags (one
    model shard's ids): the other ids are masked to the ``vocab``
    sentinel first, so the dedup runs at ``capacity + 1`` and the
    sentinel's slot (always the last real one: it is the largest value) is
    dropped.

    Returns ``(uids, counts, overflow)``: ``[capacity]`` int32 distinct
    owned ids ascending (pads ``vocab``), ``[capacity]`` f32 batch counts
    (0 on pads), and a 0-dim bool tensor, True when more than ``capacity``
    distinct owned ids were present (the ``capacity`` smallest are kept;
    a caller must then fall back to a dense update to stay exact)."""
    masked = torch.where(owned, ids_col, torch.full_like(ids_col, vocab))
    u = unique_ids(masked, vocab, capacity + 1)
    real = u.uids < vocab
    counts = torch.where(real, u.counts, 0.0)
    return (u.uids[:capacity], counts[:capacity], real[capacity])


def gather_rows(tables: dict, uniq: dict) -> dict:
    """Each field's unique rows, ``{"field_i": [capacity_i, dim]}``. Pad
    slots read the last row: values nothing reads back or scatters (and
    whose gradient, if any, is dropped). Differentiable through the port's
    embedding backward, a field at a time."""
    return {f: gather_fields([[tables[f]]], u.uids[:, None])[0][:, 0]
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


def slot_plan(fields: Sequence[UniqueField], layout: FieldLayout) -> SortPlan:
    """The order in which the embedding backward sums the slot rows'
    gradient of ``lookup_rows``, from the fields' dedups alone (no sort):
    field f's elements in its dedup's ``order``, keyed ``rank +
    layout.starts[f]``, at row-major position ``order * F + f``. With no
    overflow it equals the stable sort of ``layout.keys(inv)`` element for
    element; a dropped element (``rank >= capacity``, keyed past the
    buffer) ends its field's block instead of the whole list."""
    n = len(fields)
    rank = torch.stack([u.rank for u in fields])               # [F, B]
    keys = torch.where(rank < layout.vocab_t[:, None],
                       rank + layout.start_t[:, None], layout.rows)
    field = torch.arange(n, device=rank.device)[:, None]
    perm = torch.stack([u.order for u in fields]) * n + field
    return SortPlan(keys.to(torch.int32).reshape(-1), perm.reshape(-1))


def lookup_rows(groups: Sequence[dict], uniq: dict, dtype=None) -> list:
    """Forward lookup from each group's gathered unique rows -> a
    ``[batch, n_fields, dim_g]`` output a group, every field and group at
    once: batch row b of field f reads slot ``inv[b]`` of
    ``rows["field_f"]``. A slot index past the capacity (an id dropped on
    overflow) reads the last slot and passes no gradient back, as the
    reference's clamping gather and dropping scatter do: the embedding
    backward drops it. The backward sums in ``slot_plan``'s order, with
    no sort. ``dtype`` casts after the lookup, so the row gradients (what
    CowClip clips and Adam reads) stay f32."""
    fields = [uniq[f"field_{i}"] for i in range(len(uniq))]
    inv = torch.stack([u.inv for u in fields], dim=1)
    layout = field_layout(tuple(u.capacity for u in fields), inv.device)
    outs = gather_fields([_fields(g, len(fields)) for g in groups], inv,
                         plan=slot_plan(fields, layout))
    return [o if dtype is None else o.to(dtype) for o in outs]
