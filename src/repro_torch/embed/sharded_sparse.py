"""Sharded+sparse hybrid placement: the per-shard unique-id update.

A port of ``repro.embed.sharded_sparse``. The ``sharded`` placement
(``embed.sharded``) splits the tables' rows over ``"model"``, but its
update is dense a shard: every step streams all ``rows_per_shard`` rows
through the fused kernel. This placement updates only the rows of the
batch ids a shard owns:

* Each model shard dedups the owned ids of the global batch into a
  static-capacity slot set (local rows ascending; pads ``rows_per_shard``,
  count 0). With a data axis the dedup is staged: each data slice dedups
  its own column with counts (``slice_unique_counts``), the slices' sets
  are all-gathered over ``"data"``, and each shard dedups the owned subset
  of the union with the counts summed a slot (``owned_unique_weighted``;
  the same slots, counts and overflow flag as ``owned_unique_local`` on
  the gathered batch). With one data slice the single-stage dedup runs.
* After the backward, the touched rows are gathered from the raw shard
  with their pending coupled-L2 decay applied in closed form and updated
  by CowClip -> coupled L2 -> Adam, scattered back with ``last_step =
  t`` (``update_phases``): the sparse pair, kernels 2 and 3 (``kernels
  .cowclip``), one grouped launch each for every table of the rank
  (``row_offset`` 0: the slots hold local rows).
* **Overflow** (more distinct owned ids than the capacity, possible only
  when ``unique_capacity`` caps it below ``min(batch, rows_per_shard)``):
  the shard takes the dense update for that step instead (the closed-form
  catch-up of all its rows, then the fused kernel 1, ``last_step = t``
  everywhere), so the hybrid stays exact. The reference branches with
  ``lax.cond``; a branch on the card would need a host read, so for a
  field that can overflow both branches run and the on-device flag
  selects, row for row. A field at the exact default capacity traces no
  fallback, as in the reference.

The forward reads the raw tables and applies each row's pending decay
inline during the lookup (``embed.sharded.decayed_lookup_partial``), so it
needs nothing from the dedup or its collectives.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..core.optim import decay_factor
from .sharded import RowShardPlan, decay_scale, owned_mask_and_rows


def shard_capacity(plan: RowShardPlan, batch: int,
                   unique_capacity: int = 0) -> int:
    """Static per-shard slot capacity of one field: the exact
    ``min(batch, rows_per_shard)`` for ``unique_capacity <= 0`` (a shard
    cannot see more distinct owned ids), else capped by it (overflow then
    takes the dense fallback)."""
    exact = min(batch, plan.rows_per_shard)
    if unique_capacity <= 0:
        return max(1, exact)
    return max(1, min(unique_capacity, exact))


class ShardUniqueSets(NamedTuple):
    """Every shard's dedup of one field's global batch column.

    local_rows: [n_shards, capacity] int32 owned ids' local rows, ascending
                by id; pads hold ``rows_per_shard``.
    counts:     [n_shards, capacity] f32 global batch counts (0 on pads).
    overflow:   [n_shards] bool, the shards with more distinct owned ids
                than the capacity.
    """

    local_rows: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor


def _local_rows(uids: torch.Tensor, plan: RowShardPlan) -> torch.Tensor:
    """Owned uids -> local rows; pads (uid == vocab) -> ``rows_per_shard``
    (the sentinel's own local row may land inside the shard)."""
    return torch.where(uids < plan.vocab, plan.local_row(uids),
                       plan.rows_per_shard).to(torch.int32)


def shard_unique_sets(ids_col: torch.Tensor, plan: RowShardPlan,
                      capacity: int) -> ShardUniqueSets:
    """All shards' dedups at once: the host's view (tests, checks of the
    overflow count). The step dedups on its own shard only."""
    from ..models.embedding import unique_owned_ids

    shard = plan.shard_of(ids_col)
    locs, cnts, ovfs = [], [], []
    for s in range(plan.n_shards):
        uids, counts, overflow = unique_owned_ids(ids_col, shard == s,
                                                  plan.vocab, capacity)
        locs.append(_local_rows(uids, plan))
        cnts.append(counts)
        ovfs.append(overflow)
    return ShardUniqueSets(torch.stack(locs), torch.stack(cnts),
                           torch.stack(ovfs))


def owned_unique_local(ids_col: torch.Tensor, plan: RowShardPlan,
                       capacity: int, shard: int):
    """Shard ``shard``'s dedup of the owned ids of a global batch column:
    ``(local_rows [capacity], counts [capacity], overflow)`` with the
    ``ShardUniqueSets`` conventions. The single-stage dedup, and the oracle
    of the staged one."""
    from ..models.embedding import unique_owned_ids

    uids, counts, overflow = unique_owned_ids(
        ids_col, plan.shard_of(ids_col) == shard, plan.vocab, capacity)
    return _local_rows(uids, plan), counts, overflow


def slice_unique_counts(ids_col: torch.Tensor, vocab: int, capacity: int):
    """Stage 1 of the staged dedup: one data slice's column deduplicated
    with counts, before any collective. ``capacity`` must be the exact
    ``min(len(ids_col), vocab)``. Pads hold ``vocab`` with count 0.
    Returns ``(uids int32, counts f32)``."""
    from ..models.embedding import unique_ids

    u = unique_ids(ids_col, vocab, capacity)
    return u.uids, u.counts


def _owned(gids: torch.Tensor, plan: RowShardPlan, shard: int):
    return (plan.shard_of(gids) == shard) & (gids < plan.vocab)


def owned_unique_weighted(gids: torch.Tensor, gcnts: torch.Tensor,
                          plan: RowShardPlan, capacity: int, shard: int):
    """Stage 2 of the staged dedup: the owned subset of the all-gathered
    slice sets (``gids``/``gcnts``, the slices' ``slice_unique_counts``
    end to end over ``"data"``), with the gathered counts summed a slot.
    Returns ``(local_rows [capacity], counts [capacity], overflow)``, what
    ``owned_unique_local`` gives on the raw gathered batch. The count sums
    are integers below 2**24, exact in any order."""
    from ..models.embedding import unique_ids

    owned = _owned(gids, plan, shard)
    masked = torch.where(owned, gids, torch.full_like(gids, plan.vocab))
    u = unique_ids(masked, plan.vocab, capacity + 1)
    n = gids.shape[0]
    counts = torch.zeros(max(n, capacity + 1), dtype=torch.float32,
                         device=gids.device)
    counts.index_add_(0, u.inv.to(torch.int64),
                      torch.where(owned, gcnts, 0.0))
    real = u.uids < plan.vocab
    counts = torch.where(real, counts[:capacity + 1], 0.0)
    return (_local_rows(u.uids[:capacity], plan), counts[:capacity],
            real[capacity])


def full_counts_from_gathered(gids: torch.Tensor, gcnts: torch.Tensor,
                              plan: RowShardPlan, shard: int) -> torch.Tensor:
    """CowClip's ``[rows_per_shard]`` global counts of the dense fallback,
    from the gathered slice sets (they cover the global batch: no
    collective)."""
    owned = _owned(gids, plan, shard)
    local = torch.where(owned, plan.local_row(gids),
                        plan.rows_per_shard).to(torch.int64)
    out = torch.zeros(plan.rows_per_shard + 1, dtype=torch.float32,
                      device=gids.device)
    out.index_add_(0, local, torch.where(owned, gcnts, 0.0))
    return out[:plan.rows_per_shard]


def slot_keys(local: torch.Tensor, mine: torch.Tensor,
              uloc: torch.Tensor) -> torch.Tensor:
    """Each batch element's slot in the ascending slot set ``uloc``
    (``[capacity]``, pads ``rows_per_shard``): found by binary search;
    ``capacity`` (past the slots: dropped) for a foreign id or one with no
    slot. The keys of ``rowgrad_slots``."""
    capacity = uloc.shape[0]
    slot = torch.searchsorted(uloc, local.to(uloc.dtype))
    clipped = torch.clamp_max(slot, capacity - 1)
    hit = mine & (uloc[clipped] == local)
    return torch.where(hit, clipped, capacity)


def rowgrad_slots(g_col: torch.Tensor, ids_col: torch.Tensor,
                  plan: RowShardPlan, uloc: torch.Tensor,
                  shard: int) -> torch.Tensor:
    """This batch slice's ``[capacity, D]`` gradient of one field's slot
    rows: each owned id's cotangent summed onto its slot (``slot_keys``);
    a SUM over ``"data"`` completes it. Only exact when the slot set holds
    every owned id (no overflow). The plain form of one field: the step
    sums every field and group in one call of the embedding backward."""
    from ..kernels.embedding import embedding_backward

    mine, local = owned_mask_and_rows(ids_col, plan, shard)
    keys = slot_keys(local, mine, uloc).to(torch.int32)
    return embedding_backward(keys, g_col, uloc.shape[0])


class ShardTable(NamedTuple):
    """One (group, field) shard's update inputs for ``update_phases``.

    ``w, m, v`` ``[rows, D]`` f32 and ``last_step`` ``[rows]`` int32, the
    raw shard, updated in place; ``uloc``/``counts`` its slot set;
    ``overflow`` the 0-dim bool flag, or None where overflow is
    impossible; ``g_slots`` the ``[capacity, D]`` slot gradient, or None
    with ``g_full`` the ``[rows, D]`` one (a field that can overflow) and
    ``cnt_full`` its ``[rows]`` counts."""

    w: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    last_step: torch.Tensor
    uloc: torch.Tensor
    counts: torch.Tensor
    overflow: Optional[torch.Tensor]
    g_slots: Optional[torch.Tensor]
    g_full: Optional[torch.Tensor] = None
    cnt_full: Optional[torch.Tensor] = None


def update_phases(tables: Sequence[ShardTable], step, *, clip=True, r=1.0,
                  zeta=1e-5, lr=1e-4, l2=1e-5, b1=0.9, b2=0.999,
                  eps=1e-8) -> torch.Tensor:
    """The reference's ``update_phase`` for every (group, field) shard of
    a rank at once, in place, from the raw tables (the forward scattered nothing into them).
    ``step`` is the step's ``StepScalars``.

    Sparse branch, every table: one grouped launch of the catch-up kernel
    (the touched rows with their pending decay applied through ``t - 1``),
    one grouped launch of the update kernel (CowClip -> coupled L2 ->
    Adam on them, scattered back, ``last_step = t`` on the touched rows;
    the others keep accruing decay). The slot gradient is ``g_slots``, or
    for a field that can overflow the rows of ``g_full`` at its slots.

    Dense fallback, only for a table whose ``overflow`` is a flag: from
    the raw shard, before the sparse kernels write it, the whole shard
    caught up through ``t - 1`` into new buffers and updated there by the
    fused kernel 1 (``sharded.shard_update``); after the sparse branch,
    ``torch.where`` on the flag keeps one branch's w, m, v and
    ``last_step`` (``t`` everywhere for the fallback). Under the guard
    (``step.ok`` set) the select is on ``overflow & ok``: the sparse
    kernels write nothing on a skipped step, and neither does the
    fallback.

    Returns the catch-up kernel's deepest pending decay over the real
    slots (0-dim int32): this rank's ``catchup_depth_max``."""
    from ..kernels.cowclip import (sparse_gather_catchup_tables,
                                   sparse_update_scatter_tables)
    from .sharded import shard_update

    adam_kw = dict(lr=lr, l2=l2, b1=b1, b2=b2, eps=eps)
    t = step.step
    factor = decay_factor(lr, l2)
    fallback = {}
    for i, tb in enumerate(tables):
        if tb.overflow is None:
            continue
        scale = decay_scale(tb.last_step, t, factor)
        wd, md, vd = tb.w * scale[:, None], tb.m.clone(), tb.v.clone()
        shard_update(wd, tb.g_full, tb.cnt_full, md, vd, step, clip=clip,
                     r=r, zeta=zeta, **adam_kw)
        fallback[i] = (wd, md, vd)

    cols = [[tb[j] for tb in tables] for j in range(6)]
    rows, depth = sparse_gather_catchup_tables(*cols, step, **adam_kw)
    g_rows = [tb.g_slots if tb.g_slots is not None
              else tb.g_full[torch.clamp_max(tb.uloc.to(torch.int64),
                                             tb.w.shape[0] - 1)]
              for tb in tables]
    sparse_update_scatter_tables(
        *cols, [x[0] for x in rows], g_rows, [x[1] for x in rows],
        [x[2] for x in rows], step, r=r, zeta=zeta, clip=clip, **adam_kw)

    with torch.no_grad():
        for i, (wd, md, vd) in fallback.items():
            tb = tables[i]
            # under the guard a skipped step keeps the live shard: the
            # fallback's buffers hold the decayed table whatever the flag
            take = tb.overflow if step.ok is None else tb.overflow & step.ok
            for live, dense in ((tb.w, wd), (tb.m, md), (tb.v, vd)):
                live.copy_(torch.where(take, dense, live))
            tb.last_step.copy_(torch.where(take, t.to(torch.int32),
                                           tb.last_step))
    return depth


def can_overflow(plan: RowShardPlan, batch: int, capacity: int) -> bool:
    """Whether a shard's slot set of ``capacity`` can overflow on a global
    batch of ``batch`` ids (statically: the capacity is below the exact
    default)."""
    return capacity < min(batch, plan.rows_per_shard)

