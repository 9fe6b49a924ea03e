"""Hot/cold two-tier embedding placement for streaming online training.

A port of ``repro.embed.hotcold``. A fixed-capacity working set of *hot*
rows a field (the Zipf head that appears in nearly every batch) sits
beside the full tables, the cold tier; admission and eviction follow the
per-id batch frequencies. Residency never changes the math: a row is the
triple ``(w, m, v)`` plus the ``last_step`` it was last touched at, and
the closed-form lazy-decay catch-up replays its pending decay on its next
touch wherever it lives. Eviction writes back the *raw* row and its
``last_step``, so runs at different capacities give the same params bit
for bit.

Each step runs the reference's order:

1. dedup each field's ids (``ctr.unique_batch``);
2. residency: ``slot_of[uid]``;
3. assembly of each unique row from the hot tier (hit) or the cold table
   (miss), with plain index ops;
4. catch-up through ``t - 1``, then 5. forward and backward on the rows
   and 6. CowClip and coupled-L2 Adam: the sparse placement's two grouped
   kernels, one launch each a step over all the assembled tables
   (``kernels.cowclip.sparse_gather_catchup_tables`` with each slot's own
   row as its id, ``sparse_update_scatter_tables`` into the fresh half of
   each table's candidate bank), and the port's embedding backward through
   ``lookup_rows`` on the dedups' plan;
7. frequency update (a multiply, then an ``index_add_``: the host planner
   of the async path rounds alike);
8. top-C re-rank over {untouched residents} U {touched ids} by (freq
   desc, id asc): one ``topk`` of distinct int64 keys ``(prio_bits << 32)
   | (2**31 - 1 - id)`` a field, whose C-th value is the threshold;
9. one gather of the candidate bank (raw resident rows, then fresh rows)
   into the new hot tier;
10. raw write-back of every dropped candidate to the cold tables.

The step reads nothing on the host and keeps fixed shapes, so the scan
engine captures it as a CUDA graph like every other placement. Where the
reference compacts with ``nonzero(size=...)`` the port uses cumulative
positions and a scatter into a buffer with one sink slot; where it
scatters in drop mode the port points each pad at a real write of the same
value (``_put_rows``), so duplicate indices stay deterministic.

Slot order is ascending candidate position, as the reference's; an empty
slot holds id ``vocab`` and a copy of bank row 0 (the reference's holds
its last bank row: never read, since assembly and flush route through the
id sentinels).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import builders
from ..core.builders import StepFn, dense_tower_tx, write_back
from ..core.optim import apply_updates, counter, decay_catchup_rows
from ..core.tree import tree_leaves, tree_map
from ..models import ctr

__all__ = ["make_hotcold_train_step", "make_migrate_device_step",
           "hot_tier_bytes", "residency_map_bytes", "resident_ids",
           "admission_alpha", "ADMISSIONS"]

ADMISSIONS = ("cumulative", "decayed")


def admission_alpha(admission: str, half_life: int):
    """Per-step frequency decay factor for the admission policy: ``None``
    for cumulative counts, else the f32 ``0.5 ** (1 / half_life)`` both
    the device step and the host planner multiply in before each batch's
    counts (f32 so the two sides stay bitwise in agreement)."""
    if admission not in ADMISSIONS:
        raise ValueError(f"unknown admission policy {admission!r}; "
                         f"expected one of {ADMISSIONS}")
    if admission == "cumulative":
        return None
    if half_life < 1:
        raise ValueError(f"decayed admission needs --half-life >= 1, "
                         f"got {half_life}")
    return np.float32(0.5 ** (1.0 / float(half_life)))


def _top_c_mask(prio, ids, valid, c: int):
    """Exact top-``c`` candidate mask under (priority desc, id asc).

    ``prio`` holds non-negative f32 priorities (bit order is value order
    there) and valid ``ids`` are distinct, so the int64 keys ``(prio_bits
    << 32) | (2**31 - 1 - id)`` are distinct and their order is the
    reference's strict total order; an invalid candidate keys -1, below
    every valid one. The ``c``-th largest key (``topk``'s values, which
    are deterministic whatever its order among ties) is the threshold:
    the mask selects exactly ``min(c, n_valid)`` candidates."""
    bits = prio.view(torch.int32).to(torch.int64)
    key = (bits << 32) | (2**31 - 1 - ids.to(torch.int64))
    key = torch.where(valid, key, -1)
    thr = torch.topk(key, c).values[c - 1:]
    return valid & (key >= thr)


def _compact(mask, size: int):
    """The positions of ``mask``'s True entries, ascending, in a ``[size]``
    int64 tensor padded with ``len(mask)``: ``nonzero(size=..., fill_value=
    len(mask))`` without a host read (at most ``size`` entries are True).
    Cumulative positions and one scatter into a buffer whose slot
    ``size`` is a sink for the False entries (read by nothing)."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    dest = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), n, dtype=torch.int64, device=mask.device)
    out.scatter_(0, dest, torch.arange(n, device=mask.device))
    return out[:size]


def _put_rows(table, idx, rows, limit: int, ok=None):
    """``table[idx[j]] = rows[j]`` for every ``idx[j] < limit``, the
    reference's drop-mode scatter, with ``idx`` a compacted list (its
    entries below ``limit`` first). Each pad is pointed at a real write of
    the same value, the first entry's, or with no real entry at row 0
    rewritten with its own value, so the duplicates ``index_copy_`` sees
    carry equal values and the result is deterministic. Under a guard's
    flag ``ok`` (a 0-dim bool tensor) each row written is
    ``torch.where(ok, row, table's own row)``: a skipped step rewrites
    every row it touches with its own value."""
    idx = idx.to(torch.int64)
    valid = idx < limit
    first = valid[:1]
    safe_idx = torch.where(valid, idx, torch.where(first, idx[:1], 0))
    shape = (-1,) + (1,) * (rows.dim() - 1)
    safe_rows = torch.where(valid.reshape(shape), rows,
                            torch.where(first.reshape(shape), rows[:1],
                                        table[:1])).to(table.dtype)
    if ok is not None:
        safe_rows = torch.where(ok, safe_rows, table[safe_idx])
    table.index_copy_(0, safe_idx, safe_rows)


def _field_caps(vocab_sizes, capacity: int) -> dict:
    """Per-field hot-tier capacity: ``min(capacity, vocab_f)``."""
    if capacity < 1:
        raise ValueError(f"hot capacity must be >= 1, got {capacity}")
    return {f"field_{i}": min(capacity, v)
            for i, v in enumerate(vocab_sizes)}


def resident_ids(state) -> dict:
    """Per-field int32 arrays of currently hot ids (sentinel-free). A slot
    is occupied iff its id indexes a real table row."""
    out = {}
    for f, sid in state["hot"]["slot_ids"].items():
        s = sid.cpu().numpy()
        out[f] = s[s < state["hot"]["slot_of"][f].shape[0]]
    return out


_RESIDENCY_MAP_KEYS = ("slot_of", "freq")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def hot_tier_bytes(state) -> int:
    """Bytes of the O(capacity) device-resident working set: hot rows (w,
    m, v, ls) plus the per-slot id map. The O(vocab) residency/frequency
    maps are reported apart (``residency_map_bytes``), and the cold tables
    (params["embed"], state m/v/last_step) are counted by neither."""
    return sum(_nbytes(sub) for k, sub in state["hot"].items()
               if k not in _RESIDENCY_MAP_KEYS)


def residency_map_bytes(state) -> int:
    """Bytes of the O(vocab) residency/frequency maps (``slot_of``,
    ``freq``): on the card in the synchronous step, host-resident in the
    async migration path."""
    return sum(_nbytes(state["hot"].get(k, {})) for k in _RESIDENCY_MAP_KEYS)


def _identity_slots(uniq: dict) -> dict:
    """Each field's slot ids ``0 .. U-1``: the assembled rows are tables of
    their own, each slot's row at its slot."""
    return {f: torch.arange(u.capacity, dtype=torch.int32,
                            device=u.uids.device) for f, u in uniq.items()}


def _row_math(cfg, uniq, assembled, dense_params, batch, scalars, banks, *,
              adam_kw, r, zeta, clip, guard=False):
    """Steps 4-6 of the module docstring, shared by the synchronous step
    and the async device step. ``assembled[g][f] = (w, m, v, ls)`` holds
    each field's ``[U, d]`` rows and ``[U]`` last steps, ``banks[g][f] =
    (w, m, v, ls)`` its candidate banks. One grouped
    catch-up launch over every assembled table, the forward and backward
    on the caught-up rows (the embedding backward on the dedups' plan),
    one grouped update launch writing ``w, m, v`` and ``last_step = t`` of
    every real slot into its row of the bank's fresh half (its last ``U``
    rows). With ``guard`` the update reads the non-finite guard's flag
    (the loss is finite) from its step block and writes nothing when it
    is False. Returns ``(loss, dense grads, catch-up depth, flag)``, the
    flag None unguarded."""
    from ..kernels.cowclip import (sparse_gather_catchup_tables,
                                   sparse_update_scatter_tables,
                                   step_scalars)
    from ..train import metrics

    ident = _identity_slots(uniq)
    order = [(g, f) for g in assembled for f in assembled[g]]
    caught, depth = sparse_gather_catchup_tables(
        *([assembled[g][f][i] for g, f in order] for i in range(4)),
        [ident[f] for _, f in order], [uniq[f].counts for _, f in order],
        scalars, **adam_kw)
    rows = {g: {} for g in assembled}
    for (g, f), (wr, _, _) in zip(order, caught):
        rows[g][f] = wr.requires_grad_()
    dense_view = tree_map(lambda p: p.detach().requires_grad_(),
                          dense_params)
    with torch.enable_grad():
        logits = ctr.apply_rows(rows, dense_view, cfg, uniq, batch["dense"])
        loss = metrics.logloss(logits, batch["labels"])
    ok = None
    if guard:
        ok = builders.nonfinite_guard(loss.detach())
        scalars = step_scalars(scalars.step, b1=adam_kw["b1"],
                               b2=adam_kw["b2"], ok=ok)
    w_rows = [c[0] for c in caught]
    leaves = w_rows + tree_leaves(dense_view)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    sparse_update_scatter_tables(
        *([_fresh(banks[g][f][i], uniq[f].capacity) for g, f in order]
          for i in range(4)),
        [ident[f] for _, f in order], [uniq[f].counts for _, f in order],
        [wr.detach() for wr in w_rows], [grads[id(wr)] for wr in w_rows],
        [c[1] for c in caught], [c[2] for c in caught], scalars, r=r,
        zeta=zeta, clip=clip, **adam_kw)
    g_dense = tree_map(lambda p: grads[id(p)], dense_view)
    return loss.detach(), g_dense, depth, ok


def _fresh(bank, n: int):
    """The fresh half of a candidate bank: its last ``n`` rows (a
    contiguous view, the table the update kernel writes)."""
    return bank[bank.shape[0] - n:]


def _bank(hot_rows, fresh: int):
    """A candidate bank: ``hot_rows`` (the resident rows) followed by
    ``fresh`` rows for the update kernel to fill."""
    bank = torch.empty((hot_rows.shape[0] + fresh,) + hot_rows.shape[1:],
                       dtype=hot_rows.dtype, device=hot_rows.device)
    bank[:hot_rows.shape[0]].copy_(hot_rows)
    return bank


def _update_dense(dense_params, dense_opt, g_dense, dense_tx, ok=None):
    d_updates, d_state = dense_tx.update(g_dense, dense_opt, dense_params)
    write_back(dense_params, apply_updates(dense_params, d_updates), ok)
    write_back(dense_opt, d_state, ok)


def make_hotcold_train_step(cfg: ctr.CTRConfig, hp, *, capacity: int = 4096,
                            r: float = 1.0, zeta: float = 1e-5,
                            dense_tx=None, clip: bool = True,
                            b1: float = 0.9, b2: float = 0.999,
                            eps: float = 1e-8,
                            admission: str = "cumulative",
                            half_life: int = 0,
                            nonfinite_guard: bool = False):
    """Build the hotcold placement's ``(step, init, flush)``.

    Per step, each field's batch ids are deduplicated once; every unique
    row is assembled from the hot tier (residency hit) or the cold table
    (miss), caught up through ``t - 1`` in closed form and updated in the
    sparse reference's op order (CowClip -> coupled-L2 Adam) by the two
    grouped sparse kernels. The hot set is then re-ranked by frequency
    over {untouched residents} U {touched ids} and rebuilt with one gather
    from the candidate bank (raw resident rows + the just-updated touched
    rows); every candidate that did not make the cut is written back raw
    (w, m, v, last_step) to the cold tables. Everything is updated in
    place and nothing is read on the host. ``flush`` reconciles both tiers
    and settles all pending decay (idempotent); residency and frequencies
    survive it.

    ``nonfinite_guard`` skips the whole update when the batch loss is
    NaN/Inf, counted in ``aux["skipped_steps"]``, as the reference's
    where-select of every leaf does: the update kernel reads the flag from
    its step block and writes nothing, and every later write of the step
    is selected on the flag on the card (the frequency update multiplies
    by 1 and adds 0, the slot maps, the hot tier, the cold write-backs,
    the dense tower and the step counter rewrite their own values), so a
    skipped step leaves every leaf bitwise as it was, and a clean one
    writes the unguarded step's values bit for bit, with no host read.
    """
    from ..kernels.cowclip import step_scalars

    if dense_tx is None:
        dense_tx = dense_tower_tx(hp)
    adam_kw = dict(lr=hp.emb_lr, l2=hp.emb_l2, b1=b1, b2=b2, eps=eps)
    caps = _field_caps(cfg.vocab_sizes, capacity)
    vocab_of = {f"field_{i}": v for i, v in enumerate(cfg.vocab_sizes)}
    alpha = admission_alpha(admission, half_life)

    def init(params):
        embed = params["embed"]
        dev = tree_leaves(embed)[0].device

        def per_table(make):
            return {g: {f: make(f, t) for f, t in tables.items()}
                    for g, tables in embed.items()}

        hot = {
            "w": per_table(lambda f, t: torch.zeros(
                (caps[f], t.shape[1]), dtype=t.dtype, device=dev)),
            "m": per_table(lambda f, t: torch.zeros(
                (caps[f], t.shape[1]), device=dev)),
            "v": per_table(lambda f, t: torch.zeros(
                (caps[f], t.shape[1]), device=dev)),
            "ls": per_table(lambda f, t: torch.zeros(
                (caps[f],), dtype=torch.int32, device=dev)),
            # slot_ids: the id resident in each slot (vocab = empty);
            # slot_of: id -> slot (-1 = cold); freq: batch frequencies
            "slot_ids": {f: torch.full((caps[f],), v, dtype=torch.int32,
                                       device=dev)
                         for f, v in vocab_of.items()},
            "slot_of": {f: torch.full((v,), -1, dtype=torch.int32,
                                      device=dev)
                        for f, v in vocab_of.items()},
            "freq": {f: torch.zeros((v,), device=dev)
                     for f, v in vocab_of.items()},
        }
        return {
            "step": counter(params),
            "m": tree_map(torch.zeros_like, embed),
            "v": tree_map(torch.zeros_like, embed),
            "last_step": tree_map(lambda t: torch.zeros(
                (t.shape[0],), dtype=torch.int32, device=dev), embed),
            "hot": hot,
            "dense": dense_tx.init(params["dense"]),
        }

    def step_impl(params, state, batch):
        t = state["step"] + 1
        scalars = step_scalars(t, b1=b1, b2=b2)
        uniq = ctr.unique_batch(cfg, batch["ids"])
        hot = state["hot"]
        embed = params["embed"]
        groups = list(embed)

        # residency and assembly of each unique row from its tier
        res, assembled = {}, {g: {} for g in groups}
        with torch.no_grad():
            for f, u in uniq.items():
                uid_c = torch.clamp_max(u.uids, vocab_of[f] - 1).long()
                slot = hot["slot_of"][f][uid_c]
                touched = u.counts > 0
                hit = touched & (slot >= 0)
                src = torch.clamp_min(slot, 0).long()
                # hits point their cold lookup at row 0
                uid_cold = torch.where(hit, 0, uid_c)
                res[f] = (uid_c, touched, hit, src)
                h2 = hit[:, None]
                for g in groups:
                    assembled[g][f] = (
                        torch.where(h2, hot["w"][g][f][src],
                                    embed[g][f][uid_cold]).float(),
                        torch.where(h2, hot["m"][g][f][src],
                                    state["m"][g][f][uid_cold]),
                        torch.where(h2, hot["v"][g][f][src],
                                    state["v"][g][f][uid_cold]),
                        torch.where(hit, hot["ls"][g][f][src],
                                    state["last_step"][g][f][uid_cold]))
            banks = {g: {f: tuple(_bank(hot[k][g][f], u.capacity)
                                  for k in ("w", "m", "v", "ls"))
                         for f, u in uniq.items()} for g in groups}

        loss, g_dense, depth, ok = _row_math(
            cfg, uniq, assembled, params["dense"], batch, scalars, banks,
            adam_kw=adam_kw, r=r, zeta=zeta, clip=clip,
            guard=nonfinite_guard)

        hits_w = torch.zeros((), device=t.device)
        total_w = torch.zeros((), device=t.device)
        evictions = torch.zeros((), dtype=torch.int32, device=t.device)
        with torch.no_grad():
            for f, u in uniq.items():
                V, C = vocab_of[f], caps[f]
                uid_c, touched, hit, src = res[f]

                # frequency: a multiply, then the batch's counts (pads add
                # 0.0 at row V - 1, which changes nothing)
                freq = hot["freq"][f]
                if alpha is not None:
                    freq.mul_(float(alpha) if ok is None
                              else torch.where(ok, float(alpha), 1.0))
                freq.index_add_(0, uid_c, u.counts if ok is None
                                else torch.where(ok, u.counts, 0.0))
                hits_w += torch.where(hit, u.counts, 0.0).sum()
                total_w += u.counts.sum()

                # re-rank {untouched residents} U {touched ids}; a touched
                # resident competes through its fresh row only
                tslot = torch.zeros(C + 1, dtype=torch.bool,
                                    device=t.device).index_fill_(
                    0, torch.where(hit, src, C), True)[:C]
                res_cand = torch.where(tslot, V, hot["slot_ids"][f])
                fresh_ids = torch.where(touched, u.uids, V)
                cand = torch.cat([res_cand, fresh_ids])
                n_cand = cand.shape[0]
                valid = cand < V
                prio = torch.where(valid, freq[torch.clamp_max(
                    cand, V - 1).long()], 0.0)
                kept = _top_c_mask(prio, cand, valid, C)
                sel = _compact(kept, C)
                sel_c = torch.where(sel < n_cand, sel, 0)
                slot_ids2 = torch.where(sel < n_cand, cand[sel_c], V)
                wb = valid & ~kept          # evicted or never admitted
                wb_idx = _compact(wb, u.capacity)
                wb_c = torch.where(wb_idx < n_cand, wb_idx, 0)
                wb_loc = torch.where(wb_idx < n_cand, cand[wb_c], V)
                evictions += wb[:C].sum(dtype=torch.int32)
                evictions += (wb[C:] & hit).sum(dtype=torch.int32)

                # slot_of: the old residents out, then the new ones in
                so = hot["slot_of"][f]
                _put_rows(so, hot["slot_ids"][f],
                          torch.full((C,), -1, dtype=so.dtype,
                                     device=so.device), V, ok)
                _put_rows(so, slot_ids2,
                          torch.arange(C, dtype=so.dtype, device=so.device),
                          V, ok)
                write_back(hot["slot_ids"][f], slot_ids2, ok)

                for g in groups:
                    bank = dict(zip(("w", "m", "v", "ls"), banks[g][f]))
                    cold = {"w": embed[g][f], "m": state["m"][g][f],
                            "v": state["v"][g][f],
                            "ls": state["last_step"][g][f]}
                    for k in ("w", "m", "v", "ls"):
                        # the new hot tier: one gather of the bank; every
                        # dropped candidate back raw to the cold tier
                        write_back(hot[k][g][f], bank[k][sel_c], ok)
                        _put_rows(cold[k], wb_loc, bank[k][wb_c], V, ok)

            _update_dense(params["dense"], state["dense"], g_dense,
                          dense_tx, ok)
            write_back(state["step"], t, ok)
        aux = {"loss": loss, "catchup_depth_max": depth,
               "hot_hit_rows": hits_w, "hot_lookup_rows": total_w,
               "evictions": evictions}
        if nonfinite_guard:
            aux["skipped_steps"] = builders.skipped(ok)
        return params, state, aux

    def flush(params, state):
        """Reconcile tiers and settle all pending decay, in place: scatter
        every resident row home, catch the full tables up through
        ``step``, and re-gather the hot tier from the settled tables.
        Residency, frequencies and slot maps survive. Bit-exactly
        idempotent: a second flush scatters the values it just gathered
        and replays zero decay steps."""
        hot, step = state["hot"], state["step"]
        with torch.no_grad():
            for g, tables in params["embed"].items():
                for f, w in tables.items():
                    sid = hot["slot_ids"][f]
                    cold = (w, state["m"][g][f], state["v"][g][f],
                            state["last_step"][g][f])
                    for k, table in zip(("w", "m", "v", "ls"), cold):
                        _put_rows(table, sid, hot[k][g][f], vocab_of[f])
                    w.copy_(decay_catchup_rows(*cold, step, **adam_kw)[0])
                    cold[3].copy_(step.expand_as(cold[3]))
                    sid_c = torch.clamp_max(sid, vocab_of[f] - 1).long()
                    for k, table in zip(("w", "m", "v"), cold):
                        hot[k][g][f].copy_(table[sid_c])
                    hot["ls"][g][f].copy_(step.expand_as(hot["ls"][g][f]))
        return params, state

    return StepFn(step_impl), init, flush


def make_migrate_device_step(cfg: ctr.CTRConfig, hp, *, r: float = 1.0,
                             zeta: float = 1e-5, dense_tx=None,
                             clip: bool = True, b1: float = 0.9,
                             b2: float = 0.999, eps: float = 1e-8):
    """The device half of the async migration split (``embed/migrate``).

    The synchronous step above resolves residency on the card: it carries
    the O(vocab) ``slot_of``/``freq`` maps and the full cold tables, ranks
    admission and gathers and scatters the cold tier inside the step.
    This step takes every one of those decisions as a **fixed-shape
    input** computed by the host-side ``MigrationPlanner`` one step ahead:
    per field, ``hit``/``src``/``ls`` describe the assembly, ``miss_{w,m,
    v}`` are the pre-gathered cold rows, and ``sel``/``wb`` are the
    bank-gather indices for the new hot tier and the eviction banks. What
    remains on the card is the math whose values matter -- assembly
    select, the two grouped sparse kernels around the forward and
    backward, the bank gathers -- in the *same op order* as the
    synchronous step, so the two give bitwise-identical rows.

    Signature: ``step(dense_params, dense_opt, hot, batch, plan) -> (evict,
    aux)``: ``hot = {"w"|"m"|"v": {group: {field: [C, d]}}}`` (no ls, no
    maps -- those are host state) and the dense tower updated in place;
    ``plan`` the device views of a ``migrate.StepPlan`` (``t`` a 0-dim
    int32 tensor); ``evict`` ``{group: [3, sum U, d]}``, each field's raw
    ``w, m, v`` eviction rows at its offset in the plan's layout, the
    banks the planner's store-buffer waits for.
    """
    from ..kernels.cowclip import step_scalars

    if dense_tx is None:
        dense_tx = dense_tower_tx(hp)
    adam_kw = dict(lr=hp.emb_lr, l2=hp.emb_l2, b1=b1, b2=b2, eps=eps)

    def step(dense_params, dense_opt, hot, batch, plan):
        scalars = step_scalars(plan["t"], b1=b1, b2=b2)
        uniq = ctr.unique_batch(cfg, batch["ids"])
        groups = list(hot["w"])
        assembled = {g: {} for g in groups}
        with torch.no_grad():
            for f in uniq:
                h2 = plan["hit"][f][:, None]
                src = plan["src"][f]
                for g in groups:
                    assembled[g][f] = tuple(
                        torch.where(h2, hot[k][g][f][src],
                                    plan[f"miss_{k}"][g][f])
                        for k in ("w", "m", "v")) + (plan["ls"][f],)
            banks = {g: {f: tuple(_bank(hot[k][g][f], u.capacity)
                                  for k in ("w", "m", "v"))
                         + (torch.empty(u.capacity, dtype=torch.int32,
                                        device=u.uids.device),)
                         for f, u in uniq.items()} for g in groups}

        loss, g_dense, _, _ = _row_math(
            cfg, uniq, assembled, dense_params, batch, scalars, banks,
            adam_kw=adam_kw, r=r, zeta=zeta, clip=clip)

        with torch.no_grad():
            evict = {}
            for g in groups:
                dim = hot["w"][g][next(iter(uniq))].shape[1]
                evict[g] = torch.empty(
                    (3, sum(u.capacity for u in uniq.values()), dim),
                    device=loss.device)
                off = 0
                for f, u in uniq.items():
                    for i, k in enumerate(("w", "m", "v")):
                        bank = banks[g][f][i]
                        hot[k][g][f].copy_(bank[plan["sel"][f]])
                        torch.index_select(
                            bank, 0, plan["wb"][f],
                            out=evict[g][i, off:off + u.capacity])
                    off += u.capacity
            _update_dense(dense_params, dense_opt, g_dense, dense_tx)
        return evict, {"loss": loss}

    return step
