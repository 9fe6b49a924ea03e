"""CTR training loop: the fused and sparse train steps, epochs, eval.

A port of the fused and sparse placements of ``repro.train.loop``. Steps
run eagerly (there is no jit); ``engine="scan"`` and ``mode="stream"`` are
not ported yet and raise, naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.builders import StepFn, dense_tower_tx
from ..core.device import resolve_device
from ..core.optim import apply_updates, decay_catchup_rows
from ..core.tree import tree_leaves, tree_map
from ..data.synthetic import CTRDataset, iterate_batches
from ..models import ctr
from . import metrics


def _loss_and_grads(params, cfg, batch):
    """Task loss and its gradient w.r.t. every param leaf, as a tree.

    The params themselves never require grad (the kernel updates them in
    place); the graph is built over detached aliases of them."""
    view = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        logits = ctr.apply(view, cfg, batch["ids"], batch["dense"])
        loss = metrics.logloss(logits, batch["labels"])
    grads = iter(torch.autograd.grad(loss, tree_leaves(view)))
    return loss.detach(), tree_map(lambda _: next(grads), view)


def make_fused_train_step(cfg: ctr.CTRConfig, hp, *, r: float = 1.0,
                          zeta: float = 1e-5, dense_tx=None,
                          nonfinite_guard: bool = False):
    """Train step that runs every embedding table through the fused
    CowClip + coupled-L2 + Adam update (``repro_torch.kernels.cowclip``:
    the CUDA kernel on the card, its plain version on the CPU). The dense
    tower goes through ``dense_tx``. State: ``{"step", "m", "v", "dense"}``
    with ``m``/``v`` trees shaped like ``params["embed"]``.

    The embedding tables and their moments are updated in place; the dense
    tower is replaced. Returns ``(step, init)``.

    ``nonfinite_guard`` skips the whole update (params, moments and step
    counter) when the batch loss is NaN/Inf, reported as
    ``aux["skipped_steps"]``; it reads the loss on the host every step.
    """
    from ..kernels.cowclip import fused_cowclip_adam

    if dense_tx is None:
        dense_tx = dense_tower_tx(hp)

    def init(params):
        return {
            "step": 0,
            "m": tree_map(torch.zeros_like, params["embed"]),
            "v": tree_map(torch.zeros_like, params["embed"]),
            "dense": dense_tx.init(params["dense"]),
        }

    def step_impl(params, state, batch):
        loss, grads = _loss_and_grads(params, cfg, batch)
        if nonfinite_guard and not bool(torch.isfinite(loss)):
            return params, state, {"loss": loss, "skipped_steps": 1}
        counts = ctr.batch_counts(cfg, batch["ids"], params)
        t = state["step"] + 1

        # 1-dim LR tables are CowClip-exempt but share the kernel (the
        # kernel itself skips clipping when dim < 2).
        tree_map(
            lambda w, g, c, m, v: fused_cowclip_adam(
                w, g, c, m, v, t, r=r, zeta=zeta, lr=hp.emb_lr,
                l2=hp.emb_l2),
            params["embed"], grads["embed"], counts, state["m"], state["v"])

        d_updates, d_state = dense_tx.update(
            grads["dense"], state["dense"], params["dense"])
        new_dense = apply_updates(params["dense"], d_updates)
        new_state = dict(state, step=t, dense=d_state)
        aux = {"loss": loss}
        if nonfinite_guard:
            aux["skipped_steps"] = 0
        return {"embed": params["embed"], "dense": new_dense}, new_state, aux

    return StepFn(step_impl), init


def _uniq_tree(embed_params: dict, uniq: dict) -> dict:
    """The per-field dedup broadcast over every embedding group (the fm and
    lin tables of a field share ids, hence slots and counts)."""
    return {g: {f: uniq[f] for f in tables}
            for g, tables in embed_params.items()}


def _tables(params, state, utree):
    """``(group, field, u, w, m, v, last_step)`` for every embedding
    table, in the order of ``params["embed"]``."""
    for g, tables in params["embed"].items():
        for f, w in tables.items():
            yield (g, f, utree[g][f], w, state["m"][g][f], state["v"][g][f],
                   state["last_step"][g][f])


def make_sparse_train_step(cfg: ctr.CTRConfig, hp, *, r: float = 1.0,
                           zeta: float = 1e-5, dense_tx=None,
                           clip: bool = True, b1: float = 0.9,
                           b2: float = 0.999, eps: float = 1e-8,
                           nonfinite_guard: bool = False):
    """The sparse unique-id train step. Each field's batch ids are
    deduplicated once, and the embedding update runs on the ``[n_unique,
    dim]`` slot rows: gather + lazy-decay catch-up (the
    ``sparse_gather_catchup`` kernel) -> forward/backward on the rows ->
    CowClip -> coupled L2 -> Adam -> scatter (``sparse_update_scatter``).
    Each kernel is one launch a step over every table. Update traffic is
    O(batch), not O(vocab).

    Ids absent from a batch are not touched: their coupled-L2 decay accrues
    in a per-row ``last_step`` and is applied on their next touch or by
    ``flush``, which keeps the path equivalent to the dense one. The tables,
    moments and ``last_step`` are updated in place.

    ``aux["catchup_depth_max"]`` is the deepest pending decay among this
    step's touched rows (0 when every one of them was in the last batch),
    a 0-dim int32 tensor on the params' device, computed by the catch-up
    kernel as it applies the decay. ``nonfinite_guard`` skips the whole
    update when the batch loss is NaN/Inf, as the fused step's does.

    Returns ``(step, init, flush)``; ``flush(params, state)`` applies all
    pending decay (needed before eval, checkpoint or comparing against the
    dense path).
    """
    from ..kernels.cowclip import (sparse_gather_catchup_tables,
                                   sparse_update_scatter_tables)

    if dense_tx is None:
        dense_tx = dense_tower_tx(hp)
    adam_kw = dict(lr=hp.emb_lr, l2=hp.emb_l2, b1=b1, b2=b2, eps=eps)

    def init(params):
        return {
            "step": 0,
            "m": tree_map(torch.zeros_like, params["embed"]),
            "v": tree_map(torch.zeros_like, params["embed"]),
            "last_step": tree_map(
                lambda t: torch.zeros((t.shape[0],), dtype=torch.int32,
                                      device=t.device), params["embed"]),
            "dense": dense_tx.init(params["dense"]),
        }

    def step_impl(params, state, batch):
        t = state["step"] + 1
        uniq = ctr.unique_batch(cfg, batch["ids"])
        utree = _uniq_tree(params["embed"], uniq)
        tables = list(_tables(params, state, utree))
        ws, ms, vs, lss = ([tb[i] for tb in tables] for i in range(3, 7))
        uids = [tb[2].uids for tb in tables]
        counts = [tb[2].counts for tb in tables]

        # gather + pending decay, so the forward sees the rows exactly as
        # the dense path would at step t; one launch for every table, which
        # also gives the deepest pending catch-up among the real slots
        caught, depth = sparse_gather_catchup_tables(
            ws, ms, vs, lss, uids, counts, t, **adam_kw)
        rows = {g: {} for g in params["embed"]}
        for (g, f, *_), (wr, _, _) in zip(tables, caught):
            rows[g][f] = wr.requires_grad_()

        dense_view = tree_map(lambda p: p.detach().requires_grad_(),
                              params["dense"])
        with torch.enable_grad():
            logits = ctr.apply_rows(rows, dense_view, cfg, uniq,
                                    batch["dense"])
            loss = metrics.logloss(logits, batch["labels"])
        aux = {"loss": loss.detach(), "catchup_depth_max": depth}
        if nonfinite_guard:
            if not bool(torch.isfinite(loss)):
                return params, state, dict(aux, skipped_steps=1)
            aux["skipped_steps"] = 0
        w_rows = [c[0] for c in caught]
        leaves = w_rows + tree_leaves(dense_view)
        grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))

        # CowClip -> coupled L2 -> Adam on the touched rows, scattered back
        # in one launch; untouched rows keep accruing lazy decay through
        # last_step
        sparse_update_scatter_tables(
            ws, ms, vs, lss, uids, counts, [wr.detach() for wr in w_rows],
            [grads[id(wr)] for wr in w_rows], [c[1] for c in caught],
            [c[2] for c in caught], t, r=r, zeta=zeta, clip=clip, **adam_kw)

        g_dense = tree_map(lambda p: grads[id(p)], dense_view)
        d_updates, d_state = dense_tx.update(
            g_dense, state["dense"], params["dense"])
        new_dense = apply_updates(params["dense"], d_updates)
        new_state = dict(state, step=t, dense=d_state)
        return {"embed": params["embed"], "dense": new_dense}, new_state, aux

    return StepFn(step_impl), init, _make_lazy_flush(adam_kw)


def _make_lazy_flush(adam_kw: dict):
    """The flush of a lazy-decay placement: apply each row's pending
    decay-only steps through the current step, in place, then stamp
    ``last_step = step`` everywhere. Idempotent: a second call multiplies
    every row by exactly 1.0."""

    def flush(params, state):
        step = state["step"]
        with torch.no_grad():
            for g, tables in params["embed"].items():
                for f, w in tables.items():
                    ls = state["last_step"][g][f]
                    caught, _, _ = decay_catchup_rows(
                        w, state["m"][g][f], state["v"][g][f], ls, step,
                        **adam_kw)
                    w.copy_(caught)
                    ls.fill_(step)
        return params, state

    return flush


def make_eval_fn(cfg: ctr.CTRConfig):
    """Batched evaluation through the serving engine's fixed-shape
    ``padded_score_loop``; returns auc, logloss and ``eval_rows_per_sec``
    (scored rows over the wall-clock of the scoring loop)."""
    from ..serve import engine as serve_engine

    logits_fn = serve_engine.make_logits_fn(cfg)

    def evaluate(params, ds: CTRDataset, batch_size: int = 8192) -> dict:
        n = len(ds)
        t0 = time.perf_counter()
        scores = serve_engine.padded_score_loop(
            logits_fn, params, ds.ids, ds.dense, batch_size)
        seconds = time.perf_counter() - t0
        labels = ds.labels
        ll = float(np.mean(np.logaddexp(0.0, scores) - labels * scores))
        return {"auc": metrics.auc_numpy(scores, labels), "logloss": ll,
                "eval_rows_per_sec": n / max(seconds, 1e-9)}

    evaluate.logits_fn = logits_fn
    return evaluate


@dataclasses.dataclass
class TrainResult:
    history: list
    final_eval: dict
    seconds: float
    steps: int
    params: object = None
    opt_state: object = None
    # per-step batch loss (kept on the device during an epoch and read once
    # after its last step) and seconds. On the card a step's seconds are
    # the device stream's time from a CUDA event recorded just before the
    # step's batch copy to one just after the step: its device work plus
    # any time the card waited within it for the host to queue the work.
    # On the CPU they are the host clock around the step.
    losses: list = dataclasses.field(default_factory=list)
    step_seconds: list = dataclasses.field(default_factory=list)


class _StepClock:
    """Seconds per step of one epoch. On the card, CUDA events recorded on
    the stream before and after each step, read after the epoch (its
    losses have been read by then, so the read waits for nothing more);
    elsewhere the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        """Mark the start or the end of a step."""
        if not self.cuda:
            self.marks.append(time.perf_counter())
            return
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.marks.append(event)

    def seconds(self) -> list:
        pairs = zip(self.marks[::2], self.marks[1::2])
        if not self.cuda:
            return [b - a for a, b in pairs]
        if self.marks:
            self.marks[-1].synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in pairs]


def _to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train_ctr(
    cfg: ctr.CTRConfig,
    tx,
    train_ds: CTRDataset,
    test_ds: Optional[CTRDataset],
    *,
    batch_size: int,
    epochs: int = 1,
    seed: int = 0,
    eval_every_epoch: bool = True,
    log_fn: Optional[Callable[[str], None]] = None,
    step_bundle=None,
    max_steps: Optional[int] = None,
    engine: str = "eager",
    mode: str = "epochs",
    init_state=None,
    device="cuda",
) -> TrainResult:
    """Epoch driver over a ``core.builders.TrainStepBundle``.

    Params come from ``ctr.init(cfg, seed=seed, device=device)`` then the
    bundle's ``prepare``, or from ``init_state = (params, opt_state)``
    (already prepared; batches then go to the params' device). ``flush``
    runs before every eval. ``max_steps`` caps the total step count across
    epochs. Batches come from ``iterate_batches`` in the reference's exact
    shuffle order (seed ``seed + epoch``).

    Not ported yet: the composable-optimizer path (``tx`` without a
    bundle), ``engine="scan"`` and ``mode="stream"``.
    """
    if engine == "scan":
        raise NotImplementedError(
            "engine='scan' is not ported yet: the CUDA-graph engine is "
            "ROADMAP queue 1 item 3; use engine='eager'")
    if engine != "eager":
        raise ValueError(f"unknown engine {engine!r}")
    if mode == "stream":
        raise NotImplementedError(
            "mode='stream' is not ported yet: streaming training is ROADMAP "
            "queue 1 item 5")
    if mode != "epochs":
        raise ValueError(f"unknown mode {mode!r}")
    if step_bundle is None:
        raise NotImplementedError(
            f"training through a bare optimizer ({tx!r}) is the substrate "
            "placement, not ported yet (ROADMAP queue 1 item 4); pass a "
            "step_bundle from embed.store_for(cfg, path='fused')")

    if init_state is not None:
        params, opt_state = init_state
    else:
        params = step_bundle.prepare(
            ctr.init(cfg, seed=seed, device=resolve_device(device)))
        opt_state = step_bundle.init(params)
    dev = tree_leaves(params)[0].device
    step_fn, flush = step_bundle.step, step_bundle.flush
    eval_fn = make_eval_fn(cfg)

    history, losses, step_seconds = [], [], []
    n_steps = 0
    t0 = time.perf_counter()
    for epoch in range(epochs):
        if max_steps is not None and n_steps >= max_steps:
            break
        clock = _StepClock(dev)
        epoch_losses = []
        for b in iterate_batches(train_ds, batch_size, seed=seed + epoch):
            clock.mark()
            params, opt_state, aux = step_fn(params, opt_state,
                                             _to_device(b, dev))
            clock.mark()
            epoch_losses.append(aux["loss"])
            n_steps += 1
            if max_steps is not None and n_steps >= max_steps:
                break
        if epoch_losses:   # the epoch's one read of the device
            losses.extend(torch.stack(epoch_losses).tolist())
        step_seconds.extend(clock.seconds())
        if eval_every_epoch and test_ds is not None:
            params, opt_state = flush(params, opt_state)
            ev = eval_fn(params, test_ds)
            history.append({"epoch": epoch, **ev})
            if log_fn:
                log_fn(f"epoch {epoch}: auc={ev['auc']:.4f} "
                       f"logloss={ev['logloss']:.4f}")
    seconds = time.perf_counter() - t0
    params, opt_state = flush(params, opt_state)
    final = (history[-1] if history
             else (eval_fn(params, test_ds) if test_ds is not None else {}))
    return TrainResult(history=history, final_eval=dict(final),
                       seconds=seconds, steps=n_steps, params=params,
                       opt_state=opt_state, losses=losses,
                       step_seconds=step_seconds)
