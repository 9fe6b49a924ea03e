"""CTR training loop: the substrate, fused, sparse and sharded train
steps, epochs, eval; and the LM train step (``make_lm_train_step``, the
step of ``repro.launch.train.run_lm``) and its loop (``train_lm``).

A port of ``repro.train.loop``. Each
step reads nothing on the host and writes its params and state in place,
so it runs eagerly (``engine="eager"``) or as K steps captured into one
CUDA graph (``engine="scan"``, ``train.engine``). ``train_ctr`` trains
over epochs of a dataset or online from a stream of chunks
(``mode="stream"``, ``data.stream``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core import builders
from ..core.builders import StepFn, dense_tower_tx, skipped, write_back
from ..core.device import resolve_device
from ..core.optim import apply_updates, counter, decay_catchup_rows
from ..core.tree import _is_namedtuple, tree_leaves, tree_map
from ..data import prefetch as prefetch_lib
from ..data.synthetic import CTRDataset, iterate_batches
from ..models import ctr
from . import metrics

logger = logging.getLogger(__name__)


def _grads(params, loss_of):
    """``loss_of(view)`` and its gradient w.r.t. every param leaf, as a
    tree. The params themselves never require grad (the kernels update
    them in place); the graph is built over detached aliases of them."""
    view = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_of(view)
    grads = iter(torch.autograd.grad(loss, tree_leaves(view)))
    return loss.detach(), tree_map(lambda _: next(grads), view)


def _loss_and_grads(params, cfg, batch):
    """The CTR task loss and its gradient tree (``_grads``). With
    ``cfg.sparse`` the forward runs through the unique-id gather (the
    table gradients then come back through the gather of the unique rows),
    else through the per-field lookup; both end in the port's embedding
    backward."""

    def loss_of(view):
        if cfg.sparse:
            uniq = ctr.unique_batch(cfg, batch["ids"])
            rows = ctr.gather_embed_rows(view, uniq)
            logits = ctr.apply_rows(rows, view["dense"], cfg, uniq,
                                    batch["dense"])
        else:
            logits = ctr.apply(view, cfg, batch["ids"], batch["dense"])
        return metrics.logloss(logits, batch["labels"])

    return _grads(params, loss_of)


def make_train_step(cfg: ctr.CTRConfig, tx, *,
                    nonfinite_guard: bool = False) -> StepFn:
    """The substrate train step: the task loss's gradient (the dense
    forward, or with ``cfg.sparse`` the unique-id gather's) through the
    composable optimizer ``tx`` (``core.builders.build_optimizer``), with
    CowClip's per-id batch counts as its ``counts`` extra, then
    ``apply_updates``. Returns a ``StepFn`` over ``(params, opt_state,
    batch)`` with ``opt_state = tx.init(params)``.

    The new params and state are written back into the old tensors
    (``core.builders.write_back``), and nothing is read on the host, so the
    step is its own ``scan_step``. ``nonfinite_guard`` keeps the old values
    of every leaf when the batch loss is NaN/Inf (``torch.where`` on the
    device, as the reference's where-select), reported as
    ``aux["skipped_steps"]``."""

    def step_impl(params, opt_state, batch):
        loss, grads = _loss_and_grads(params, cfg, batch)
        ok = builders.nonfinite_guard(loss) if nonfinite_guard else None
        counts = ctr.batch_counts(cfg, batch["ids"], params)
        updates, new_state = tx.update(grads, opt_state, params,
                                       counts=counts)
        write_back(params, apply_updates(params, updates), ok)
        write_back(opt_state, new_state, ok)
        aux = {"loss": loss}
        if nonfinite_guard:
            aux["skipped_steps"] = skipped(ok)
        return params, opt_state, aux

    return StepFn(step_impl)


def _update_dense(params, state, grads, dense_tx, t, ok):
    """The dense tower's update and the step counter, written in place
    (under the guard's flag ``ok``, where-selected: a skipped step keeps
    the old values)."""
    d_updates, d_state = dense_tx.update(grads, state["dense"],
                                         params["dense"])
    write_back(params["dense"], apply_updates(params["dense"], d_updates),
               ok)
    write_back(state["dense"], d_state, ok)
    write_back(state["step"], t, ok)


def make_fused_train_step(cfg: ctr.CTRConfig, hp, *, r: float = 1.0,
                          zeta: float = 1e-5, dense_tx=None,
                          nonfinite_guard: bool = False):
    """Train step that runs every embedding table through the fused
    CowClip + coupled-L2 + Adam update (``repro_torch.kernels.cowclip``:
    the CUDA kernel on the card, its plain version on the CPU). The dense
    tower goes through ``dense_tx``. State: ``{"step", "m", "v", "dense"}``
    with ``m``/``v`` trees shaped like ``params["embed"]`` and ``step`` a
    0-dim int32 tensor on the params' device.

    Everything is updated in place (the tables and moments by the kernel,
    the dense tower, its optimizer state and the step by ``write_back``);
    the kernels read the step and its bias corrections from a block the
    step fills on the card. Nothing is read on the host, so the step is
    its own ``scan_step``. Returns ``(step, init)``.

    ``nonfinite_guard`` skips the whole update (params, moments and step
    counter) when the batch loss is NaN/Inf, reported as
    ``aux["skipped_steps"]`` (``core.builders.nonfinite_guard``).
    """
    from ..kernels.cowclip import fused_cowclip_adam, step_scalars

    if dense_tx is None:
        dense_tx = dense_tower_tx(hp)

    def init(params):
        return {
            "step": counter(params),
            "m": tree_map(torch.zeros_like, params["embed"]),
            "v": tree_map(torch.zeros_like, params["embed"]),
            "dense": dense_tx.init(params["dense"]),
        }

    def step_impl(params, state, batch):
        loss, grads = _loss_and_grads(params, cfg, batch)
        ok = builders.nonfinite_guard(loss) if nonfinite_guard else None
        counts = ctr.batch_counts(cfg, batch["ids"], params)
        t = state["step"] + 1
        scalars = step_scalars(t, ok=ok)

        # 1-dim LR tables are CowClip-exempt but share the kernel (the
        # kernel itself skips clipping when dim < 2).
        tree_map(
            lambda w, g, c, m, v: fused_cowclip_adam(
                w, g, c, m, v, scalars, r=r, zeta=zeta, lr=hp.emb_lr,
                l2=hp.emb_l2),
            params["embed"], grads["embed"], counts, state["m"], state["v"])
        _update_dense(params, state, grads["dense"], dense_tx, t, ok)
        aux = {"loss": loss}
        if nonfinite_guard:
            aux["skipped_steps"] = skipped(ok)
        return params, state, aux

    return StepFn(step_impl), init


def _leaf_paths(tree, prefix=()):
    """The key path of every leaf of a tree of dicts, in ``tree_map``'s
    order."""
    if not isinstance(tree, dict):
        yield prefix
        return
    for k, v in tree.items():
        yield from _leaf_paths(v, prefix + (k,))


def _leaf_part(tree, path):
    """What of ``tree`` belongs to the param leaf at ``path``: a dict (a
    tree shaped like the params) cut down to that one path; a tuple or
    NamedTuple (an optimizer state) with each part cut; anything else (a
    step counter) as it is."""
    if isinstance(tree, dict):
        key, *rest = path
        return {key: _leaf_part(tree[key], rest) if rest else tree[key]}
    if _is_namedtuple(tree):
        return type(tree)(*(_leaf_part(t, path) for t in tree))
    if isinstance(tree, tuple):
        return type(tree)(_leaf_part(t, path) for t in tree)
    return tree


def _split_state(tree):
    """An optimizer state as ``(its per-param trees with the counters set
    to None, the counters)``: the counters are the leaves outside dicts."""
    if isinstance(tree, dict):
        return tree, []
    if isinstance(tree, tuple):
        parts = [_split_state(t) for t in tree]
        trees = [p for p, _ in parts]
        counters = [c for _, cs in parts for c in cs]
        if _is_namedtuple(tree):
            return type(tree)(*trees), counters
        return type(tree)(trees), counters
    return None, [tree]


def update_leafwise(tx, grads, state, params, ok=None) -> None:
    """``tx.update`` of the tree ``params`` run a leaf at a time, and each
    leaf's new param and optimizer state written in place before the next
    (``write_back``, under a guard's flag ``ok``); the counters (the
    steps the chain counts) are written once, after the last leaf, so
    every leaf's call sees the step's counters as they were.

    For a chain whose transforms act leaf by leaf (``core.builders.
    dense_tower_tx``: L2, Adam, the warm-up lr) these are the tree form's
    operations in its order, so the result is the same bits; but what is
    held beside the params, their gradients and their state is one leaf's
    temporaries, not a second copy of the tree (updates, new moments, new
    params)."""
    new_state = None
    for path in _leaf_paths(params):
        p, s = _leaf_part(params, path), _leaf_part(state, path)
        updates, new_state = tx.update(_leaf_part(grads, path), s, p)
        write_back(p, apply_updates(p, updates), ok)
        write_back(_split_state(s)[0], _split_state(new_state)[0], ok)
    if new_state is not None:
        write_back(_split_state(state)[1], _split_state(new_state)[1], ok)


def make_lm_update(cfg, hp, *, r: float = 1.0, zeta: float = 1e-5,
                   warmup_steps: int = 10):
    """The LM step's update (``make_lm_train_step``'s default form) from
    given gradients: ``(update, init)``, ``update(params, state, grads,
    tokens)`` writing params and state in place. The token table goes
    through the fused CowClip + coupled-L2 + Adam update
    (``kernels.cowclip.fused_cowclip_adam``: the CUDA kernel on the card,
    its plain version on the CPU) with ``tokens``' counts
    (``models.embedding.token_counts``) as its ``cnt`` and the step's
    scalars in a block filled on the device; the dense tree through
    ``core.builders.dense_tower_tx(hp, warmup_steps=warmup_steps)``, a
    leaf at a time (``update_leafwise``). State ``{"step", "m":
    {"tokens"}, "v": {"tokens"}, "dense"}``, ``step`` a 0-dim int32
    tensor. Nothing is read on the host."""
    from ..kernels.cowclip import fused_cowclip_adam, step_scalars
    from ..models.embedding import token_counts

    dense_tx = dense_tower_tx(hp, warmup_steps=warmup_steps)

    def init(params):
        table = params["embed"]["tokens"]
        return {"step": counter(params),
                "m": {"tokens": torch.zeros_like(table)},
                "v": {"tokens": torch.zeros_like(table)},
                "dense": dense_tx.init(params["dense"])}

    def update(params, state, grads, tokens):
        t = state["step"] + 1
        fused_cowclip_adam(
            params["embed"]["tokens"], grads["embed"]["tokens"],
            token_counts(tokens, cfg.padded_vocab), state["m"]["tokens"],
            state["v"]["tokens"], step_scalars(t), r=r, zeta=zeta,
            lr=hp.emb_lr, l2=hp.emb_l2)
        update_leafwise(dense_tx, grads["dense"], state["dense"],
                        params["dense"])
        write_back(state["step"], t)

    return update, init


def make_lm_train_step(cfg, hp, *, r: float = 1.0, zeta: float = 1e-5,
                       warmup_steps: int = 10, tx=None,
                       dense_dtype: Optional[torch.dtype] = None):
    """The LM train step of ``repro.launch.train.run_lm``: the gradient of
    ``models.lm.loss_fn`` (next-token cross-entropy + the MoE aux) on a
    batch ``{"tokens": [B, S] int, "prefix": [B, P, D] or None}``, then
    the paper's two-group update with CowClip on the token table, whose
    ``cnt`` is the batch's token counts. Returns ``(step, init)``: a
    ``StepFn`` over ``(params, state, batch)`` that writes params and
    state in place and returns ``aux = {"loss"}``, the loss a 0-dim
    tensor on the params' device (nothing is read on the host), and
    ``init(params) -> state``.

    By default (the CLI's form) the update is ``make_lm_update``'s: the
    fused CowClip kernel on the token table, the dense tree a leaf at a
    time. With ``tx`` (the substrate form, for the tests) it is the
    composable optimizer (``core.builders.build_optimizer(hp,
    warmup_steps=10)``, the reference's ``tx``) over the whole tree, with
    ``counts={"tokens": ...}``, state ``tx.init``.

    ``dense_dtype`` (the dry-run's ``bf16_gather``) casts the floating
    dense leaves to that dtype before the forward, so a sharded weight is
    gathered in it; the gradients, masters and optimizer stay f32.
    """
    from ..models import lm
    from ..models.embedding import token_counts

    def cast(view):
        if dense_dtype is None:
            return view
        return {"embed": view["embed"], "dense": tree_map(
            lambda t: t.to(dense_dtype) if t.is_floating_point() else t,
            view["dense"])}

    def loss_and_grads(params, batch):
        return _grads(params, lambda view: lm.loss_fn(
            cast(view), cfg, batch["tokens"], batch.get("prefix"))[0])

    if tx is not None:
        def substrate_step(params, opt_state, batch):
            loss, grads = loss_and_grads(params, batch)
            counts = {"tokens": token_counts(batch["tokens"],
                                             cfg.padded_vocab)}
            updates, new_state = tx.update(grads, opt_state, params,
                                           counts=counts)
            write_back(params, apply_updates(params, updates))
            write_back(opt_state, new_state)
            return params, opt_state, {"loss": loss}

        return StepFn(substrate_step), tx.init

    update, init = make_lm_update(cfg, hp, r=r, zeta=zeta,
                                  warmup_steps=warmup_steps)

    def step_impl(params, state, batch):
        loss, grads = loss_and_grads(params, batch)
        update(params, state, grads, batch["tokens"])
        return params, state, {"loss": loss}

    return StepFn(step_impl), init



@dataclasses.dataclass
class LMTrainResult:
    params: dict
    state: dict
    step: StepFn           # the step the run took (``make_lm_train_step``)
    hp: object             # the scaled hyperparameters
    losses: torch.Tensor   # [steps] f32, on the params' device
    # each step's seconds: CUDA events around it on the card (its tokens
    # already copied), the host clock on the CPU
    step_seconds: list


def train_lm(cfg, *, batch: int, seq: int, steps: int, base_lr: float,
             base_l2: float, samples: int, seed: int = 0,
             device="cuda") -> LMTrainResult:
    """The loop of ``repro.launch.train.run_lm`` on one device, which the
    CLI's ``--task lm`` runs: params from ``lm.init(cfg, seed=seed)``;
    ``scale_hyperparams("cowclip", base_lr, base_l2, base_batch=1024,
    batch_size=batch * seq, base_dense_lr=2 * base_lr)``; ``steps`` steps
    of ``make_lm_train_step(cfg, hp, warmup_steps=10)`` over consecutive
    ``[batch, seq]`` slices of a Zipf stream of ``samples`` tokens
    (``make_lm_tokens(samples, vocab, seed)``, restarting at its end), and
    for a frontend a prefix a step, ``default_rng(seed).normal(scale=0.1)``
    in the compute dtype. A step's loss stays on the device except at the
    print steps (every ``steps // 10``)."""
    from ..core.scaling import scale_hyperparams
    from ..data.synthetic import make_lm_tokens
    from ..models import lm

    device = resolve_device(device)
    stream = make_lm_tokens(samples, cfg.vocab_size, seed=seed)
    n_steps_epoch = len(stream) // (seq * batch)
    params = lm.init(cfg, seed=seed, device=device)
    hp = scale_hyperparams("cowclip", base_lr=base_lr, base_l2=base_l2,
                           base_batch=1024, batch_size=batch * seq,
                           base_dense_lr=2 * base_lr)
    step, init = make_lm_train_step(cfg, hp, warmup_steps=10)
    state = init(params)

    rng = np.random.default_rng(seed)
    clock = _StepClock(device)
    losses = []
    for i in range(steps):
        off = (i % n_steps_epoch) * seq * batch
        tokens = torch.from_numpy(
            stream[off: off + seq * batch].reshape(batch, seq)).to(device)
        prefix = None
        if cfg.frontend:
            prefix = torch.from_numpy(rng.normal(
                scale=0.1, size=(batch, cfg.n_prefix, cfg.d_model))).to(
                    device=device, dtype=cfg.dtype)
        clock.start()
        params, state, aux = step(params, state,
                                  {"tokens": tokens, "prefix": prefix})
        clock.stop()
        losses.append(aux["loss"])
        if i % max(1, steps // 10) == 0:
            print(f"  step {i:4d}: loss {float(losses[-1]):.4f}")
    return LMTrainResult(params, state, step, hp, torch.stack(losses),
                         clock.seconds())

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
    ``flush``, which keeps the path equivalent to the dense one. Everything
    is updated in place, and nothing is read on the host, as in the fused
    step.

    ``aux["catchup_depth_max"]`` is the deepest pending decay among this
    step's touched rows (0 when every one of them was in the last batch),
    a 0-dim int32 tensor on the params' device, computed by the catch-up
    kernel as it applies the decay. ``nonfinite_guard`` skips the whole
    update when the batch loss is NaN/Inf, as the fused step's does (the
    update kernel writes nothing under the flag, so ``last_step`` holds).

    Returns ``(step, init, flush)``; ``flush(params, state)`` applies all
    pending decay (needed before eval, checkpoint or comparing against the
    dense path).
    """
    from ..kernels.cowclip import (sparse_gather_catchup_tables,
                                   sparse_update_scatter_tables,
                                   step_scalars)

    if dense_tx is None:
        dense_tx = dense_tower_tx(hp)
    adam_kw = dict(lr=hp.emb_lr, l2=hp.emb_l2, b1=b1, b2=b2, eps=eps)

    def init(params):
        return {
            "step": counter(params),
            "m": tree_map(torch.zeros_like, params["embed"]),
            "v": tree_map(torch.zeros_like, params["embed"]),
            "last_step": tree_map(
                lambda t: torch.zeros((t.shape[0],), dtype=torch.int32,
                                      device=t.device), params["embed"]),
            "dense": dense_tx.init(params["dense"]),
        }

    def step_impl(params, state, batch):
        t = state["step"] + 1
        scalars = step_scalars(t, b1=b1, b2=b2)
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
            ws, ms, vs, lss, uids, counts, scalars, **adam_kw)
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
        ok = None
        if nonfinite_guard:
            ok = builders.nonfinite_guard(aux["loss"])
            scalars = step_scalars(t, b1=b1, b2=b2, ok=ok)
            aux["skipped_steps"] = skipped(ok)
        w_rows = [c[0] for c in caught]
        leaves = w_rows + tree_leaves(dense_view)
        grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))

        # CowClip -> coupled L2 -> Adam on the touched rows, scattered back
        # in one launch; untouched rows keep accruing lazy decay through
        # last_step
        sparse_update_scatter_tables(
            ws, ms, vs, lss, uids, counts, [wr.detach() for wr in w_rows],
            [grads[id(wr)] for wr in w_rows], [c[1] for c in caught],
            [c[2] for c in caught], scalars, r=r, zeta=zeta, clip=clip,
            **adam_kw)

        g_dense = tree_map(lambda p: grads[id(p)], dense_view)
        _update_dense(params, state, g_dense, dense_tx, t, ok)
        return params, state, aux

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
                    ls.copy_(torch.as_tensor(step, dtype=ls.dtype))
        return params, state

    return flush


def _data_slice(batch: dict, mesh) -> dict:
    """This rank's slice of a global batch: every rank draws the same
    global batch and keeps rows ``[d * b_loc, (d + 1) * b_loc)`` at data
    coordinate ``d``."""
    b = batch["ids"].shape[0]
    if b % mesh.data:
        raise ValueError(
            f"batch {b} not divisible by data axis {mesh.data}")
    n = b // mesh.data
    lo = mesh.data_rank * n
    return {k: v[lo:lo + n] for k, v in batch.items()}


def _sharded_forward_backward(cfg, plans, mesh, groups, dense_params, batch,
                              *, last_steps=None, step=None, factor=None):
    """The per-rank forward and backward of both sharded steps.

    Each group's embedding is assembled from the ranks' masked partial
    lookups by an ``all_reduce`` SUM over ``"model"``
    (``embed.sharded.lookup_groups``; with ``last_steps``, the pending
    decay applied inline), the tower runs on this rank's batch slice, and
    the gradients are taken w.r.t. the assembled embeddings and the
    tower. The loss (its sum over the slice, over the global batch size)
    and the tower's gradients are summed over ``"data"`` by one
    ``all_reduce`` of one flat buffer, so every replica of the tower gets
    the same bits. Returns ``(loss, g_embs, g_dense, mine, local)``:
    ``g_embs`` each group's ``[b_loc, F, D_g]`` cotangent, ``mine`` and
    ``local`` the slice's owned ids and their local rows
    (``embed.sharded.owned_rows``)."""
    from ..embed import sharded as shard_lib

    ids = batch["ids"]
    b_global = ids.shape[0] * mesh.data
    plan_list = [plans[f"field_{i}"] for i in range(cfg.n_fields)]
    mine, local = shard_lib.owned_rows(ids, plan_list, mesh.model_rank)
    embs = shard_lib.lookup_groups(groups, mine, local, mesh.model_group,
                                   last_steps=last_steps, step=step,
                                   factor=factor)
    embs = [e.requires_grad_() for e in embs]
    dense_view = tree_map(lambda p: p.detach().requires_grad_(),
                          dense_params)
    with torch.enable_grad():
        logits = ctr._forward_from_emb(dense_view, cfg, embs[0],
                                       embs[1] if len(embs) > 1 else None,
                                       batch["dense"])
        loss = torch.sum(torch.logaddexp(logits, torch.zeros_like(logits))
                         - batch["labels"] * logits) / b_global
    leaves = tree_leaves(dense_view)
    grads = torch.autograd.grad(loss, embs + leaves)
    g_embs, g_leaves = list(grads[:len(embs)]), grads[len(embs):]
    flat = torch.cat([loss.detach().reshape(1)]
                     + [g.reshape(-1) for g in g_leaves])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.data_group)
    parts = iter(torch.split(flat[1:], [g.numel() for g in g_leaves]))
    g_dense = tree_map(lambda p: next(parts).view(p.shape), dense_view)
    return flat[0], g_embs, g_dense, mine, local


def _sum_rowgrads(keys, g_embs, rows, mesh) -> list:
    """Each group's ``[rows, D_g]`` row gradient from this slice's
    cotangents, in one call of the port's embedding backward (one sort of
    ``keys``, the fm and LR lookups together; keys past a field's rows
    dropped), then summed over ``"data"`` by one ``all_reduce`` a
    group."""
    from ..kernels.embedding import embedding_backward_groups, sort_plan

    grads = embedding_backward_groups(
        sort_plan(keys), [g.reshape(-1, g.shape[-1]) for g in g_embs], rows)
    for g in grads:
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return grads


def make_sharded_train_step(cfg: ctr.CTRConfig, hp, mesh, *,
                            scheme: str = "div", r: float = 1.0,
                            zeta: float = 1e-5, dense_tx=None,
                            clip: bool = True, b1: float = 0.9,
                            b2: float = 0.999, eps: float = 1e-8,
                            nonfinite_guard: bool = False):
    """The multi-GPU train step: tables row-sharded over the grid's
    ``"model"`` axis, the batch split over ``"data"``, the dense tower
    replicated, one process a rank (``launch.mesh.CtrMesh``;
    ``embed.sharded`` holds the per-rank blocks).

    A rank takes the global batch and keeps its data slice. Its forward
    and backward are ``_sharded_forward_backward``; then the embedding
    cotangent of its owned ids is summed onto its rows (one embedding
    backward call for the fm and LR lookups) and, with CowClip's per-id
    counts, summed over ``"data"``. The update of each table shard is the
    fused kernel 1 (``embed.sharded.shard_update``, 2 x 26 launches a step
    at deepfm-criteo width), row-local and collective-free; the tower's
    summed gradient goes through ``dense_tx`` on every rank. Everything
    is written in place, nothing is read on the host, and every collective
    is issued on its group whatever its size, so the step is its own
    ``scan_step`` (captured into a CUDA graph with its NCCL calls).

    ``nonfinite_guard`` skips the whole update (the shards' tables and
    moments, the tower, its state and the step counter) when the batch
    loss is NaN/Inf, as the reference's where-select around the step does:
    the flag is ``core.builders.nonfinite_guard`` of the loss after its
    SUM over ``"data"``, kernel 1 reads it from the step block and writes
    nothing, and the tower goes through ``write_back`` under it. Every
    rank takes the same flag with no collective of its own: each rank of
    a data slice runs the same tower on the same assembled embedding (the
    lookup's SUM over ``"model"``), so its partial loss is the same bits
    on every model rank, and the SUM over ``"data"`` adds the same
    partial losses in the same order on every rank. A NaN or Inf in any
    rank's rows or in any slice's batch reaches every rank's loss through
    those two SUMs. Counted in ``aux["skipped_steps"]``.

    Returns a ``TrainStepBundle``: ``prepare`` keeps this rank's padded
    block of each logical table, ``export`` gathers them back to
    ``[vocab, D]`` (a collective: every rank calls it), ``flush`` is the
    identity (absent ids decay on their shard every step, as on the dense
    path), and ``export_state``/``import_state`` move m and v between the
    rank's blocks and the reference's padded logical snapshot layout
    (``embed.sharded.make_state_export_import``)."""
    from ..embed import sharded as shard_lib
    from ..kernels.cowclip import step_scalars

    if dense_tx is None:
        dense_tx = dense_tower_tx(hp, b1=b1, b2=b2, eps=eps)
    plans = shard_lib.make_plans(cfg.vocab_sizes, mesh.model, scheme)
    plan_list = [plans[f"field_{i}"] for i in range(cfg.n_fields)]
    upd_kw = dict(clip=clip, r=r, zeta=zeta, lr=hp.emb_lr, l2=hp.emb_l2,
                  b1=b1, b2=b2, eps=eps)
    prepare, export = shard_lib.make_prepare_export(plans, mesh)
    export_state, import_state = shard_lib.make_state_export_import(
        plans, mesh, ("m", "v"))

    def init(params):
        return {
            "step": counter(params),
            "m": tree_map(torch.zeros_like, params["embed"]),
            "v": tree_map(torch.zeros_like, params["embed"]),
            "dense": dense_tx.init(params["dense"]),
        }

    def step_impl(params, state, batch):
        batch = _data_slice(batch, mesh)
        t = state["step"] + 1
        groups = list(params["embed"].values())
        loss, g_embs, g_dense, _, local = _sharded_forward_backward(
            cfg, plans, mesh, groups, params["dense"], batch)
        ok = builders.nonfinite_guard(loss) if nonfinite_guard else None
        scalars = step_scalars(t, b1=b1, b2=b2, ok=ok)

        layout = shard_lib.local_layout(plan_list, local.device)
        keys = layout.keys(local)
        g_rows = _sum_rowgrads(keys, g_embs, layout.rows, mesh)
        cnt = torch.zeros(layout.rows + 1, dtype=torch.float32,
                          device=keys.device)
        cnt.index_add_(0, keys.to(torch.int64),
                       torch.ones(keys.shape[0], dtype=torch.float32,
                                  device=keys.device))
        dist.all_reduce(cnt, op=dist.ReduceOp.SUM, group=mesh.data_group)
        counts = layout.split(cnt)
        for g, (group, tables) in zip(g_rows, params["embed"].items()):
            for g_f, cnt_f, (name, w) in zip(layout.split(g), counts,
                                             tables.items()):
                shard_lib.shard_update(w, g_f, cnt_f, state["m"][group][name],
                                       state["v"][group][name], scalars,
                                       **upd_kw)
        _update_dense(params, state, g_dense, dense_tx, t, ok)
        aux = {"loss": loss}
        if nonfinite_guard:
            aux["skipped_steps"] = skipped(ok)
        return params, state, aux

    return builders.TrainStepBundle(
        StepFn(step_impl), init, builders.identity_flush, prepare, export,
        export_state=export_state, import_state=import_state)


def _warn_overflow(n: int, steps: int) -> None:
    """The sharded_sparse placement's capacity-overflow note: ``n`` dense
    per-shard fallbacks (field-shard steps) within ``steps`` steps. The
    reference warns from the eager step and once a scanned chunk; the port
    reads the count once an epoch, with the losses. Through ``logging``
    (stderr by default), never stdout, which drivers parse."""
    logger.warning(
        "[sharded_sparse] unique capacity overflow on %d field-shard "
        "step(s) within %d step(s); dense per-shard fallback (exact, but "
        "O(rows/shard) for those shards)", int(n), int(steps))


def make_sharded_sparse_train_step(cfg: ctr.CTRConfig, hp, mesh, *,
                                   scheme: str = "div", r: float = 1.0,
                                   zeta: float = 1e-5, dense_tx=None,
                                   clip: bool = True, b1: float = 0.9,
                                   b2: float = 0.999, eps: float = 1e-8,
                                   nonfinite_guard: bool = False):
    """The sharded+sparse hybrid step: tables row-sharded as in
    ``make_sharded_train_step``, each shard's update restricted to the
    batch ids it owns (``embed.sharded_sparse``).

    Per rank: each field's owned ids of the global batch deduplicated into
    a static-capacity slot set (staged over ``"data"``: one ``all_gather``
    of every field's slice sets, packed; single-stage with one data
    slice), the overflow flags summed over ``"model"``; the forward reads
    the raw tables with each row's pending decay applied inline; the
    backward sums the owned cotangents onto the slots (``slot_keys``; the
    full rows for a field that can overflow) in one embedding backward
    call, summed over ``"data"``; then ``update_phases``: one grouped
    launch of the catch-up kernel and one of the update kernel over every
    table of the rank, the fused kernel for the fallback of a capped field,
    selected by its flag. ``aux``: ``loss``, ``overflow_shards`` (the
    field-shard fallbacks this step, over the grid) and
    ``catchup_depth_max`` (an ``all_reduce`` MAX over ``"model"``), all
    0-dim tensors on the device.

    ``nonfinite_guard`` as in ``make_sharded_train_step`` (the same flag
    on every rank, for the same reasons): kernels 2 and 3 read it from the
    step block, so the update kernel writes no row and no ``last_step``
    on a skipped step; a capped field's dense fallback is selected on
    ``overflow & ok`` (``update_phases``), so its decayed table never
    lands either; the tower and the step counter keep their values.
    ``overflow_shards`` and ``catchup_depth_max`` still report the
    skipped step's dedup and catch-up, as the reference's guard passes
    ``aux`` through; ``aux["skipped_steps"]`` counts the skip.

    Returns a ``TrainStepBundle``: ``prepare``/``export`` as the sharded
    step's, ``flush`` the lazy-decay flush of the rank's shards (needed
    before export, eval or checkpoint; idempotent), and
    ``export_state``/``import_state`` over m, v and ``last_step``."""
    from ..core.optim import decay_factor
    from ..embed import sharded as shard_lib
    from ..embed import sharded_sparse as hybrid_lib
    from ..kernels.cowclip import step_scalars
    from ..kernels.embedding import field_layout

    if dense_tx is None:
        dense_tx = dense_tower_tx(hp, b1=b1, b2=b2, eps=eps)
    plans = shard_lib.make_plans(cfg.vocab_sizes, mesh.model, scheme)
    plan_list = [plans[f"field_{i}"] for i in range(cfg.n_fields)]
    adam_kw = dict(lr=hp.emb_lr, l2=hp.emb_l2, b1=b1, b2=b2, eps=eps)
    upd_kw = dict(clip=clip, r=r, zeta=zeta, **adam_kw)
    factor = decay_factor(hp.emb_lr, hp.emb_l2)
    shard = mesh.model_rank
    prepare, export = shard_lib.make_prepare_export(plans, mesh)
    export_state, import_state = shard_lib.make_state_export_import(
        plans, mesh, ("m", "v", "last_step"))

    def init(params):
        return {
            "step": counter(params),
            "m": tree_map(torch.zeros_like, params["embed"]),
            "v": tree_map(torch.zeros_like, params["embed"]),
            "last_step": tree_map(
                lambda w: torch.zeros((w.shape[0],), dtype=torch.int32,
                                      device=w.device), params["embed"]),
            "dense": dense_tx.init(params["dense"]),
        }

    def dedup(ids, b_global):
        """Each field's ``(uloc, counts, overflow or None, gathered)``:
        the slot set, its flag where the field can overflow, and the
        gathered slice sets of the staged dedup (None single-stage)."""
        caps = [hybrid_lib.shard_capacity(p, b_global, cfg.unique_capacity)
                for p in plan_list]
        out = []
        if mesh.data > 1:
            b_loc = ids.shape[0]
            slices = [hybrid_lib.slice_unique_counts(
                ids[:, i], p.vocab, min(b_loc, p.vocab))
                for i, p in enumerate(plan_list)]
            packed = torch.cat([torch.stack([u, c.to(torch.int32)])
                                for u, c in slices], dim=1)
            parts = [torch.empty_like(packed) for _ in range(mesh.data)]
            dist.all_gather(parts, packed, group=mesh.data_group)
            lo = 0
            for (u, _), p, cap in zip(slices, plan_list, caps):
                hi = lo + u.shape[0]
                gids = torch.cat([x[0, lo:hi] for x in parts])
                gcnts = torch.cat([x[1, lo:hi] for x in parts]).to(
                    torch.float32)
                uloc, cnts, ovf = hybrid_lib.owned_unique_weighted(
                    gids, gcnts, p, cap, shard)
                out.append([uloc, cnts, ovf, (gids, gcnts)])
                lo = hi
        else:
            for i, (p, cap) in enumerate(zip(plan_list, caps)):
                uloc, cnts, ovf = hybrid_lib.owned_unique_local(
                    ids[:, i], p, cap, shard)
                out.append([uloc, cnts, ovf, None])
        for d, p, cap in zip(out, plan_list, caps):
            if not hybrid_lib.can_overflow(p, b_global, cap):
                d[2] = None
        return out

    def step_impl(params, state, batch):
        batch = _data_slice(batch, mesh)
        ids = batch["ids"]
        b_global = ids.shape[0] * mesh.data
        t = state["step"] + 1
        sets = dedup(ids, b_global)
        n_overflow = torch.zeros(1, dtype=torch.int32, device=ids.device)
        for _, _, ovf, _ in sets:
            if ovf is not None:
                n_overflow += ovf.to(torch.int32)
        dist.all_reduce(n_overflow, op=dist.ReduceOp.SUM,
                        group=mesh.model_group)

        groups = list(params["embed"].values())
        loss, g_embs, g_dense, mine, local = _sharded_forward_backward(
            cfg, plans, mesh, groups, params["dense"], batch,
            last_steps=list(state["last_step"].values()), step=t,
            factor=factor)
        ok = builders.nonfinite_guard(loss) if nonfinite_guard else None
        scalars = step_scalars(t, b1=b1, b2=b2, ok=ok)

        # one embedding backward call: a field that cannot overflow sums
        # onto its slots, one that can onto its full rows (its fallback
        # needs them)
        key_rows, cols = [], []
        for i, (p, (uloc, _, ovf, _)) in enumerate(zip(plan_list, sets)):
            if ovf is None:
                key_rows.append(uloc.shape[0])
                cols.append(hybrid_lib.slot_keys(local[:, i], mine[:, i],
                                                 uloc))
            else:
                key_rows.append(p.rows_per_shard)
                cols.append(local[:, i])
        layout = field_layout(tuple(key_rows), ids.device)
        g_rows = _sum_rowgrads(layout.keys(torch.stack(cols, dim=1)),
                               g_embs, layout.rows, mesh)

        cnt_full = []
        for i, (p, (_, _, ovf, gathered)) in enumerate(zip(plan_list, sets)):
            if ovf is None:
                cnt_full.append(None)
            elif gathered is not None:
                cnt_full.append(hybrid_lib.full_counts_from_gathered(
                    *gathered, p, shard))
            else:
                c = shard_lib.counts_partial(ids[:, i], p, shard)
                dist.all_reduce(c, op=dist.ReduceOp.SUM,
                                group=mesh.data_group)
                cnt_full.append(c)

        tables = []
        for g, (group, ws) in zip(g_rows, params["embed"].items()):
            per_field = layout.split(g)
            for i, (name, w) in enumerate(ws.items()):
                uloc, cnts, ovf, _ = sets[i]
                tables.append(hybrid_lib.ShardTable(
                    w, state["m"][group][name], state["v"][group][name],
                    state["last_step"][group][name], uloc, cnts, ovf,
                    per_field[i] if ovf is None else None,
                    per_field[i] if ovf is not None else None,
                    cnt_full[i]))
        depth = hybrid_lib.update_phases(tables, scalars, **upd_kw)
        depth = depth.reshape(1).clone()
        dist.all_reduce(depth, op=dist.ReduceOp.MAX, group=mesh.model_group)
        _update_dense(params, state, g_dense, dense_tx, t, ok)
        aux = {"loss": loss, "overflow_shards": n_overflow[0],
               "catchup_depth_max": depth[0]}
        if nonfinite_guard:
            aux["skipped_steps"] = skipped(ok)
        return params, state, aux

    return builders.TrainStepBundle(
        StepFn(step_impl), init, _make_lazy_flush(adam_kw), prepare, export,
        export_state=export_state, import_state=import_state)


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
    # the device stream's time between CUDA events: under the eager engine
    # recorded just before the step (its batch already copied, on a side
    # stream) and just after it; under the scan engine around each chunk's
    # replay (the copy into the graph's buffers and the k steps), divided
    # by k. Either holds any time the card waited within it for the host.
    # On the CPU they are the host clock around the step (or chunk).
    losses: list = dataclasses.field(default_factory=list)
    step_seconds: list = dataclasses.field(default_factory=list)
    # the sharded_sparse placement's dense per-shard fallbacks over the
    # run (field-shard steps; its aux["overflow_shards"], read with the
    # losses)
    overflow_shards: int = 0


class _StepClock:
    """Seconds per step of one epoch. On the card, CUDA events recorded on
    the stream before and after each step or chunk, read after the epoch
    (its losses have been read by then, so the read waits for nothing
    more); elsewhere the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.spans = []     # [start, end, steps]

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def start(self):
        self.spans.append([self._now(), None, 0])

    def stop(self, steps: int = 1):
        """End the open span, which covered ``steps`` steps."""
        self.spans[-1][1:] = [self._now(), steps]

    def seconds(self) -> list:
        """Each span's seconds over its steps, once a step."""
        if self.cuda and self.spans:
            self.spans[-1][1].synchronize()
        out = []
        for a, b, steps in self.spans:
            sec = (a.elapsed_time(b) / 1e3 if self.cuda else b - a)
            out.extend([sec / steps] * steps)
        return out


def _stream_device_chunks(stream, device):
    """A stream's chunks on the device: on the card pinned and copied one
    chunk ahead on a side stream (``data.prefetch.stage``; the stream has
    its own worker thread), on the CPU wrapped as they come."""
    if device.type == "cuda":
        return prefetch_lib.stage(stream, device)
    return ({k: torch.as_tensor(v) for k, v in c.items()} for c in stream)


def _run_stream(stream, params, opt_state, *, step_fn, runner, max_steps,
                device, start_step=0, snapshot_cb=None):
    """Train on ``stream``'s chunks until it ends or ``max_steps`` (total
    steps, counted from ``start_step``): the scan engine replays each
    whole chunk, the eager one unstacks it; ``snapshot_cb`` runs at each
    chunk boundary. Returns ``(params, opt_state, steps, losses,
    step_seconds)``, the losses read once at the end."""
    clock = _StepClock(device)
    losses, n_steps = [], int(start_step)
    for chunk in _stream_device_chunks(stream, device):
        k = chunk["labels"].shape[0]
        if max_steps is not None and n_steps + k > max_steps:
            k = max_steps - n_steps
            if k <= 0:
                break
            chunk = {name: v[:k] for name, v in chunk.items()}
        if runner is not None:
            clock.start()
            params, opt_state, aux = runner(params, opt_state, chunk)
            clock.stop(k)
            losses.append(aux["loss"])
        else:
            for i in range(k):
                clock.start()
                params, opt_state, aux = step_fn(
                    params, opt_state, {name: v[i]
                                        for name, v in chunk.items()})
                clock.stop()
                losses.append(aux["loss"].reshape(1))
        n_steps += k
        if snapshot_cb is not None:
            params, opt_state = snapshot_cb(params, opt_state, n_steps)
        if max_steps is not None and n_steps >= max_steps:
            break
    losses = torch.cat(losses).tolist() if losses else []
    return params, opt_state, n_steps, losses, clock.seconds()


def _epoch_batches(ds, batch_size: int, seed: int, device):
    """One epoch of device batches in ``iterate_batches``'s order: on the
    card staged through pinned memory and copied one batch ahead on a side
    stream (``data.prefetch``), on the CPU wrapped as they come."""
    host = iterate_batches(ds, batch_size, seed=seed)
    if device.type == "cuda":
        return prefetch_lib.prefetch(host, device=device)
    return ({k: torch.as_tensor(v) for k, v in b.items()} for b in host)


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
    scan_steps: int = 8,
    mode: str = "epochs",
    stream=None,
    init_state=None,
    start_step: int = 0,
    snapshot_cb=None,
    device="cuda",
) -> TrainResult:
    """Epoch driver over a ``core.builders.TrainStepBundle``.

    Params come from ``ctr.init(cfg, seed=seed, device=device)`` then the
    bundle's ``prepare``, or from ``init_state = (params, opt_state)``
    (already prepared; batches then go to the params' device). ``flush``
    runs before every eval. ``max_steps`` caps the total step count across
    epochs. Batches come in ``iterate_batches``'s exact shuffle order (seed
    ``seed + epoch``).

    ``engine`` selects the hot loop (``train.engine``): ``"eager"``, one
    step at a time, or ``"scan"``, ``scan_steps`` steps a chunk, captured
    on the card as one CUDA graph (each distinct chunk length once) over
    chunks prefetched two deep; on the CPU the scan engine runs the
    chunk's steps in turn. Both consume the same batches
    and run the same kernels, so they give the same params bit for bit.

    Without a bundle the step is ``make_train_step(cfg, tx)``, the
    substrate placement, with ``tx.init`` its state and no flush.

    ``mode="stream"`` trains online from ``stream``, an iterable of
    ``[k, batch, ...]`` host chunks (``data.stream.stream_chunks``): no
    epochs, steps until the stream ends or ``max_steps``, then one flush
    and a final eval. Both engines work: the eager one unstacks each
    chunk, the scan engine replays the chunk's graph. The chunk geometry
    is the stream's (``batch_size``, ``scan_steps`` and ``epochs`` are
    ignored), and the stream is closed on exit. A bundle with a
    ``stream_driver`` (the async hotcold placement) consumes the stream
    itself (stream mode only). Every eval reads ``bundle.export`` of the
    flushed params, the canonical ``[vocab, D]`` tables.

    Crash-safe resume hooks (``train.snapshot``): ``init_state`` may be a
    snapshot's restore; ``start_step`` seeds the step counter, so
    ``max_steps`` keeps meaning *total* steps across the original and the
    resumed process. ``snapshot_cb(params, opt_state, n_steps) ->
    (params, opt_state)`` runs at every chunk boundary in stream mode and
    every step boundary in eager epoch mode; it owns the cadence and may
    flush (the pair it returns replaces the live one, so a snapshot's
    flush stays part of the trajectory). A bundle with a
    ``stream_driver`` takes neither: the CLI runs it in segments.
    """
    from . import engine as engine_lib

    if engine not in engine_lib.ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{engine_lib.ENGINES}")
    if mode not in ("epochs", "stream"):
        raise ValueError(f"unknown mode {mode!r}; expected 'epochs' or "
                         "'stream'")
    if (mode == "stream") != (stream is not None):
        raise ValueError("mode='stream' requires a chunk stream (and a "
                         "stream requires mode='stream')")
    if step_bundle is None:
        step_bundle = builders.TrainStepBundle(
            make_train_step(cfg, tx), tx.init, builders.identity_flush)

    if init_state is not None:
        params, opt_state = init_state
    else:
        params = step_bundle.prepare(
            ctr.init(cfg, seed=seed, device=resolve_device(device)))
        opt_state = step_bundle.init(params)
    dev = tree_leaves(params["dense"])[0].device
    step_fn, flush = step_bundle.step, step_bundle.flush
    driver = step_bundle.stream_driver
    if driver is not None and engine == "scan" and mode != "stream":
        raise ValueError(
            "this bundle drives its own host-side consume loop "
            "(stream_driver); it supports mode='stream' only")
    runner = (engine_lib.make_chunk_runner(
        engine_lib.resolve_scan_step(step_bundle))
        if engine == "scan" and driver is None else None)
    evaluate = make_eval_fn(cfg)

    def eval_fn(params, ds):
        # on the canonical tables: a sharded rank gathers them back (a
        # collective every rank calls) and scores the whole test set
        return evaluate(step_bundle.export(params), ds)

    history, losses, step_seconds = [], [], []
    overflow = 0
    n_steps = int(start_step)
    t0 = time.perf_counter()
    if mode == "stream":
        try:
            if driver is not None:
                params, opt_state, n_steps, stats = driver(
                    params, opt_state, stream, max_steps=max_steps)
                losses = stats["losses"]
            else:
                params, opt_state, n_steps, losses, step_seconds = (
                    _run_stream(stream, params, opt_state, step_fn=step_fn,
                                runner=runner, max_steps=max_steps,
                                device=dev, start_step=start_step,
                                snapshot_cb=snapshot_cb))
        finally:
            close = getattr(stream, "close", None)
            if close is not None:
                close()
        seconds = time.perf_counter() - t0
        params, opt_state = flush(params, opt_state)
        final = {}
        if test_ds is not None:
            final = eval_fn(params, test_ds)
        if log_fn:
            log_fn(f"stream: {n_steps} steps"
                   + (f", migration overlap "
                      f"{stats['migration_overlap_fraction']:.2f}"
                      if driver is not None else "")
                   + (f", auc={final['auc']:.4f} "
                      f"logloss={final['logloss']:.4f}" if final else ""))
        return TrainResult(history=history, final_eval=dict(final),
                           seconds=seconds, steps=n_steps, params=params,
                           opt_state=opt_state, losses=losses,
                           step_seconds=step_seconds)
    for epoch in range(epochs):
        if max_steps is not None and n_steps >= max_steps:
            break
        clock = _StepClock(dev)
        epoch_losses, epoch_overflow, epoch_start = [], [], n_steps
        if runner is not None:
            def on_chunk(k, aux):
                if aux is None:
                    clock.start()
                    return
                clock.stop(k)
                epoch_losses.append(aux["loss"])
                if "overflow_shards" in aux:
                    epoch_overflow.append(aux["overflow_shards"])

            params, opt_state, ran, _ = engine_lib.run_epoch(
                runner, params, opt_state, train_ds, batch_size, scan_steps,
                seed=seed + epoch,
                max_steps=None if max_steps is None else max_steps - n_steps,
                on_chunk=on_chunk)
            n_steps += ran
        else:
            batches = _epoch_batches(train_ds, batch_size, seed + epoch, dev)
            for batch in batches:
                clock.start()
                params, opt_state, aux = step_fn(params, opt_state, batch)
                clock.stop()
                epoch_losses.append(aux["loss"].reshape(1))
                if "overflow_shards" in aux:
                    epoch_overflow.append(aux["overflow_shards"].reshape(1))
                n_steps += 1
                if snapshot_cb is not None:
                    params, opt_state = snapshot_cb(params, opt_state,
                                                    n_steps)
                if max_steps is not None and n_steps >= max_steps:
                    break
            batches.close()
        if epoch_losses:   # the epoch's one read of the device
            losses.extend(torch.cat(epoch_losses).tolist())
        if epoch_overflow:
            n = int(torch.cat(epoch_overflow).sum())
            if n:
                _warn_overflow(n, n_steps - epoch_start)
            overflow += n
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
                       step_seconds=step_seconds, overflow_shards=overflow)
