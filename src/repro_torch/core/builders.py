"""Assemble the paper's two-group optimizer and the train-step bundles.

A port of ``repro.core.builders``. Parameter trees split at the top level::

    params = {"embed": {<field tables, [vocab, dim]>},
              "dense": {<everything else>}}

and the optimizer runs two groups (paper Alg. 1):

  embed : [CowClip | ablation clip] -> count-aware coupled-L2 Adam
          (touched rows: +lambda_e * w -> Adam -> -eta_e; absent rows:
          w *= 1 - eta_e * lambda_e, Adam moments held)
  dense : Adam (+ optional L2) -> -eta(t) with linear warmup

``build_optimizer`` builds that as one ``GradientTransformation``, the
substrate placement's optimizer (the exactness oracle). The fused and
sparse placements run the embedding group through the CowClip kernels
(``repro_torch.kernels.cowclip``) and the dense tower through the same
chain, ``dense_tower_tx``. ``build_train_step`` routes a config to its
placement's bundle (``repro_torch.embed.store``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import cowclip as cc
from . import optim, schedules
from .scaling import Hyperparams
from .tree import tree_map


def label_params(params):
    """Label each leaf 'embed' or 'dense' from the top-level split."""
    def label_subtree(name, subtree):
        return tree_map(lambda _: name, subtree)

    return {k: label_subtree("embed" if k == "embed" else "dense", v)
            for k, v in params.items()}


class TwoGroupState(tuple):
    """(embed_state, dense_state), a plain tuple tree."""


def two_group(
    embed_tx: optim.GradientTransformation,
    dense_tx: optim.GradientTransformation,
) -> optim.GradientTransformation:
    """Compose embed/dense transforms over the top-level split. Unlike
    ``optim.partition`` it dispatches on the top-level keys, so the
    tree-shaped ``counts`` (shaped like ``params["embed"]``) go to the
    embed group only."""

    def init_fn(params):
        return (embed_tx.init(params["embed"]), dense_tx.init(params["dense"]))

    def update_fn(updates, state, params=None, *, counts=None, **extras):
        e_params = None if params is None else params["embed"]
        d_params = None if params is None else params["dense"]
        e_up, e_st = embed_tx.update(updates["embed"], state[0], e_params,
                                     counts=counts, **extras)
        d_up, d_st = dense_tx.update(updates["dense"], state[1], d_params,
                                     **extras)
        return {"embed": e_up, "dense": d_up}, (e_st, d_st)

    return optim.GradientTransformation(init_fn, update_fn)


def dense_tower_tx(
    hp: Hyperparams,
    *,
    warmup_steps: int = 0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> optim.GradientTransformation:
    """The dense tower's chain, identical across every embedding
    placement."""
    steps = []
    if hp.dense_l2:
        steps.append(optim.add_decayed_weights(hp.dense_l2))
    steps.append(optim.scale_by_adam(b1=b1, b2=b2, eps=eps))
    dense_lr = (
        schedules.linear_warmup(hp.dense_lr, warmup_steps)
        if warmup_steps
        else hp.dense_lr
    )
    steps.append(optim.scale_by_neg_lr(dense_lr))
    return optim.chain(*steps)


def build_optimizer(
    hp: Hyperparams,
    *,
    clip_kind: str = "adaptive_column",
    r: float = 1.0,
    zeta: float = 1e-5,
    clip_t: float = 1.0,
    warmup_steps: int = 0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> optim.GradientTransformation:
    """The paper's two-group optimizer as one GradientTransformation.
    ``update`` takes the extra ``counts``: a tree shaped like
    ``params["embed"]``, a ``[vocab]`` leaf of per-id batch counts for each
    ``[vocab, dim]`` table."""
    embed_steps = []
    if clip_kind != "none":
        embed_steps.append(
            cc.make_clip_transform(clip_kind, r=r, zeta=zeta, clip_t=clip_t))
    # count-aware tail: coupled-L2 Adam on touched rows, one geometric
    # decay step on absent rows (the sparse path's lazy catch-up, dense)
    embed_steps.append(
        optim.lazy_coupled_adam(hp.emb_lr, hp.emb_l2, b1=b1, b2=b2, eps=eps))
    dense_tx = dense_tower_tx(hp, warmup_steps=warmup_steps, b1=b1, b2=b2,
                              eps=eps)
    return two_group(optim.chain(*embed_steps), dense_tx)


class StepFn:
    """A train step ``(params, state, batch) -> (params, state, aux)`` that
    also names its capturable body.

    The counterpart of the reference's jitted ``StepFn``. Calling it runs
    the step eagerly; ``scan_step`` is the body the scan engine
    (``train.engine``) captures K copies of into one CUDA graph: it reads
    nothing on the host, keeps every scalar on the device, and writes the
    params and the state in place, so a replay reads and writes the
    tensors its capture saw. The port's steps are such bodies already, so
    ``scan_step`` is the step's own function.
    """

    __slots__ = ("_fn",)

    def __init__(self, fn):
        self._fn = fn

    @property
    def scan_step(self):
        return self._fn

    def __call__(self, params, state, batch):
        return self._fn(params, state, batch)


def nonfinite_guard(loss: torch.Tensor) -> torch.Tensor:
    """The guard's predicate on a step's batch loss: a 0-dim bool tensor,
    True where the loss is finite, on the loss's device (no host read).

    The reference wraps a pure step and where-selects every leaf of its
    new ``(params, state)`` against the old on this predicate. The port's
    steps update in place, so a guarded step takes the flag itself: the
    CowClip kernels read it from their step block and write nothing when
    it is False, and the rest of the state goes through ``write_back``,
    ``torch.where(ok, new, old)`` leaf by leaf. A NaN/Inf loss therefore
    skips the whole update (params, moments, ``last_step`` and the step
    counter stay as if the batch never came), and a finite one gives the
    unguarded step's values bit for bit. The skip is counted in
    ``aux["skipped_steps"]``, ``skipped(ok)``."""
    return torch.isfinite(loss)


def skipped(ok: torch.Tensor) -> torch.Tensor:
    """``aux["skipped_steps"]`` of a guarded step: 1 if skipped, else 0,
    a 0-dim int32 tensor on the flag's device."""
    return (~ok).to(torch.int32)


def write_back(old, new, ok: Optional[torch.Tensor] = None) -> None:
    """Copy every leaf of the tree ``new`` into the same leaf of ``old``,
    in place: ``torch.where(ok, new, old)`` under a guard's flag ``ok``.
    The tensors of ``old`` keep their storage, which a captured CUDA graph
    needs."""

    def put(dst, src):
        with torch.no_grad():
            dst.copy_(src if ok is None else torch.where(ok, src, dst))

    tree_map(put, old, new)


def identity_prepare(params):
    """Default param placement: leave the tree exactly as initialized."""
    return params


def identity_flush(params, state):
    """Default flush: nothing deferred, nothing to settle."""
    return params, state


class TrainStepBundle(NamedTuple):
    """A train-step bundle usable by ``train.loop.train_ctr``.

    step:    (params, state, batch) -> (params, state, aux)
    init:    params -> state
    flush:   (params, state) -> (params, state); settles deferred work,
             idempotent (identity for the fused placement)
    prepare: params -> params; placement-specific layout (the async
             hotcold placement moves the tables into its cold store;
             identity elsewhere)
    export:  params -> params; inverse of ``prepare``
    stream_transform: optional factory ``(max_steps=None) -> transform``
             for ``data.stream.ChunkStream``: runs on the stream's worker
             thread so host-side planning (the async hotcold migration
             planner) overlaps the device step; returning None from the
             transform ends the stream at the step budget.
    stream_driver: optional ``(params, state, stream, *, max_steps) ->
             (params, state, steps, stats)`` replacing the generic stream
             loop in ``train_ctr(mode="stream")`` -- bundles that must
             interleave host work with each dispatch (filling eviction
             handles) own their consume loop.
    export_state: optional state -> state as a snapshot writes it
             (``train.snapshot.capture``); None writes the state as it
             is. The sharded placements gather a rank's row blocks to the
             reference's padded logical layout (a collective).
    import_state: optional ``(state, flat) -> state``, the inverse for a
             resume from a snapshot's path-keyed arrays; None overlays them
             on the state as it is (``train.snapshot.overlay``).
    """

    step: Callable
    init: Callable
    flush: Callable
    prepare: Callable = identity_prepare
    export: Callable = identity_prepare
    stream_transform: Optional[Callable] = None
    stream_driver: Optional[Callable] = None
    export_state: Optional[Callable] = None
    import_state: Optional[Callable] = None


TRAIN_PATHS = ("substrate", "fused", "sparse", "sharded", "sharded_sparse",
               "hotcold")


def build_train_step(
    cfg,
    hp: Hyperparams,
    *,
    path: Optional[str] = None,
    clip_kind: str = "adaptive_column",
    r: float = 1.0,
    zeta: float = 1e-5,
    clip_t: float = 1.0,
    warmup_steps: int = 0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    nonfinite_guard: bool = False,
    **store_kw,
) -> TrainStepBundle:
    """Route a CTR train step to one of the placements of
    ``repro_torch.embed.EmbeddingStore``: ``substrate`` (this module's
    composable chain, the oracle), ``fused``, ``sparse``, ``hotcold``
    (``store_kw``: ``hot_capacity``, ``cold_store``, ``cold_dir``,
    ``admission``, ``half_life``), ``sharded`` and ``sharded_sparse``
    (``store_kw``: ``mesh``, a ``launch.mesh.CtrMesh``, required;
    ``partition``, "div" or "mod"). ``path=None`` honors
    the config: ``cfg.placement`` if set, else ``cfg.sparse`` selects
    "sparse", otherwise "substrate"."""
    from ..embed.store import store_for  # deferred: embed imports core

    return store_for(cfg, path=path, **store_kw).make_bundle(
        cfg, hp, clip_kind=clip_kind, r=r, zeta=zeta, clip_t=clip_t,
        warmup_steps=warmup_steps, b1=b1, b2=b2, eps=eps,
        nonfinite_guard=nonfinite_guard)
