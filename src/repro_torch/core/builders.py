"""Train-step bundles, the dense tower's optimizer chain, and the
non-finite guard.

A port of the parts of ``repro.core.builders`` that the fused and sparse
placements run. Parameter trees split at the top level::

    params = {"embed": {<field tables, [vocab, dim]>},
              "dense": {<everything else>}}

The embedding group is updated by the fused CowClip + coupled-L2 + Adam
kernel (``repro_torch.kernels.cowclip``); the dense tower by the chain
``dense_tower_tx`` builds (optional coupled L2 -> Adam -> -lr with linear
warmup).

Not ported yet: ``build_optimizer``, ``two_group``, ``label_params`` and
``build_train_step`` (the substrate placement, ROADMAP queue 1 item 4).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import optim, schedules
from .scaling import Hyperparams
from .tree import tree_map


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
    prepare: params -> params; placement-specific layout (identity here)
    export:  params -> params; inverse of ``prepare``
    """

    step: Callable
    init: Callable
    flush: Callable
    prepare: Callable = identity_prepare
    export: Callable = identity_prepare


TRAIN_PATHS = ("substrate", "fused", "sparse", "sharded", "sharded_sparse",
               "hotcold")
