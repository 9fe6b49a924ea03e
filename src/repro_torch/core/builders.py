"""Train-step bundles and the dense tower's optimizer chain.

A port of the parts of ``repro.core.builders`` that the fused placement
runs. Parameter trees split at the top level::

    params = {"embed": {<field tables, [vocab, dim]>},
              "dense": {<everything else>}}

The embedding group is updated by the fused CowClip + coupled-L2 + Adam
kernel (``repro_torch.kernels.cowclip``); the dense tower by the chain
``dense_tower_tx`` builds (optional coupled L2 -> Adam -> -lr with linear
warmup).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from . import optim, schedules
from .scaling import Hyperparams


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
    """A train step ``(params, state, batch) -> (params, state, aux)``.

    The counterpart of the reference's jitted ``StepFn``: PyTorch runs
    eagerly, so the step is an ordinary callable. The scan body the
    reference also carries comes with the CUDA-graph engine (ROADMAP
    queue 1 item 3).
    """

    __slots__ = ("_fn",)

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, params, state, batch):
        return self._fn(params, state, batch)


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
