"""Gradient-transformation algebra in PyTorch (the functional optax form).

A port of ``repro.core.optim``: ``GradientTransformation`` is a pair of
functions ``(init, update)`` over trees of tensors, and ``update`` returns
*updates* to be added to params. The functional form is kept (rather than
``torch.optim``) so each transform's op order mirrors the reference one for
one, which is what lets the parity tests hold the port to 1e-5.

Scalars that JAX computes in float32 on device (bias corrections, scheduled
step sizes) are computed here as 0-dim float32 CPU tensors: the same f32
arithmetic, and PyTorch passes a 0-dim CPU tensor to a CUDA kernel by value,
so no host/device copy is made. Step counters are Python ints.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import numpy as np
import torch

from .tree import tree_map

PyTree = Any
Schedule = Callable[[int], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]


def f32(x) -> torch.Tensor:
    """A 0-dim float32 CPU tensor (f32 scalar math as JAX does it)."""
    return torch.tensor(x, dtype=torch.float32)


class GradientTransformation(NamedTuple):
    """``init: params -> state``; ``update: (grads, state, params, **extras)
    -> (updates, state)``."""

    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple]


class EmptyState(NamedTuple):
    pass


class ScaleState(NamedTuple):
    pass


def scale(step_size: float) -> GradientTransformation:
    def init_fn(params):
        del params
        return ScaleState()

    def update_fn(updates, state, params=None, **extras):
        del params, extras
        return tree_map(lambda g: step_size * g, updates), state

    return GradientTransformation(init_fn, update_fn)


class ScaleByScheduleState(NamedTuple):
    count: int


def scale_by_schedule(schedule: Schedule) -> GradientTransformation:
    def init_fn(params):
        del params
        return ScaleByScheduleState(count=0)

    def update_fn(updates, state, params=None, **extras):
        del params, extras
        step_size = schedule(state.count)
        updates = tree_map(lambda g: step_size * g, updates)
        return updates, ScaleByScheduleState(count=state.count + 1)

    return GradientTransformation(init_fn, update_fn)


def scale_by_neg_lr(lr: ScalarOrSchedule) -> GradientTransformation:
    if callable(lr):
        return scale_by_schedule(lambda c: -lr(c))
    return scale(-lr)


class ScaleByAdamState(NamedTuple):
    count: int
    mu: PyTree
    nu: PyTree


def scale_by_adam(
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> GradientTransformation:
    """Standard Adam preconditioner with bias correction (Kingma & Ba 2015)."""

    def init_fn(params):
        mu = tree_map(torch.zeros_like, params)
        nu = tree_map(torch.zeros_like, params)
        return ScaleByAdamState(count=0, mu=mu, nu=nu)

    def update_fn(updates, state, params=None, **extras):
        del params, extras
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1.0 - b1) * g, state.mu, updates)
        nu = tree_map(lambda v, g: b2 * v + (1.0 - b2) * torch.square(g),
                      state.nu, updates)
        c = f32(count)
        mu_hat_scale = 1.0 / (1.0 - b1 ** c)
        nu_hat_scale = 1.0 / (1.0 - b2 ** c)
        updates = tree_map(
            lambda m, v: (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale)
                                               + eps),
            mu, nu)
        return updates, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init_fn, update_fn)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """Coupled L2 through the optimizer: ``g <- g + lambda * w``."""

    def init_fn(params):
        del params
        return EmptyState()

    def update_fn(updates, state, params=None, **extras):
        del extras
        if params is None:
            raise ValueError("add_decayed_weights requires params")
        return tree_map(lambda g, w: g + weight_decay * w, updates,
                        params), state

    return GradientTransformation(init_fn, update_fn)


def decay_factor(lr: float, l2: float) -> float:
    """The per-step absent-row multiplier ``1 - lr * l2``, f32-rounded.

    Every path (the CUDA kernel, its plain version, the reference) derives
    the factor through this one helper so the rounding is identical
    everywhere; bit-equal to ``repro.core.optim.decay_factor``.
    """
    return float(np.float32(1.0 - float(lr) * float(l2)))


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init_fn(params):
        return tuple(t.init(params) for t in transforms)

    def update_fn(updates, state, params=None, **extras):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params, **extras)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init_fn, update_fn)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
