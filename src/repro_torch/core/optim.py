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


# ---------------------------------------------------------------------------
# Lazy coupled-L2 decay for the sparse placement
# ---------------------------------------------------------------------------
# A row absent from a batch takes only the decay step w <- w * (1 - lr*l2)
# (moments held). The recursion is geometric, so the sparse path keeps a
# per-row ``last_step`` and, when a row is next touched after k skipped
# steps, catches up in closed form, w <- w * factor**k, with the factor
# rounded to f32 first. When lr or l2 is a schedule the per-step factor is
# not constant and ``decay_catchup_rows`` takes a capped replay window.


def _factor_at(lr, l2, s: torch.Tensor) -> torch.Tensor:
    """Per-step decay factor under (possibly scheduled) lr/l2 at step(s)
    ``s`` (an int tensor); schedules are called with f32 steps."""
    s_f = s.to(torch.float32)
    lr_s = lr(s_f) if callable(lr) else lr
    l2_s = l2(s_f) if callable(l2) else l2
    return (f32(1.0) - torch.as_tensor(lr_s, dtype=torch.float32)
            * torch.as_tensor(l2_s, dtype=torch.float32))


def catchup_mode(lr, l2) -> str:
    """``"closed_form"`` when lr and l2 are constants (O(1) in pending
    depth), ``"replay_window"`` when either is a schedule."""
    return "replay_window" if (callable(lr) or callable(l2)) else "closed_form"


def _window_decay_scale(last_step, k, *, lr, l2, window):
    """Per-row decay multiplier under a scheduled lr/l2: the newest
    ``window`` pending steps replayed exactly (a product over a
    ``[n, window]`` matrix), older ones approximated geometrically at the
    first pending step's factor. Exact whenever k <= window."""
    last32 = last_step.to(torch.int32)
    i = torch.arange(window, dtype=torch.int32, device=last32.device)
    s = (last32 + k)[:, None] - i[None, :]
    f = _factor_at(lr, l2, s)
    live = i[None, :] < torch.clamp_max(k, window)[:, None]
    one = f32(1.0).to(f.device)
    scale = torch.prod(torch.where(live, f, one), dim=1)
    k_exc = torch.clamp_min(k - window, 0)
    tail = torch.where(
        k_exc > 0,
        _factor_at(lr, l2, last32 + 1) ** k_exc.to(torch.float32), one)
    return torch.where(k > 0, scale * tail, one)


def decay_catchup_rows(w_rows, m_rows, v_rows, last_step, step, *, lr, l2,
                       b1=0.9, b2=0.999, eps=1e-8, replay_window=64):
    """Apply each row's pending decay-only steps ``last_step+1 .. step``.

    ``w_rows``/``m_rows``/``v_rows`` are ``[n, dim]``, ``last_step`` the
    ``[n]`` int32 step each row was last updated at, ``step`` an int (or
    0-dim int tensor). Closed form ``w * factor**k``, k = step - last_step,
    when lr and l2 are constants; the capped replay window when either is a
    schedule. m and v pass through. Returns f32 (w, m, v). Rows with k == 0
    multiply by exactly 1.0, so a second flush is a bitwise no-op.
    """
    del b1, b2, eps
    w = w_rows.to(torch.float32)
    m = m_rows.to(torch.float32)
    v = v_rows.to(torch.float32)
    k = torch.clamp_min(step - last_step.to(torch.int32), 0)
    if callable(lr) or callable(l2):
        scale = _window_decay_scale(last_step, k, lr=lr, l2=l2,
                                    window=replay_window)
    else:
        factor = f32(decay_factor(lr, l2)).to(w.device)
        scale = torch.where(k > 0, factor ** k.to(torch.float32),
                            f32(1.0).to(w.device))
    return w * scale[:, None], m, v


def decay_replay_reference(w_rows, last_step, step, *, lr, l2):
    """One multiply per pending step (the recursion the closed form
    collapses), O(max pending depth). The exactness oracle of the tests;
    on no hot path."""
    w = w_rows.to(torch.float32)
    last32 = last_step.to(torch.int32)
    k = torch.clamp_min(step - last32, 0)
    const = not (callable(lr) or callable(l2))
    factor = f32(decay_factor(lr, l2)) if const else None
    for i in range(int(k.max()) if k.numel() else 0):
        f = factor if const else _factor_at(lr, l2, last32 + 1 + i)[:, None]
        w = torch.where((i < k)[:, None], w * f, w)
    return w


def sparse_adam_rows(g_rows, w_rows, m_rows, v_rows, step, *, lr, l2,
                     b1=0.9, b2=0.999, eps=1e-8):
    """The step-``t`` update of gathered rows (already caught up through
    t-1): coupled L2, Adam with bias correction, apply; the math of
    ``add_decayed_weights -> scale_by_adam -> scale_by_neg_lr`` restricted
    to the touched rows. Returns f32 (w, m, v)."""
    w = w_rows.to(torch.float32)
    g = g_rows.to(torch.float32) + l2 * w
    m = b1 * m_rows.to(torch.float32) + (1.0 - b1) * g
    v = b2 * v_rows.to(torch.float32) + (1.0 - b2) * torch.square(g)
    t = f32(int(step))
    mu_hat_scale = 1.0 / (1.0 - b1 ** t)
    nu_hat_scale = 1.0 / (1.0 - b2 ** t)
    w = w - lr * (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + eps)
    return w, m, v


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
