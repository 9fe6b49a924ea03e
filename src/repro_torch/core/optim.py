"""Gradient-transformation algebra in PyTorch (the functional optax form).

A port of ``repro.core.optim``: ``GradientTransformation`` is a pair of
functions ``(init, update)`` over trees of tensors, and ``update`` returns
*updates* to be added to params. The functional form is kept (rather than
``torch.optim``) so each transform's op order mirrors the reference one for
one, which is what lets the parity tests hold the port to 1e-5.

Step counters are 0-dim int32 tensors on the params' device, as they are
in the JAX state under ``jit``, and every scalar derived from them (bias
corrections, scheduled step sizes) is a 0-dim float32 tensor computed from
the counter on that device: the same f32 arithmetic as JAX's, nothing read
by the host, and nothing a captured CUDA graph would freeze at its capture
step. ``bias_corrections`` is the one function that turns a step into its
bias corrections, for the dense tower's Adam and the CowClip kernels'
step block alike: the host's f32 rounding of them, looked up by the
counter on its device.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import numpy as np
import torch

from .tree import tree_leaves, tree_map

PyTree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]


def f32(x) -> torch.Tensor:
    """A 0-dim float32 CPU tensor (f32 scalar math as JAX does it)."""
    return torch.tensor(x, dtype=torch.float32)


def counter(like) -> torch.Tensor:
    """A step counter at 0: a 0-dim int32 tensor on the device of the
    first leaf of ``like`` (the CPU for an empty tree)."""
    leaves = tree_leaves(like)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _host_bias_column(b: float) -> list:
    """``1/(1 - b^t)`` for t = 0, 1, ... in the host's f32 rounding (each
    from a 0-dim CPU tensor, as ``kernels.cowclip.cowclip
    .bias_corrections`` computes it), up to the first t at which it is
    1.0: ``b^t`` is then at most half an ulp of 1, and stays so, so every
    later step's is 1.0 too (about ``17.3 / (1 - b)`` values)."""
    column = [(1.0 / (1.0 - b ** f32(0))).item()]
    while column[-1] != 1.0:
        column.append((1.0 / (1.0 - b ** f32(len(column)))).item())
    return column


_BIAS_TABLES: dict = {}


def _bias_table(b1: float, b2: float, device) -> torch.Tensor:
    """``[T + 1, 2]`` f32 on ``device``: row t the host's bias corrections
    at step t, through the first T at which both are 1.0. Built once per
    ``(b1, b2, device)``, outside any capture: a train step's first call,
    or its warm-up."""
    key = (float(b1), float(b2), torch.device(device))
    table = _BIAS_TABLES.get(key)
    if table is None:
        c1, c2 = _host_bias_column(b1), _host_bias_column(b2)
        n = max(len(c1), len(c2))
        table = torch.tensor([c1 + [1.0] * (n - len(c1)),
                              c2 + [1.0] * (n - len(c2))],
                             dtype=torch.float32).T.contiguous()
        table = _BIAS_TABLES[key] = table.to(device)
    return table


def bias_corrections(count, b1: float, b2: float) -> tuple:
    """Adam's bias corrections ``(1/(1 - b1^t), 1/(1 - b2^t))`` at the
    1-based step ``count`` (an int tensor of any shape, or an int): f32
    tensors of that shape on its device, with no host read. They are the
    host's rounding (``kernels.cowclip.cowclip.bias_corrections``) bit for
    bit on every device, looked up by the counter in a table of it
    (``_bias_table``): the card's own ``powf`` rounds ``b^t`` an ulp off
    the host's for some t, and so does the CPU's vectorized ``pow``."""
    if not isinstance(count, torch.Tensor):
        count = torch.tensor(int(count), dtype=torch.int32)
    table = _bias_table(b1, b2, count.device)
    idx = torch.clamp(count.to(torch.int32), 0, table.shape[0] - 1)
    rows = torch.index_select(table, 0, idx.reshape(-1)).reshape(
        *idx.shape, 2)
    return rows[..., 0], rows[..., 1]


class GradientTransformation(NamedTuple):
    """``init: params -> state``; ``update: (grads, state, params, **extras)
    -> (updates, state)``."""

    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple]


class EmptyState(NamedTuple):
    pass


def identity() -> GradientTransformation:
    def init_fn(params):
        del params
        return EmptyState()

    def update_fn(updates, state, params=None, **extras):
        del params, extras
        return updates, state

    return GradientTransformation(init_fn, update_fn)


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
    count: torch.Tensor      # 0-dim int32, on the params' device


def scale_by_schedule(schedule: Schedule) -> GradientTransformation:
    def init_fn(params):
        return ScaleByScheduleState(count=counter(params))

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
    count: torch.Tensor      # 0-dim int32, on the params' device
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
        return ScaleByAdamState(count=counter(params), mu=mu, nu=nu)

    def update_fn(updates, state, params=None, **extras):
        del params, extras
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1.0 - b1) * g, state.mu, updates)
        nu = tree_map(lambda v, g: b2 * v + (1.0 - b2) * torch.square(g),
                      state.nu, updates)
        mu_hat_scale, nu_hat_scale = bias_corrections(count, b1, b2)
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
    to the touched rows. ``step`` is an int or an int tensor. Returns f32
    (w, m, v)."""
    w = w_rows.to(torch.float32)
    g = g_rows.to(torch.float32) + l2 * w
    m = b1 * m_rows.to(torch.float32) + (1.0 - b1) * g
    v = b2 * v_rows.to(torch.float32) + (1.0 - b2) * torch.square(g)
    mu_hat_scale, nu_hat_scale = bias_corrections(step, b1, b2)
    w = w - lr * (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + eps)
    return w, m, v


def lazy_coupled_adam(
    lr: ScalarOrSchedule,
    l2: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> GradientTransformation:
    """Count-aware embedding optimizer tail: coupled-L2 Adam on the rows the
    batch touched, one geometric decay step on the rows it did not.

    Replaces ``add_decayed_weights -> scale_by_adam -> scale_by_neg_lr`` in
    the embedding group. Touched rows (``counts > 0``) run that chain's
    math; absent rows take ``w <- w * (1 - lr*l2)`` with m, v held, the
    dense counterpart of the sparse placement's lazy catch-up. The absent
    row's update is emitted as ``w*factor - w``, two ops (exact for factors
    near 1), so ``apply_updates``' ``w + u`` lands on fl(w * factor): the
    value the fused kernel writes directly.

    The step counter is a 0-dim int32 tensor on the params' device; the
    bias corrections are ``bias_corrections``' (the host's rounding, no
    host read); a constant lr's factor is the host's f32 ``decay_factor``,
    a scheduled one's is computed on the device in f32. Requires the per-id
    batch ``counts=`` extra (one ``[vocab]`` leaf per table).
    """

    def init_fn(params):
        mu = tree_map(torch.zeros_like, params)
        nu = tree_map(torch.zeros_like, params)
        return ScaleByAdamState(count=counter(params), mu=mu, nu=nu)

    def update_fn(updates, state, params=None, *, counts=None, **extras):
        del extras
        if params is None:
            raise ValueError("lazy_coupled_adam requires params")
        if counts is None:
            raise ValueError(
                "lazy_coupled_adam requires counts= (per-id batch "
                "occurrence counts, one [vocab] tensor per table)")
        count = state.count + 1
        lr_t = lr(count) if callable(lr) else lr
        mu_hat_scale, nu_hat_scale = bias_corrections(count, b1, b2)
        if callable(lr):    # in f32 on the device: 1 - fl32(lr_t * l2)
            factor = 1.0 - lr_t * l2
        else:
            factor = decay_factor(lr, l2)

        def leaf(g, w, m, v, cnt):
            g = g + l2 * w
            m2 = b1 * m + (1.0 - b1) * g
            v2 = b2 * v + (1.0 - b2) * torch.square(g)
            adam_u = (-lr_t) * (m2 * mu_hat_scale) / (
                torch.sqrt(v2 * nu_hat_scale) + eps)
            touched = (cnt > 0.0)[:, None]
            u = torch.where(touched, adam_u, w * factor - w)
            return u, torch.where(touched, m2, m), torch.where(touched, v2, v)

        # each leaf's (u, m, v), flattened in tree order, then unzipped
        flat = tree_leaves(tree_map(leaf, updates, params, state.mu,
                                    state.nu, counts))
        new_updates, mu, nu = (_like(updates, flat[i::3]) for i in range(3))
        return new_updates, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init_fn, update_fn)


def _like(tree: PyTree, leaves: list) -> PyTree:
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``tree``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def global_norm(tree: PyTree) -> torch.Tensor:
    """The f32 L2 norm over every leaf of ``tree`` (0 for an empty tree),
    a 0-dim tensor on the leaves' device."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(
        sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init_fn(params):
        del params
        return EmptyState()

    def update_fn(updates, state, params=None, **extras):
        del params, extras
        gnorm = global_norm(updates)
        scale_factor = torch.clamp_max(max_norm / (gnorm + 1e-12), 1.0)
        updates = tree_map(lambda g: g * scale_factor, updates)
        return updates, state

    return GradientTransformation(init_fn, update_fn)


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


class PartitionState(NamedTuple):
    inner_states: dict


def partition(
    transforms: dict,
    label_fn: Callable[[PyTree], PyTree],
) -> GradientTransformation:
    """Apply a different transformation per labelled parameter group.

    ``label_fn(params)`` returns a tree of string labels shaped like
    ``params``. Each group sees the tree with the other groups' leaves as
    ``None``. Extras go to every group; tree-shaped extras are passed
    already split, as ``partitioned_extras={label: extras}``.
    """
    group_names = tuple(sorted(transforms))

    def _masked(tree, labels, name):
        return tree_map(lambda x, lbl: x if lbl == name else None, tree,
                        labels)

    def _merge(trees, labels):
        def pick(lbl, *vals):
            return vals[group_names.index(lbl)]

        return tree_map(pick, labels, *trees)

    def init_fn(params):
        labels = label_fn(params)
        return PartitionState(inner_states={
            name: transforms[name].init(_masked(params, labels, name))
            for name in group_names})

    def update_fn(updates, state, params=None, *, partitioned_extras=None,
                  **extras):
        labels = label_fn(updates)
        new_states, outs = {}, []
        for name in group_names:
            sub_params = (None if params is None
                          else _masked(params, labels, name))
            group_extras = dict(extras)
            if partitioned_extras and name in partitioned_extras:
                group_extras.update(partitioned_extras[name])
            out, new_states[name] = transforms[name].update(
                _masked(updates, labels, name), state.inner_states[name],
                sub_params, **group_extras)
            outs.append(out)
        return _merge(outs, labels), PartitionState(inner_states=new_states)

    return GradientTransformation(init_fn, update_fn)


def sgd(lr: ScalarOrSchedule, l2: float = 0.0) -> GradientTransformation:
    steps = []
    if l2:
        steps.append(add_decayed_weights(l2))
    steps.append(scale_by_neg_lr(lr))
    return chain(*steps)


def adam(
    lr: ScalarOrSchedule,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    l2: float = 0.0,
) -> GradientTransformation:
    steps = []
    if l2:
        steps.append(add_decayed_weights(l2))
    steps.append(scale_by_adam(b1=b1, b2=b2, eps=eps))
    steps.append(scale_by_neg_lr(lr))
    return chain(*steps)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    """``params + updates`` leafwise (a ``None`` update keeps its param)."""
    return tree_map(lambda p, u: p if u is None else p + u.to(p.dtype),
                    params, updates)
