"""CowClip: adaptive column-wise gradient clipping (Zheng et al., AAAI 2023).

A port of ``repro.core.cowclip``. An id's embedding vector is a *row* of the
``[vocab, dim]`` table; for every row::

    clip_t = cnt(id) * max(r * ||w[id]||, zeta)
    g[id] <- min(1, clip_t / ||g[id]||) * g[id]

``cnt(id)`` is the id's occurrence count in the batch. Rows with
``cnt = 0`` have a zero loss gradient, so their ``clip_t = 0`` bound is a
no-op. 1-dim first-order (LR-stream) tables are exempt.

Also the ``cowclip`` gradient transformation over a tree of tables and
the paper's Table-7 ablation clips (``make_clip_transform``), which the
substrate placement runs; the fused and sparse kernels apply CowClip
themselves.
"""

from __future__ import annotations

from functools import partial

import torch

from .optim import EmptyState, GradientTransformation
from .tree import tree_map

_NORM_EPS = 1e-30  # guards 0/0 in the clip ratio; never changes a real clip


def _row_norms(x: torch.Tensor) -> torch.Tensor:
    """L2 norm of each row of a [vocab, dim] matrix, computed in f32."""
    return torch.sqrt(torch.sum(torch.square(x.to(torch.float32)), dim=-1))


def cowclip_table(
    grad: torch.Tensor,
    weight: torch.Tensor,
    counts: torch.Tensor,
    *,
    r: float = 1.0,
    zeta: float = 1e-5,
) -> torch.Tensor:
    """Apply CowClip to one embedding table's gradient ([vocab, dim] grad
    and weight, [vocab] counts); returns the clipped gradient."""
    if weight.shape[-1] < 2:
        # Paper appendix: CowClip is not applied to the LR stream's 1-dim
        # "bias-like" embeddings (W&D / DeepFM first-order tables).
        return grad
    gnorm = _row_norms(grad)
    wnorm = _row_norms(weight)
    clip_t = counts.to(torch.float32) * torch.clamp_min(r * wnorm, zeta)
    ratio = torch.clamp_max(clip_t / (gnorm + _NORM_EPS), 1.0)
    return (grad.to(torch.float32) * ratio[:, None]).to(grad.dtype)


def cowclip_rows(
    grad_rows: torch.Tensor,
    weight_rows: torch.Tensor,
    counts: torch.Tensor,
    *,
    r: float = 1.0,
    zeta: float = 1e-5,
) -> torch.Tensor:
    """CowClip on gathered unique-id rows (the sparse ``[n_unique, dim]``
    layout). The clip is row-local, so this is ``cowclip_table`` on the
    subset; pad slots have count 0 and clip their gradient to zero. 1-dim
    LR-stream rows stay exempt."""
    return cowclip_table(grad_rows, weight_rows, counts, r=r, zeta=zeta)


def cowclip(r: float = 1.0, zeta: float = 1e-5) -> GradientTransformation:
    """CowClip over a tree of embedding tables. ``update`` takes the extra
    ``counts``: a tree shaped like the grads with a ``[vocab]`` leaf per
    ``[vocab, dim]`` table."""

    def init_fn(params):
        del params
        return EmptyState()

    def update_fn(updates, state, params=None, *, counts=None, **extras):
        del extras
        if params is None or counts is None:
            raise ValueError("cowclip requires params and counts")
        return tree_map(partial(cowclip_table, r=r, zeta=zeta), updates,
                        params, counts), state

    return GradientTransformation(init_fn, update_fn)


# ---------------------------------------------------------------------------
# Ablation variants (paper Table 7)
# ---------------------------------------------------------------------------


def clip_table_global(grad: torch.Tensor, clip_t: float) -> torch.Tensor:
    """Gradient-norm clipping over the whole table ("GC")."""
    gnorm = torch.sqrt(torch.sum(torch.square(grad.to(torch.float32))))
    ratio = torch.clamp_max(clip_t / (gnorm + _NORM_EPS), 1.0)
    return (grad.to(torch.float32) * ratio).to(grad.dtype)


def clip_table_columnwise_const(grad: torch.Tensor,
                                clip_t: float) -> torch.Tensor:
    """Column-wise GC: each id's row clipped to a constant threshold."""
    gnorm = _row_norms(grad)
    ratio = torch.clamp_max(clip_t / (gnorm + _NORM_EPS), 1.0)
    return (grad.to(torch.float32) * ratio[:, None]).to(grad.dtype)


def clip_table_fieldwise_const(grad: torch.Tensor,
                               clip_t: float) -> torch.Tensor:
    """Field-wise GC: the field's table is one clipping unit (one table a
    field here, so it is the per-table norm)."""
    return clip_table_global(grad, clip_t)


def clip_table_fieldwise_adaptive(
    grad: torch.Tensor,
    weight: torch.Tensor,
    counts: torch.Tensor,
    *,
    r: float = 1.0,
    zeta: float = 1e-5,
) -> torch.Tensor:
    """Adaptive field-wise GC: CowClip's formula at field granularity
    (cnt the field's total occurrences, norms over the whole table)."""
    gnorm = torch.sqrt(torch.sum(torch.square(grad.to(torch.float32))))
    wnorm = torch.sqrt(torch.sum(torch.square(weight.to(torch.float32))))
    cnt = torch.sum(counts.to(torch.float32))
    clip_t = cnt * torch.clamp_min(r * wnorm, zeta)
    ratio = torch.clamp_max(clip_t / (gnorm + _NORM_EPS), 1.0)
    return (grad.to(torch.float32) * ratio).to(grad.dtype)


CLIP_KINDS = ("none", "global", "field", "column", "adaptive_field",
              "adaptive_column")


def make_clip_transform(
    kind: str,
    *,
    r: float = 1.0,
    zeta: float = 1e-5,
    clip_t: float = 1.0,
) -> GradientTransformation:
    """Any Table-7 clipping variant as a GradientTransformation: ``kind``
    one of CLIP_KINDS, "adaptive_column" being CowClip."""
    if kind == "adaptive_column":
        return cowclip(r=r, zeta=zeta)
    if kind not in CLIP_KINDS:
        raise ValueError(f"unknown clip kind: {kind}")
    per_table = {
        "global": lambda g: clip_table_global(g, clip_t),
        "field": lambda g: clip_table_fieldwise_const(g, clip_t),
        "column": lambda g: clip_table_columnwise_const(g, clip_t),
    }

    def init_fn(params):
        del params
        return EmptyState()

    def update_fn(updates, state, params=None, *, counts=None, **extras):
        del extras
        if kind == "none":
            return updates, state
        if kind in per_table:
            return tree_map(per_table[kind], updates), state
        if params is None or counts is None:
            raise ValueError("adaptive_field requires params and counts")
        return tree_map(partial(clip_table_fieldwise_adaptive, r=r,
                                zeta=zeta), updates, params, counts), state

    return GradientTransformation(init_fn, update_fn)
