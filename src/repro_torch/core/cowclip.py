"""CowClip: adaptive column-wise gradient clipping (Zheng et al., AAAI 2023).

A port of ``repro.core.cowclip``. An id's embedding vector is a *row* of the
``[vocab, dim]`` table; for every row::

    clip_t = cnt(id) * max(r * ||w[id]||, zeta)
    g[id] <- min(1, clip_t / ||g[id]||) * g[id]

``cnt(id)`` is the id's occurrence count in the batch. Rows with
``cnt = 0`` have a zero loss gradient, so their ``clip_t = 0`` bound is a
no-op. 1-dim first-order (LR-stream) tables are exempt.
"""

from __future__ import annotations

import torch

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
