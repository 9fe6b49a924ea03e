"""Fixed-shape CTR scoring, the half of the serving engine that evaluation
scores through.

A port of ``make_logits_fn``, ``padded_score_loop`` and
``collapse_pending_decay`` from ``repro.serve.engine``. Every dispatch scores exactly ``[batch_size]``
rows: smaller inputs and the tail are zero-padded and the pad scores
discarded on the host. Under PyTorch's eager execution nothing is
recompiled per shape, but the fixed shape keeps device memory bounded at
one batch of activations and is the shape the CUDA-graph engine will
capture. ``ServingEngine``, the micro-batcher and the hot-id cache are
ROADMAP queue 1 item 2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.optim import decay_factor, f32
from ..data import prefetch as prefetch_lib
from ..models import ctr


def make_logits_fn(cfg: ctr.CTRConfig):
    """The scoring forward ``(params, ids, dense) -> logits [B]``, taking
    host arrays and running on the device the params live on."""

    def logits_fn(params, ids: np.ndarray, dense: np.ndarray) -> torch.Tensor:
        device = params["dense"]["mlp"]["w0"].device
        with torch.inference_mode():
            return ctr.apply(params, cfg,
                             torch.as_tensor(ids, device=device),
                             torch.as_tensor(dense, device=device))

    return logits_fn


def _pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad a host array along axis 0 up to ``n`` rows."""
    if arr.shape[0] == n:
        return arr
    pad = np.zeros((n - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad])


def padded_score_loop(
    logits_fn,
    params,
    ids: np.ndarray,
    dense: np.ndarray,
    batch_size: int,
    *,
    overlap: bool = True,
) -> np.ndarray:
    """Score ``n`` rows through fixed ``[batch_size]`` zero-padded slices;
    returns ``[n]`` f32 logits on the host. With ``overlap`` (multi-slice
    inputs only) the host slicing runs on the prefetch worker thread."""
    ids = np.asarray(ids)
    dense = np.asarray(dense)
    n = ids.shape[0]
    if n <= batch_size:
        s = logits_fn(params, _pad_rows(ids, batch_size),
                      _pad_rows(dense, batch_size))
        return s.cpu().numpy()[:n].astype(np.float32, copy=True)

    def host_slices():
        for start in range(0, n, batch_size):
            end = min(start + batch_size, n)
            yield {"ids": _pad_rows(ids[start:end], batch_size),
                   "dense": _pad_rows(dense[start:end], batch_size)}

    slices = (prefetch_lib.prefetch(host_slices()) if overlap
              else host_slices())
    scores = np.empty(n, np.float32)
    start = 0
    for b in slices:
        s = logits_fn(params, b["ids"], b["dense"])
        end = min(start + batch_size, n)
        scores[start:end] = s.cpu().numpy()[: end - start]
        start = end
    return scores


def collapse_pending_decay(embed: dict, last_step: dict, step, *,
                           lr: float, l2: float) -> dict:
    """Apply pending lazy coupled-L2 decay to raw sparse-placement tables.

    The closed form ``w * (1 - lr*l2)**k``, ``k = step - last_step[row]``
    (``decay_factor`` rounding, O(1) in depth): what a bundle's ``flush``
    does, for a checkpoint that has no live bundle to flush through.
    ``embed`` and ``last_step`` are ``{group: {field: leaf}}`` trees; rows
    already caught up (k == 0) multiply by exactly 1.0. Returns new tables.
    """
    f = f32(decay_factor(lr, l2))

    def catch_up(w, ls):
        k = torch.clamp_min(int(step) - ls.to(torch.int32), 0)
        k = k.to(torch.float32)
        scale = torch.where(k > 0, f.to(w.device) ** k,
                            f32(1.0).to(w.device))
        return (w.to(torch.float32) * scale[:, None]).to(w.dtype)

    return {g: {name: catch_up(w, last_step[g][name])
                for name, w in tables.items()}
            for g, tables in embed.items()}
