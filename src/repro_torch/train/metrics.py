"""Evaluation metrics: LogLoss (torch) and host-side AUC (NumPy)."""

from __future__ import annotations

import numpy as np
import torch


def logloss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits: softplus(z) - y*z, with the
    softplus taken as ``logaddexp(z, 0)`` (exact, like ``jax.nn.softplus``;
    ``F.softplus`` turns linear above a threshold)."""
    return torch.mean(torch.logaddexp(logits, torch.zeros_like(logits))
                      - labels * logits)


def auc_numpy(scores, labels) -> float:
    """Host-side AUC (Mann-Whitney rank form, float64, midranks for ties);
    a copy of ``repro.train.metrics.auc_numpy``."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.float64)
    order = np.argsort(scores)
    s = scores[order]
    ranks = np.empty_like(s)
    n = len(s)
    i = 0
    base = np.arange(1, n + 1, dtype=np.float64)
    while i < n:
        j = i
        while j + 1 < n and s[j + 1] == s[i]:
            j += 1
        ranks[i : j + 1] = base[i : j + 1].mean()
        i = j + 1
    r = np.empty(n, np.float64)
    r[order] = ranks
    n_pos = labels.sum()
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float(((r * labels).sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
