"""Evaluation metrics: LogLoss and AUC on the device (torch), and a
host-side AUC (NumPy)."""

from __future__ import annotations

import numpy as np
import torch


def logloss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits: softplus(z) - y*z, with the
    softplus taken as ``logaddexp(z, 0)`` (exact, like ``jax.nn.softplus``;
    ``F.softplus`` turns linear above a threshold)."""
    return torch.mean(torch.logaddexp(logits, torch.zeros_like(logits))
                      - labels * logits)


def auc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Area under the ROC curve by the rank-sum (Mann-Whitney U)
    statistic, on the scores' device, in float64, with midranks for ties
    (as sklearn's ``roc_auc_score``): a 0-dim tensor, no host read."""
    scores = scores.to(torch.float64)
    n = scores.shape[0]
    order = torch.argsort(scores, stable=True)
    sorted_scores = scores[order]
    ranks_sorted = torch.arange(1, n + 1, dtype=torch.float64,
                                device=scores.device)
    # midranks for ties: the mean rank of each run of equal scores (sums
    # of integers, exact in float64 in any order of addition)
    is_new = torch.ones(n, dtype=torch.int64, device=scores.device)
    is_new[1:] = sorted_scores[1:] != sorted_scores[:-1]
    group_id = torch.cumsum(is_new, 0) - 1
    group_sum = torch.zeros(n, dtype=torch.float64,
                            device=scores.device).index_add_(
        0, group_id, ranks_sorted)
    group_cnt = torch.zeros(n, dtype=torch.float64,
                            device=scores.device).index_add_(
        0, group_id, torch.ones_like(ranks_sorted))
    midrank_sorted = (group_sum / torch.clamp_min(group_cnt, 1.0))[group_id]
    ranks = torch.zeros(n, dtype=torch.float64,
                        device=scores.device).index_copy_(
        0, order, midrank_sorted)
    labels = labels.to(torch.float64)
    n_pos = labels.sum()
    n_neg = n - n_pos
    u = (ranks * labels).sum() - n_pos * (n_pos + 1.0) / 2.0
    return u / torch.clamp_min(n_pos * n_neg, 1.0)


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
