"""Inputs of a CTR cell, made from the seed on the run's device.

``make_traffic`` draws a pool of rows by the law of the port's own
generator (``repro_torch.data.synthetic.make_ctr_dataset``): each field's
ids Zipf(a) over its vocab behind a random permutation of the ids,
dense features N(0, 1), and labels Bernoulli(sigmoid(2 s + b)) from a
seeded FM teacher (first-order id effects, rank-4 pairwise latents, a
dense term), s scaled to unit spread and b set by bisection for the
target positive rate. The port's NumPy version takes seconds a million
rows on the host; this copy runs on the card in blocks of rows and hands
the pool to the host once, as a dataset a user would read.

``make_weights`` draws the model's starting weights: N(0, sigma) tables
and Kaiming-normal tower weights, zero biases, one normal draw a group of
leaves. The benchmark hands the same weights to the port and, drawn again
from the same seed, to the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..seeds import generator

LATENT_RANK = 4
TARGET_POS_RATE = 0.25
BISECT_STEPS = 60
BLOCK_ROWS = 1 << 22      # rows drawn on the card at a time


def pool_rows(traffic: dict) -> int:
    """Rows of the pool: whole chunks of whole batches."""
    return traffic["batch"] * traffic["batches"]


def make_traffic(traffic: dict, config: dict, seed: int,
                 device) -> dict:
    """The pool as host arrays: ``ids`` [N, F] int32, ``dense`` [N, Dd]
    float32, ``labels`` [N] float32 in {0, 1}. Deterministic in ``seed``
    and the two dicts."""
    vocabs = config["vocab_sizes"]
    n_fields, n_dense = len(vocabs), config["n_dense"]
    a = traffic["zipf_a"]
    n = pool_rows(traffic)
    gen = generator(seed, "traffic", device)
    dev = torch.device(device)

    total = sum(vocabs)
    starts = np.cumsum([0] + list(vocabs[:-1])).tolist()
    # Zipf CDFs over ranks 1..V, one a field, in float64
    cdfs = []
    for v in vocabs:
        p = torch.arange(1, v + 1, device=dev, dtype=torch.float64) ** (-a)
        cdfs.append(torch.cumsum(p / p.sum(), 0))
    perms = [torch.randperm(v, generator=gen, device=dev) for v in vocabs]
    # the teacher: one draw for every field's first-order effects and one
    # for every field's latents
    w_all = torch.randn(total, generator=gen, device=dev) / math.sqrt(
        n_fields)
    lv_all = torch.randn(total, LATENT_RANK, generator=gen, device=dev) / (
        math.sqrt(LATENT_RANK * n_fields))
    wd = torch.randn(n_dense, generator=gen, device=dev) * (
        0.3 / math.sqrt(n_dense))

    ids_host = np.empty((n, n_fields), np.int32)
    dense_host = np.empty((n, n_dense), np.float32)
    score = torch.empty(n, device=dev, dtype=torch.float32)
    for lo in range(0, n, BLOCK_ROWS):
        rows = min(BLOCK_ROWS, n - lo)
        ids = torch.empty(rows, n_fields, dtype=torch.int32, device=dev)
        s = torch.zeros(rows, device=dev)
        lsum = torch.zeros(rows, LATENT_RANK, device=dev)
        lsq = torch.zeros(rows, LATENT_RANK, device=dev)
        u = torch.rand(n_fields, rows, generator=gen, device=dev,
                       dtype=torch.float64)
        for f, v in enumerate(vocabs):
            raw = torch.searchsorted(cdfs[f], u[f], right=True)
            col = perms[f][raw.clamp_max(v - 1)]
            ids[:, f] = col.to(torch.int32)
            key = col + starts[f]
            s += w_all[key]
            lat = lv_all[key]
            lsum += lat
            lsq += lat * lat
        dense = torch.randn(rows, n_dense, generator=gen, device=dev)
        s += (0.5 * (lsum * lsum - lsq)).sum(-1) * 2.0 + dense @ wd
        score[lo:lo + rows] = s
        ids_host[lo:lo + rows] = ids.cpu().numpy()
        dense_host[lo:lo + rows] = dense.cpu().numpy()
    del cdfs, perms, w_all, lv_all

    score = score / torch.clamp_min(score.std(), 1e-6)
    lo_b, hi_b = -20.0, 20.0
    for _ in range(BISECT_STEPS):
        mid = 0.5 * (lo_b + hi_b)
        rate = float(torch.sigmoid(score * 2.0 + mid).mean())
        if rate > TARGET_POS_RATE:
            hi_b = mid
        else:
            lo_b = mid
    probs = torch.sigmoid(score * 2.0 + 0.5 * (lo_b + hi_b))
    labels = (torch.rand(n, generator=gen, device=dev) < probs).to(
        torch.float32)
    return {"ids": ids_host, "dense": dense_host,
            "labels": labels.cpu().numpy()}


def tower_shapes(config: dict) -> list:
    """``[(name, fan_in, fan_out)]`` of the deep tower's weights, in the
    port's layout (``[in, out]``, used as ``x @ w``)."""
    d0 = len(config["vocab_sizes"]) * config["emb_dim"] + config["n_dense"]
    dims = [d0] + list(config["mlp_dims"])
    out = [(f"mlp.w{i}", a, b) for i, (a, b) in enumerate(zip(dims[:-1],
                                                               dims[1:]))]
    return out + [("deep_out.w0", dims[-1], 1)]


def make_weights(config: dict, seed: int, device) -> dict:
    """The starting weights, in the port's tree layout: ``{"embed": {"fm":
    {"field_i": [V, D]}, "lin": {"field_i": [V, 1]}}, "dense": {"mlp":
    {...}, "lin_bias": [], "deep_out": {...}}}``, every leaf an allocation
    of its own (as the port's ``init`` makes them)."""
    vocabs = config["vocab_sizes"]
    sigma, dim = config["emb_sigma"], config["emb_dim"]
    gen = generator(seed, "weights", device)
    dev = torch.device(device)
    total = sum(vocabs)

    def tables(width):
        flat = torch.randn(total * width, generator=gen, device=dev)
        flat.mul_(sigma)
        parts = torch.split(flat, [v * width for v in vocabs])
        return {f"field_{i}": p.view(v, width).clone()
                for i, (p, v) in enumerate(zip(parts, vocabs))}

    embed = {"fm": tables(dim), "lin": tables(1)}
    shapes = tower_shapes(config)
    flat = torch.randn(sum(a * b for _, a, b in shapes), generator=gen,
                       device=dev)
    parts = torch.split(flat, [a * b for _, a, b in shapes])
    w = {name: p.view(a, b).mul(math.sqrt(2.0 / a))
         for (name, a, b), p in zip(shapes, parts)}
    mlp = {}
    for i, b in enumerate(config["mlp_dims"]):
        mlp[f"w{i}"] = w[f"mlp.w{i}"]
        mlp[f"b{i}"] = torch.zeros(b, device=dev)
    dense = {"mlp": mlp,
             "lin_bias": torch.zeros((), device=dev),
             "deep_out": {"w0": w["deep_out.w0"],
                          "b0": torch.zeros(1, device=dev)}}
    return {"embed": embed, "dense": dense}
