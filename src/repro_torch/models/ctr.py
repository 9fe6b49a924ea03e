"""The paper's four CTR prediction models: W&D, DeepFM, DCN, DCN-v2.

A port of ``repro.models.ctr``, with the sparse placement's row-based
forward (``unique_batch``, ``gather_embed_rows``, ``apply_rows``). Functional, like
the reference: ``init(cfg, generator=...) -> params`` and ``apply(params,
cfg, ids, dense) -> logits``, over params split ``{"embed": ..., "dense":
...}`` for the two-group optimizer. The layout is the JAX package's: dense
weights are ``[in, out]`` and used as ``x @ w``, tables ``[vocab, dim]``,
so JAX params carry over leaf for leaf (``train.checkpoint
.params_from_numpy``). Initial values come from a ``torch.Generator`` and
differ from JAX's for the same seed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..core.tree import tree_map
from . import embedding


@dataclasses.dataclass(frozen=True)
class CTRConfig:
    name: str                      # "wd" | "deepfm" | "dcn" | "dcnv2"
    vocab_sizes: tuple             # per categorical field
    n_dense: int = 13
    emb_dim: int = 10
    mlp_dims: tuple = (400, 400, 400)
    n_cross: int = 3
    emb_sigma: float = 1e-4        # 1e-2 for CowClip's large-init variant
    # Legacy knob for the sparse unique-id placement (forward, backward and
    # update on [n_unique, dim] gathered rows); ``placement`` wins when set.
    sparse: bool = False
    # Padded capacity of each field's unique-id set; <= 0 means the exact
    # default min(batch, vocab_f). Smaller values bound memory but overflow:
    # the sparse placement then drops the gradient of the ids past the
    # capacity (see models/embedding.py).
    unique_capacity: int = 0
    # Embedding placement (repro_torch.embed.EmbeddingStore): one of
    # core.builders.TRAIN_PATHS; None defers to ``sparse`` ("sparse" when
    # set, else "substrate"), as in the reference.
    placement: str | None = None
    # Forward/backward compute dtype ("float32" | "bfloat16"): activations,
    # looked-up embeddings and dense weights are cast at use; masters,
    # CowClip statistics and Adam moments stay float32, logits return f32.
    compute_dtype: str = "float32"

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)

    @property
    def d0(self) -> int:
        """Cross/deep input width: flattened embeddings + dense feats."""
        return self.n_fields * self.emb_dim + self.n_dense


MODEL_NAMES = ("wd", "deepfm", "dcn", "dcnv2")


def _randn(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device)


def _dense_init(gen, fan_in, fan_out, device):
    """Kaiming-normal for ReLU towers (He et al. 2015, as in the paper)."""
    return _randn(gen, (fan_in, fan_out), device) * math.sqrt(2.0 / fan_in)


def _init_mlp(gen, dims: Sequence[int], device) -> dict:
    params = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = _dense_init(gen, din, dout, device)
        params[f"b{i}"] = torch.zeros((dout,), device=device)
    return params


def _apply_mlp(params: dict, x: torch.Tensor, n_layers: int) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def init(cfg: CTRConfig, *, generator: torch.Generator | None = None,
         seed: int = 0, device="cuda") -> dict:
    """Random params for ``cfg`` on ``device``, drawn from ``generator``
    (a fresh one seeded with ``seed`` when None); ``device="meta"``
    allocates nothing."""
    if cfg.name not in MODEL_NAMES:
        raise ValueError(f"unknown CTR model {cfg.name!r}")
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(
            device="cpu" if device.type == "meta" else device
        ).manual_seed(seed)

    embed = {"fm": embedding.init_field_tables(
        generator, cfg.vocab_sizes, cfg.emb_dim, sigma=cfg.emb_sigma,
        device=device)}
    dense: dict = {}
    dense["mlp"] = _init_mlp(generator, (cfg.d0,) + tuple(cfg.mlp_dims),
                             device)

    if cfg.name in ("wd", "deepfm"):
        # First-order LR stream: 1-dim embedding per field + global bias.
        embed["lin"] = embedding.init_field_tables(
            generator, cfg.vocab_sizes, 1, sigma=cfg.emb_sigma, device=device)
        dense["lin_bias"] = torch.zeros((), device=device)
        dense["deep_out"] = _init_mlp(generator, (cfg.mlp_dims[-1], 1),
                                      device)
    else:
        full = cfg.name == "dcnv2"
        shape = (cfg.d0, cfg.d0) if full else (cfg.d0,)
        dense["cross"] = {
            f"w{i}": _randn(generator, shape, device) / math.sqrt(cfg.d0)
            for i in range(cfg.n_cross)
        }
        dense["cross"].update({f"b{i}": torch.zeros((cfg.d0,), device=device)
                               for i in range(cfg.n_cross)})
        dense["combine"] = _init_mlp(
            generator, (cfg.d0 + cfg.mlp_dims[-1], 1), device)
    return {"embed": embed, "dense": dense}


def _fm_second_order(emb: torch.Tensor) -> torch.Tensor:
    """Factorization-machine pairwise term 0.5*((sum e)^2 - sum e^2). [B]"""
    s = emb.sum(dim=1)                     # [B, D]
    s2 = torch.square(emb).sum(dim=1)      # [B, D]
    return 0.5 * (torch.square(s) - s2).sum(dim=-1)


def _forward_from_emb(
    dense_params: dict,
    cfg: CTRConfig,
    emb: torch.Tensor,
    lin_emb: torch.Tensor | None,
    dense_feats: torch.Tensor,
) -> torch.Tensor:
    """Model combiner from looked-up embeddings -> logits [B] f32.

    ``emb`` is [B, F, D]; ``lin_emb`` the [B, F, 1] first-order stream for
    wd/deepfm (None otherwise). Under ``compute_dtype="bfloat16"`` every
    activation and dense weight is cast here and the logits cast back to
    f32, so the loss, its gradients and the optimizer stay f32.
    """
    dt = getattr(torch, cfg.compute_dtype)
    if dt != torch.float32:
        emb = emb.to(dt)
        lin_emb = None if lin_emb is None else lin_emb.to(dt)
        dense_feats = dense_feats.to(dt)
        dense_params = tree_map(lambda w: w.to(dt), dense_params)
    return _combine(dense_params, cfg, emb, lin_emb,
                    dense_feats).to(torch.float32)


def _combine(
    dense_params: dict,
    cfg: CTRConfig,
    emb: torch.Tensor,
    lin_emb: torch.Tensor | None,
    dense_feats: torch.Tensor,
) -> torch.Tensor:
    flat = emb.reshape(emb.shape[0], -1)
    x0 = torch.cat([flat, dense_feats], dim=-1)               # [B, d0]
    deep = torch.relu(_apply_mlp(dense_params["mlp"], x0, len(cfg.mlp_dims)))

    if cfg.name in ("wd", "deepfm"):
        lin = lin_emb[..., 0].sum(dim=1) + dense_params["lin_bias"]
        out = _apply_mlp(dense_params["deep_out"], deep, 1)[:, 0]
        if cfg.name == "wd":
            return lin + out
        return lin + _fm_second_order(emb) + out
    if cfg.name in ("dcn", "dcnv2"):
        x = x0
        cp = dense_params["cross"]
        for i in range(cfg.n_cross):
            if cfg.name == "dcn":
                # x_{l+1} = x0 * (x_l . w_l) + b_l + x_l
                x = x0 * (x @ cp[f"w{i}"])[:, None] + cp[f"b{i}"] + x
            else:
                # x_{l+1} = x0 ⊙ (W_l x_l + b_l) + x_l
                x = x0 * (x @ cp[f"w{i}"] + cp[f"b{i}"]) + x
        combined = torch.cat([x, deep], dim=-1)
        return _apply_mlp(dense_params["combine"], combined, 1)[:, 0]
    raise ValueError(cfg.name)


def apply(
    params: dict,
    cfg: CTRConfig,
    ids: torch.Tensor,
    dense_feats: torch.Tensor,
) -> torch.Tensor:
    """Forward pass -> logits [B] (sigmoid applied in the loss)."""
    dt = getattr(torch, cfg.compute_dtype)
    # the fm and LR tables read the same ids: one lookup, one backward call
    emb, *lin = embedding.lookup(_groups(params["embed"]), ids, dtype=dt)
    return _forward_from_emb(params["dense"], cfg, emb,
                             lin[0] if lin else None, dense_feats)


def _groups(embed: dict) -> list:
    """The embedding groups in lookup order: fm, then lin if present."""
    return [embed["fm"]] + ([embed["lin"]] if "lin" in embed else [])


def unique_batch(cfg: CTRConfig, ids: torch.Tensor) -> dict:
    """Per-field unique-id dedup for the sparse path: ``{"field_i":
    UniqueField}``. One dedup serves every embedding group (the fm and lin
    tables of a field see the same ids)."""
    return embedding.batch_unique(ids, cfg.vocab_sizes,
                                  capacity=cfg.unique_capacity)


def gather_embed_rows(params: dict, uniq: dict) -> dict:
    """Each embedding group's unique rows, shaped like ``params["embed"]``
    with ``[capacity_f, dim]`` leaves."""
    return {g: embedding.gather_rows(tables, uniq)
            for g, tables in params["embed"].items()}


def apply_rows(
    rows: dict,
    dense_params: dict,
    cfg: CTRConfig,
    uniq: dict,
    dense_feats: torch.Tensor,
) -> torch.Tensor:
    """Sparse forward: logits from gathered unique rows (the math of
    ``apply``; the gradient w.r.t. ``rows`` comes out ``[n_unique, dim]``
    per field instead of a full-table one)."""
    dt = getattr(torch, cfg.compute_dtype)
    emb, *lin = embedding.lookup_rows(_groups(rows), uniq, dtype=dt)
    return _forward_from_emb(dense_params, cfg, emb,
                             lin[0] if lin else None, dense_feats)


def batch_counts(cfg: CTRConfig, ids: torch.Tensor, params: dict) -> dict:
    """CowClip counts tree matching params['embed'] (fm and, if present, lin
    share the same per-field counts)."""
    c = embedding.field_counts(ids, cfg.vocab_sizes)
    tree = {"fm": c}
    if "lin" in params["embed"]:
        tree["lin"] = c
    return tree
