"""Input shapes and reduced smoke variants of the LM configurations.

The port's copy of ``repro.configs.base``: ``INPUT_SHAPES``,
``supports_long_context``, ``input_specs`` (the dry-run's stand-in
inputs) and ``reduce_config`` (the CPU-smoke variant: 2 layers a pattern
position, d_model 128, vocab 512, <= 4 experts, f32).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.lm import LMConfig
from ..models.moe import MoEConfig

INPUT_SHAPES = {
    "train_4k":    {"seq_len": 4_096,   "global_batch": 256, "step": "train"},
    "prefill_32k": {"seq_len": 32_768,  "global_batch": 32,  "step": "prefill"},
    "decode_32k":  {"seq_len": 32_768,  "global_batch": 128, "step": "decode"},
    "long_500k":   {"seq_len": 524_288, "global_batch": 1,   "step": "decode"},
}


def supports_long_context(cfg: LMConfig) -> bool:
    """long_500k needs a sub-quadratic mixer (or sliding-window attention);
    pure full-attention archs skip it."""
    kinds = set(cfg.block_pattern)
    if kinds <= {"rwkv6", "mamba2"}:
        return True          # O(1)-state mixers (+ zamba2's windowed shared attn)
    if "attn" in kinds and cfg.window is None:
        return False
    # local/global mix: global layers hold full KV, local ones a ring buffer
    return "local" in kinds


def input_specs(cfg: LMConfig, shape_name: str, *, device="meta",
                spec: dict | None = None) -> dict:
    """Stand-ins for every input of the shape's step function, made so
    that nothing is allocated: on the ``meta`` device, or, called inside a
    ``FakeTensorMode`` (the dry-run), fake tensors on ``device``.

    Train and prefill: ``{"tokens": [B, S] int32}`` and, for a frontend,
    ``"prefix_emb": [B, P, D]`` in the compute dtype. Decode: ``{"token":
    [B] int32, "cache": lm.init_cache(cfg, B, S), "cur_index": a 0-dim
    int64}``. ``spec`` stands in for ``INPUT_SHAPES[shape_name]`` (a
    reduced shape)."""
    from ..models import lm

    spec = spec or INPUT_SHAPES[shape_name]
    b, s = spec["global_batch"], spec["seq_len"]
    if spec["step"] in ("train", "prefill"):
        out = {"tokens": torch.zeros((b, s), dtype=torch.int32,
                                     device=device)}
        if cfg.frontend:
            out["prefix_emb"] = torch.zeros((b, cfg.n_prefix, cfg.d_model),
                                            dtype=cfg.dtype, device=device)
        return out
    # decode: one token, a seq_len cache and the cursor
    return {
        "token": torch.zeros((b,), dtype=torch.int32, device=device),
        "cache": lm.init_cache(cfg, b, s, device=device),
        "cur_index": torch.zeros((), dtype=torch.int64, device=device),
    }


def reduce_config(cfg: LMConfig) -> LMConfig:
    """Same family, toy size: 2 layers (pattern-preserving), d_model 128,
    4 heads, d_ff 256, vocab 512, <= 4 experts top <= 2, f32 — runs a
    forward on the CPU in seconds."""
    # keep one occurrence of each distinct kind, in order
    seen, pattern = set(), []
    for kind in cfg.block_pattern:
        if kind not in seen:
            seen.add(kind)
            pattern.append(kind)
    pattern = tuple(pattern[:2]) or ("attn",)

    kv_ratio = max(1, cfg.n_heads // cfg.n_kv_heads)
    n_heads = 4
    n_kv = max(1, n_heads // kv_ratio)
    moe = None
    if cfg.moe is not None:
        # capacity_factor high enough that smoke-scale batches never drop
        # tokens, so decode agrees with the forward (full-size configs
        # keep the realistic 1.25)
        moe = MoEConfig(
            n_experts=min(4, cfg.moe.n_experts),
            top_k=min(2, cfg.moe.top_k),
            capacity_factor=8.0,
        )
    return dataclasses.replace(
        cfg,
        n_layers=2 * len(pattern),
        d_model=128,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=32 if cfg.head_dim else None,
        d_ff=256,
        vocab_size=512,
        block_pattern=pattern,
        window=8 if cfg.window else None,
        moe=moe,
        n_prefix=8 if cfg.frontend else 0,
        compute_dtype="float32",
        remat=False,
        pad_attn_heads=0,
    )
