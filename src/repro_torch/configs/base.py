"""Input shapes and reduced smoke variants of the LM configurations.

The port's copy of ``repro.configs.base`` without ``input_specs``, which
feeds JAX's ahead-of-time lowering: ``INPUT_SHAPES``,
``supports_long_context`` and ``reduce_config`` (the CPU-smoke variant:
2 layers, d_model 128, vocab 512, f32).
"""

from __future__ import annotations

import dataclasses

from ..models.lm import NOT_PORTED_LM, LMConfig

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


def reduce_config(cfg: LMConfig) -> LMConfig:
    """Same family, toy size: 2 layers (pattern-preserving), d_model 128,
    4 heads, d_ff 256, vocab 512, f32 — runs a forward on the CPU in
    seconds. MoE configs raise: MoE is not ported."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE is not ported to repro_torch yet: "
            f"{NOT_PORTED_LM}")
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
        moe=None,
        n_prefix=8 if cfg.frontend else 0,
        compute_dtype="float32",
        remat=False,
        pad_attn_heads=0,
    )
