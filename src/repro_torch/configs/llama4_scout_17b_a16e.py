"""llama4-scout-17b-a16e — Llama 4 Scout 17B-active, 16 experts
[hf:meta-llama/Llama-4-Scout-17B-16E].

MoE decoder: 48L, d_model 5120, 40 heads (GQA kv=8), per-expert d_ff 8192,
vocab 202048, 16 experts top-1 routing (early-fusion multimodal in the
original; assignment covers the text backbone).
"""

from ..models.lm import LMConfig
from ..models.moe import MoEConfig

CONFIG = LMConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    pad_attn_heads=16,     # 40 heads don't divide the 16-way model axis;
                           # pad (semantics-exact masking) to shard instead of
                           # replicating attention compute — EXPERIMENTS §Perf
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(n_experts=16, top_k=1, capacity_factor=1.25),
    act="swiglu",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
