"""granite-moe-3b-a800m — IBM Granite 3.0 MoE family
[hf:ibm-granite/granite-3.0-1b-a400m-base].

MoE decoder: 32L, d_model 1536, 24 heads (GQA kv=8), per-expert d_ff 512,
vocab 49155, 40 experts top-8 routing.
"""

from ..models.lm import LMConfig
from ..models.moe import MoEConfig

CONFIG = LMConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    pad_attn_heads=16,     # 24 heads don't divide the 16-way model axis;
                           # pad (semantics-exact masking) to shard instead of
                           # replicating attention compute — EXPERIMENTS §Perf
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(n_experts=40, top_k=8, capacity_factor=1.25),
    act="swiglu",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
