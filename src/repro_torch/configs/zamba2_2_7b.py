"""zamba2-2.7b — Zamba2: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

Hybrid: 54 Mamba2 layers (d_model 2560, ssm_state 64, head_dim 64), one
weight-SHARED attention+MLP block (32 heads, d_ff 10240) applied after every
6 Mamba layers (9 invocations). TPU adaptation documented in DESIGN.md: the
shared block uses a 4096-token sliding window so long_500k decode stays
sub-quadratic (original Zamba2 caps context instead); per-invocation LoRA
deltas on the shared block are omitted.
"""

from ..models.lm import LMConfig

CONFIG = LMConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    block_pattern=("mamba2",) * 6,
    shared_attn=True,
    window=4096,
    ssm_state=64,
    mamba_head_dim=64,
    source="arXiv:2411.15242",
)
