"""deepseek-coder-33b — DeepSeek Coder 33B [arXiv:2401.14196].

Dense llama-arch: 62L, d_model 7168, 56 heads (GQA kv=8), d_ff 19200,
vocab 32256.
"""

from ..models.lm import LMConfig

CONFIG = LMConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    pad_attn_heads=16,     # 56 heads don't divide the 16-way model axis;
                           # pad (semantics-exact masking) to shard instead of
                           # replicating attention compute — EXPERIMENTS §Perf
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    act="swiglu",
    source="arXiv:2401.14196",
)
