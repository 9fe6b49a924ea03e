"""rwkv6-7b — RWKV-6 "Finch" 7B [arXiv:2404.05892].

Attention-free: 32L, d_model 4096, data-dependent-decay linear attention
(head size 64 -> 64 heads), channel-mix FFN dim 14336, vocab 65536.
A copy of ``repro.configs.rwkv6_7b``.
"""

from ..models.lm import LMConfig

CONFIG = LMConfig(
    name="rwkv6-7b",
    arch_type="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # head size 64
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("rwkv6",),
    source="arXiv:2404.05892",
)
