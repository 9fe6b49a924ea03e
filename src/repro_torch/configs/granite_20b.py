"""granite-20b — IBM Granite 20B Code [arXiv:2405.04324].

Dense GPT-BigCode-style decoder (GELU MLP): 52L, d_model 6144, 48 heads with MQA (kv=1),
d_ff 24576, vocab 49152.
"""

from ..models.lm import LMConfig

CONFIG = LMConfig(
    name="granite-20b",
    arch_type="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,          # MQA
    d_ff=24576,
    vocab_size=49152,
    act="gelu",
    source="arXiv:2405.04324",
)
