"""internvl2-26b — InternVL2 26B: InternViT-6B + InternLM2-20B
[arXiv:2404.16821].

Assignment covers the language backbone: 48L, d_model 6144, 48 heads
(GQA kv=8), d_ff 16384, vocab 92553. The InternViT vision tower + MLP
projector is a stub: ``input_specs`` provides precomputed patch embeddings
[B, 256, d_model].
"""

from ..models.lm import LMConfig

CONFIG = LMConfig(
    name="internvl2-26b",
    arch_type="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    act="swiglu",
    frontend="vision",
    n_prefix=256,
    source="arXiv:2404.16821",
)
