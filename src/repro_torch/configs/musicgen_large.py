"""musicgen-large — decoder-only LM over EnCodec tokens [arXiv:2306.05284].

Backbone only (per assignment): 48L, d_model 2048, 32 heads (kv=32),
d_ff 8192, vocab 2048 (EnCodec codebook). The audio conditioning frontend is
a stub: ``input_specs`` provides precomputed conditioning-frame embeddings
[B, 256, d_model]. GELU FFN (MusicGen uses a standard transformer).
"""

from ..models.lm import LMConfig

CONFIG = LMConfig(
    name="musicgen-large",
    arch_type="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    frontend="audio",
    n_prefix=256,
    source="arXiv:2306.05284",
)
