"""stablelm-3b — Stability AI StableLM 2 family [hf:stabilityai/stablelm-2-1_6b].

Dense decoder: 32L, d_model 2560, 32 heads (full MHA, kv=32), d_ff 6912,
vocab 50304.
"""

from ..models.lm import LMConfig

CONFIG = LMConfig(
    name="stablelm-3b",
    arch_type="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    act="swiglu",
    source="hf:stabilityai/stablelm-2-1_6b",
)
