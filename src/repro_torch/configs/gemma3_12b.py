"""gemma3-12b — Gemma 3 family [hf:google/gemma-3-1b-pt].

Dense decoder with 5:1 local:global attention, 128k context: 48L,
d_model 3840, 16 heads (GQA kv=8, head_dim 256), d_ff 15360, vocab 262144.
Local layers use a 1024-token sliding window (ring KV cache at decode), so
long_500k decode is sub-quadratic compute / sub-full memory.
"""

from ..models.lm import LMConfig

CONFIG = LMConfig(
    name="gemma3-12b",
    arch_type="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    block_pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    rope_theta=1e6,
    act="swiglu",  # GeGLU in the original; same gated 3-matrix shape/FLOPs
    source="hf:google/gemma-3-1b-pt",
)
