from .ops import fused_cowclip_adam, reference
