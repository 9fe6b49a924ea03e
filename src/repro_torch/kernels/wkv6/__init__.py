"""The chunked RWKV-6 WKV scan: CUDA kernel, plain versions, wrapper."""
from .ops import reference, wkv6
from .ref import (chunked_wkv6_reference, clipped_chunks,
                  segmented_wkv6_reference, wkv6_reference)
