"""repro_torch.serve: CTR scoring on a captured CUDA graph, the request
micro-batcher and the hot-id embedding cache (a port of ``repro.serve``),
and LM greedy decoding (``serve.decode``: RWKV-6 and the attention
archs).

* ``engine``: ``ServingEngine``, a fixed-shape forward captured once over
  a flush-applied dense snapshot of any placement's checkpoint.
* ``batcher``: ``MicroBatcher``, coalescing concurrent score requests
  into one fixed-shape dispatch under a max-wait deadline.
* ``hotcache``: ``HotEmbeddingCache``, the hot ids' rows on the card over
  the full tables in host memory, exact against the uncached forward.
"""

from .batcher import MicroBatcher
from .engine import ServingEngine, make_logits_fn, padded_score_loop
from .hotcache import HotEmbeddingCache, id_frequencies

__all__ = [
    "HotEmbeddingCache",
    "MicroBatcher",
    "ServingEngine",
    "id_frequencies",
    "make_logits_fn",
    "padded_score_loop",
]
