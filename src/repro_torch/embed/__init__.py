"""repro_torch.embed — where the embedding tables live and how they update."""

from .store import PLACEMENTS, EmbeddingStore, store_for
