"""repro_torch.sharding — spec inference rules for params, optimizer state
and decode caches (``specs``), and activation constraints that are no-ops
off a mesh (``act``), as in ``repro.sharding``."""

from .specs import (
    batch_spec,
    cache_spec,
    ctr_param_spec,
    infer_cache_shardings,
    infer_param_shardings,
    param_spec,
    to_placements,
)
