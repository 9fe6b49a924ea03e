from .ops import (fused_cowclip_adam, reference, sparse_gather_catchup,
                  sparse_update_scatter)
from .ref import sparse_cowclip_adam_reference
