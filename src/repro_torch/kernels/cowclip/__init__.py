from .cowclip import StepScalars, step_scalars
from .ops import (fused_cowclip_adam, reference, sparse_gather_catchup,
                  sparse_gather_catchup_tables, sparse_update_scatter,
                  sparse_update_scatter_tables)
from .ref import sparse_cowclip_adam_reference
