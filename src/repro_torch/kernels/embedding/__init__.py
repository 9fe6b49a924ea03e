"""The deterministic embedding backward: CUDA kernel, plain version, and
the gather whose backward it is."""
from .ops import (FieldLayout, embedding_backward, gather_fields, field_layout,
                  reference)
