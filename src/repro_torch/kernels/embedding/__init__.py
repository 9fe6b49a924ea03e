"""The deterministic embedding backward: CUDA kernel, plain version, and
the gather whose backward it is."""
from .ops import (FieldLayout, SortPlan, embedding_backward,
                  embedding_backward_groups, field_layout, gather_fields,
                  reference, reference_groups, sort_plan)
