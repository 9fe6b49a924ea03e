"""repro_torch.configs — the model configurations of the JAX package
(see registry.ARCH_MODULES)."""

from .base import (INPUT_SHAPES, input_specs, reduce_config,
                   supports_long_context)
from .registry import ARCH_MODULES, ASSIGNED_ARCHS, get_config
