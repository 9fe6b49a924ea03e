"""repro_torch.configs — model configurations the port runs (see
registry.PORTED_ARCHS)."""

from .base import INPUT_SHAPES, reduce_config, supports_long_context
from .registry import ARCH_MODULES, ASSIGNED_ARCHS, get_config
