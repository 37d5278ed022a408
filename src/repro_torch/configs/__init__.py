"""Model configs: `ModelConfig` and one module per ported architecture."""
from repro_torch.configs.base import (
    ARCH_ALIASES,
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    all_configs,
    get_config,
    get_reduced,
)

__all__ = [
    "ARCH_ALIASES",
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "all_configs",
    "get_config",
    "get_reduced",
]
