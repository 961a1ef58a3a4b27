"""Config registry: importing this package registers all architectures."""

from . import archs  # noqa: F401  (registration side effect)
from .base import (
    REGISTRY,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_archs,
    smoke_variant,
)

__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "REGISTRY",
    "get_config",
    "list_archs",
    "smoke_variant",
]
