from .base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from .registry import get_config, list_archs

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "list_archs", "shape_applicable"]
