from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, reduced
from repro_torch.configs.registry import ARCHS, get_arch, get_shape, cells

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "reduced",
    "ARCHS", "get_arch", "get_shape", "cells",
]
