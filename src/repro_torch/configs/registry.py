"""--arch registry: id -> ModelConfig."""
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, reduced
from repro_torch.configs.xlstm_350m import CONFIG as XLSTM_350M
from repro_torch.configs.whisper_large_v3 import CONFIG as WHISPER_LARGE_V3
from repro_torch.configs.llava_next_mistral_7b import CONFIG as LLAVA_NEXT_MISTRAL_7B
from repro_torch.configs.recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B
from repro_torch.configs.phi3_mini_3_8b import CONFIG as PHI3_MINI_3_8B
from repro_torch.configs.llama3_2_1b import CONFIG as LLAMA3_2_1B
from repro_torch.configs.granite_20b import CONFIG as GRANITE_20B
from repro_torch.configs.stablelm_12b import CONFIG as STABLELM_12B
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as LLAMA4_MAVERICK
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B

ARCHS = {
    c.name: c
    for c in [
        XLSTM_350M, WHISPER_LARGE_V3, LLAVA_NEXT_MISTRAL_7B, RECURRENTGEMMA_9B,
        PHI3_MINI_3_8B, LLAMA3_2_1B, GRANITE_20B, STABLELM_12B,
        LLAMA4_MAVERICK, GRANITE_MOE_3B,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def cells():
    """All (arch, shape) dry-run cells, with skip reasons for ineligible ones."""
    out = []
    for a, cfg in ARCHS.items():
        for s, shp in SHAPES.items():
            skip = None
            if s == "long_500k" and not cfg.supports_long_context:
                skip = "full-attention arch: long_500k needs sub-quadratic attention"
            out.append((a, s, skip))
    return out


__all__ = ["ARCHS", "SHAPES", "get_arch", "get_shape", "reduced", "cells"]
