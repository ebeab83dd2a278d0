"""Architecture registry of the PyTorch port: ``get_config("<arch-id>")``.

The port's own copy of ``repro.configs``: every architecture of the
reference, and the shape cells.  Arch ids use the reference's dashes; module names use
underscores.
"""
from __future__ import annotations

import importlib

from .base import ModelConfig
from .shapes import SHAPES, ShapeSpec, get_shape

_ARCH_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "granite-20b": "granite_20b",
    "xlstm-1.3b": "xlstm_1_3b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "yi-6b": "yi_6b",
    "qwen2-72b": "qwen2_72b",
    "whisper-base": "whisper_base",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
}

ARCHS: tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    try:
        mod = _ARCH_MODULES[name]
    except KeyError as e:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(ARCHS)}"
        ) from e
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


__all__ = [
    "ARCHS", "ModelConfig", "SHAPES", "ShapeSpec", "get_config", "get_shape",
]
