"""Architecture registry of the PyTorch port: ``get_config("<arch-id>")``.

The port's own copy of ``repro.configs`` for the architectures it serves
so far.  Arch ids use the reference's dashes; module names use
underscores.
"""
from __future__ import annotations

import importlib

from .base import ModelConfig

_ARCH_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
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


__all__ = ["ARCHS", "ModelConfig", "get_config"]
