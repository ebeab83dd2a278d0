"""Where the port's entry points run.

``init_params``, ``ServeEngine`` and the serve CLI run on the CUDA card
unless the caller names another device; with no card and no device named
they raise instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a :class:`torch.device`; None means ``cuda``, and
    raises when this process sees no CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the port runs on the card by "
            "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def torch_dtype(name: str) -> torch.dtype:
    """``torch.bfloat16`` for the config dtype name ``'bfloat16'``."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
