"""Where the port's entry points run.

``init_params``, ``ServeEngine`` and the serve and train CLIs run on the
CUDA card unless the caller names another device; with no card and no
device named they raise instead of carrying on quietly on the CPU.
:func:`process_rank` says which process of a job this is (the data
pipeline's host shard, the checkpoint's file).
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


def process_rank() -> tuple[int, int]:
    """(rank, world size) of this process: ``torch.distributed``'s when a
    process group is up, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
