"""Mesh construction: the port's counterpart of ``repro.launch.mesh``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` whose dims
carry the reference's axis names (``pod``, ``data``, ``model``, and
``pipe`` for the pipeline).  It runs over NCCL on CUDA cards and over
gloo on the CPU: the device the caller names picks the backend, and the
default is ``cuda``.  A CUDA mesh never drops to gloo or to the CPU: with
no NCCL, or under a process group of another backend, it raises.

The process group comes from the launcher's environment (``torchrun``
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``), or from the caller, who may have joined one already.
With no launcher and a mesh of one device, a group of one process is
set up in memory.  A mesh whose size is not the world size raises.

:class:`AbstractMesh` names axes and sizes with no devices behind them:
the sharding rules compute production-size specs (16 x 16, 2 x 16 x 16)
against it with no process group.

Functions, not module constants: importing this module touches no
device and no process group.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


class AbstractMesh:
    """Axis names and sizes with no devices: ``shape`` maps name → size
    and ``axis_names`` keeps the order, as the reference's
    ``jax.sharding.AbstractMesh``."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             f"differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def _launched() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_process_group(device: torch.device | str | None = None) -> str:
    """Join the launcher's process group for ``device``'s type (None:
    ``cuda``), or set up one of a single process when there is no
    launcher; a group already up is kept.  Returns the backend.  A CUDA
    device needs NCCL: it raises where NCCL is missing or the group up
    is of another backend."""
    dev = torch.device(device if device is not None else "cuda")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh runs over NCCL, and this torch "
                               "build has no NCCL")
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device, and none "
                               "is visible; pass device='cpu' for gloo")
    if dist.is_initialized():
        have = dist.get_backend()
        if backend not in str(have):
            raise RuntimeError(f"a {dev.type} mesh runs over {backend}, but "
                               f"the process group up is {have}")
        return str(have)
    if dev.type == "cuda":
        # under torchrun each process takes its own card before NCCL starts
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if _launched():
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return backend


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device: torch.device | str | None = None) -> DeviceMesh:
    """A mesh of ``shape`` over ``axes`` on ``device``'s type (None:
    ``cuda``), rank ``r`` at row-major position ``r``.  With no process
    group and no launcher, only a mesh of one device can be made."""
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    size = math.prod(shape)
    if not dist.is_initialized() and not _launched() and size != 1:
        raise RuntimeError(
            f"a mesh of {size} devices needs {size} processes, and this is "
            f"one process with no launcher (world size 1): run it under "
            f"torchrun --nproc-per-node {size}")
    init_process_group(device)
    world = dist.get_world_size()
    if size != world:
        raise RuntimeError(f"mesh {shape} over {axes} has {size} devices, "
                           f"but the world size is {world}")
    dev_type = torch.device(device if device is not None else "cuda").type
    return DeviceMesh(dev_type, torch.arange(size).reshape(shape),
                      mesh_dim_names=tuple(axes))


def production_layout(*, multi_pod: bool = False
                      ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axes) of the production mesh: 16 x 16 ``data`` x ``model``
    (one pod, 256 devices) or 2 x 16 x 16 ``pod`` x ``data`` x ``model``
    (512)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device: torch.device | str | None = None
                         ) -> DeviceMesh:
    """16 x 16 single pod (256 devices) or 2 x 16 x 16 (512)."""
    return make_mesh(*production_layout(multi_pod=multi_pod), device=device)


def make_host_mesh(n_data: int | None = None, n_model: int = 1, *,
                   device: torch.device | str | None = None) -> DeviceMesh:
    """A ``data`` x ``model`` mesh over however many processes the group
    holds (one without a launcher)."""
    if n_data is None:
        init_process_group(device)
        n_data = dist.get_world_size() // n_model
    return make_mesh((n_data, n_model), ("data", "model"), device=device)
