"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis: the port's
counterpart of ``repro.distributed.pipeline``.

Layers split into S stages placed on the ``pipe`` axis; M microbatches
stream through them.  Classic GPipe schedule: S + M - 1 ticks, bubble
fraction (S - 1) / (S + M - 1).

Each rank holds its own stage (the reference shards the stacked stage
dim over ``pipe``).  At tick t stage s runs microbatch t - s, when there
is one, and hands its output one stage forward with
``dist.batch_isend_irecv``; the last stage keeps the finished
microbatches, and a broadcast over the ``pipe`` group then gives them to
every rank, as the reference's ``psum`` of zeros from the other stages
does.  Activations keep one shape across stages.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .sharding import map_with_path

Params = dict[str, Any]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def stage_params(params_per_layer: list[Params], n_stages: int) -> Params:
    """Stack per-layer param trees into (S, layers_per_stage, ...)
    leaves."""
    n = len(params_per_layer)
    if n % n_stages:
        raise ValueError(f"{n} layers do not split into {n_stages} stages")
    per = n // n_stages
    return _stack([_stack(params_per_layer[s * per:(s + 1) * per])
                   for s in range(n_stages)])


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_stages + n_micro - 1)


def pipeline_forward(
    stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    staged_params: Params,
    x: torch.Tensor,
    *,
    mesh,
    axis: str = "pipe",
) -> torch.Tensor:
    """Run the GPipe schedule; returns the (M, micro_batch, ...) outputs
    on every rank.

    ``stage_fn(stage_params, act) -> act`` applies one stage's layers.
    ``staged_params``' leaves are DTensors sharded on their stage dim
    over ``axis`` (each rank's local ``(1, per_stage, ...)``), or whole
    ``(S, per_stage, ...)`` tensors, of which each rank takes its own
    stage.  ``x`` is the (M, micro_batch, ...) input, the same on every
    rank (or a DTensor, gathered whole).
    """
    n_stages = mesh.shape[mesh.mesh_dim_names.index(axis)]
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)

    def own(leaf):
        if isinstance(leaf, DTensor):
            return leaf.to_local()[0]
        if leaf.shape[0] != n_stages:
            raise ValueError(f"a staged leaf of {leaf.shape[0]} stages on "
                             f"a {n_stages}-stage {axis!r} axis")
        return leaf[stage]

    params = map_with_path(lambda _, t: own(t), staged_params)
    if isinstance(x, DTensor):
        x = x.full_tensor()
    m = x.shape[0]
    peer = {s: dist.get_global_rank(group, s) for s in range(n_stages)}
    out = torch.zeros_like(x)
    cur = torch.empty_like(x[0])
    for t in range(m + n_stages - 1):
        mb = t - stage                     # the microbatch this stage runs
        if stage > 0 and 0 <= mb < m:
            # the previous stage's output of this microbatch, sent last tick
            cur = torch.empty_like(x[0])
            for req in dist.batch_isend_irecv([dist.P2POp(
                    dist.irecv, cur, peer[stage - 1], group)]):
                req.wait()
        if 0 <= mb < m:
            y = stage_fn(params, x[mb] if stage == 0 else cur)
            if stage < n_stages - 1:
                for req in dist.batch_isend_irecv([dist.P2POp(
                        dist.isend, y.contiguous(), peer[stage + 1],
                        group)]):
                    req.wait()
            else:
                out[mb] = y
    if n_stages > 1:
        dist.broadcast(out, src=peer[n_stages - 1], group=group)
    return out
