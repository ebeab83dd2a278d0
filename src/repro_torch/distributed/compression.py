"""Gradient compression for the data-parallel all-reduce: the port's
counterpart of ``repro.distributed.compression``.

int8 uniform quantization with **error feedback** (Seide et al. '14,
Karimireddy et al. '19): each step applies ``Q(g + e)`` and carries the
quantization residual ``e`` forward, which restores convergence to the
uncompressed trajectory.  The arithmetic is the reference's, rounding
half to even as ``jnp.round`` does, so every bit agrees.

* :func:`quantize`, :func:`dequantize`, :func:`ef_compress` and
  :func:`init_error`: pure functions, as the reference's.
* :func:`ef_compress_`: the same, in place, leaf by leaf, as the train
  step runs it (the temporaries are one leaf's ``q`` and ``dq``).  On
  sharded gradients each leaf's scale comes from its amax over all its
  shards (one ``all_reduce(MAX)`` for the whole tree), so the result is
  the reference's on the whole tensor.
* :func:`compressed_psum` and :func:`compressed_psum_tree`: the int8
  all-reduce over a process group, or a mesh dim by name: an fp32
  ``all_reduce(SUM)`` of each rank's dequantized int8, divided by the
  group's size.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

Params = dict[str, Any]

_Q = 127.0


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8; returns (q, scale).  The scale is taken
    in ``x``'s dtype, then cast to fp32, as the reference takes it."""
    return _quantize(x, torch.max(torch.abs(x)))


def _quantize(x: torch.Tensor, amax: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.where(amax > 0, amax / _Q, 1.0).float()
    # one fp32 temporary, rounded and clipped in place
    q = (x.float() / scale).round_().clamp_(-_Q, _Q).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _map2(fn, a, b):
    if isinstance(a, dict):
        out = {k: _map2(fn, a[k], b[k]) for k in a}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    return fn(a, b)


def ef_compress(grads: Params, error: Params) -> tuple[Params, Params]:
    """Error-feedback compression of a gradient tree: (the decompressed
    gradients to apply, the new error state)."""
    def one(g, e):
        target = g.float() + e
        q, s = quantize(target)
        dq = dequantize(q, s)
        return dq.to(g.dtype), target - dq

    return _map2(one, grads, error)


@torch.no_grad()
def ef_compress_(grads: list, errors: list, *, reduce_max: bool = False
                 ) -> None:
    """:func:`ef_compress` in place on fp32 ``grads`` and ``errors`` (two
    lists of leaves in one order): each error becomes the target ``g +
    e`` and then its residual, each gradient its decompressed target.
    ``reduce_max`` takes each leaf's amax over the default process group
    (the leaves are shards)."""
    amax = []
    for g, e in zip(grads, errors):
        e.add_(g)
        # max |e| with no leaf-sized temporary (exact, as any max is)
        amax.append(torch.linalg.vector_norm(e, float("inf")) if e.numel()
                    else torch.zeros((), dtype=e.dtype, device=e.device))
    if not amax:
        return
    amax = torch.stack(amax)
    if reduce_max and dist.get_world_size() > 1:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX)
    for g, e, a in zip(grads, errors, amax):
        if not e.numel():
            continue
        q, s = _quantize(e, a)
        dq = q.float().mul_(s)
        del q
        g.copy_(dq)
        e.sub_(dq)


def init_error(params: Params) -> Params:
    """Zero fp32 error state shaped like ``params``."""
    if isinstance(params, dict):
        return {k: init_error(v) for k, v in params.items()}
    return torch.zeros(params.shape, dtype=torch.float32,
                       device=params.device)


def _group(axis, mesh):
    if isinstance(axis, str):
        if mesh is None:
            raise ValueError(f"axis {axis!r} names a mesh dim: pass mesh=")
        return mesh.get_group(axis)
    return axis


def compressed_psum(x: torch.Tensor, axis=None, *, mesh=None
                    ) -> torch.Tensor:
    """int8 all-reduce mean of ``x`` over ``axis``: a process group (None:
    the default one) or the name of a dim of ``mesh``.  Each rank's
    dequantized int8 is summed in fp32 and divided by the group's
    size."""
    group = _group(axis, mesh)
    n = dist.get_world_size(group)
    q, s = quantize(x)
    summed = dequantize(q, s)
    dist.all_reduce(summed, group=group)
    return (summed / n).to(x.dtype)


def compressed_psum_tree(grads: Params, axis, error: Params, *, mesh=None
                         ) -> tuple[Params, Params]:
    """Error-feedback int8 all-reduce mean over a gradient tree: (the
    averaged gradients, each rank's new error)."""
    group = _group(axis, mesh)
    n = dist.get_world_size(group)

    def one(g, e):
        target = g.float() + e
        q, s = quantize(target)
        local_dq = dequantize(q, s)
        avg = local_dq.clone()
        dist.all_reduce(avg, group=group)
        return (avg / n).to(g.dtype), target - local_dq

    return _map2(one, grads, error)
