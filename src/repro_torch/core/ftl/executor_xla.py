"""Portable execution of FTL plans as PyTorch token-tiled loops.

The CUDA kernels (``src/repro_torch/kernels``) are the card-native
executors of a :class:`TilePlan`.  This module is the portable fallback
(the counterpart of the reference's ``lax.scan`` executors): it runs the
same fused schedule as a Python loop over token tiles, so the
intermediate ``(tile_m, d_ff)`` block is the only live instance of the MLP
hidden state.  Peak activation memory drops from O(M·d_ff) to
O(tile_m·d_ff); traffic does not, since every tile's hidden block still
goes through device memory between the two products — the paper's case
for explicit fusion.  Registered as the ``torch_*`` executors.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .plan import TilePlan

_ACTS: dict[str, Callable] = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,
    "silu": F.silu,
    "relu": F.relu,
    "identity": lambda x: x,
}


def activation(name: str) -> Callable:
    try:
        return _ACTS[name]
    except KeyError as e:
        raise ValueError(f"unknown activation {name!r}") from e


def _tiles(x: torch.Tensor, tile_m: int):
    m = x.shape[-2]
    if m % tile_m != 0:
        raise ValueError(f"tile_m={tile_m} does not divide M={m}")
    return [x[..., i:i + tile_m, :] for i in range(0, m, tile_m)]


def _up(xm, w1, wg, b1, act_f):
    h = xm @ w1
    if b1 is not None:
        h = h + b1
    h = act_f(h)
    if wg is not None:
        h = h * (xm @ wg)
    return h


def mlp_scan(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
             wg: torch.Tensor | None = None, b1: torch.Tensor | None = None,
             b2: torch.Tensor | None = None, *, act: str = "gelu",
             tile_m: int) -> torch.Tensor:
    """Fused-schedule MLP: loop over tiles of the token dim.

    ``x``: (..., M, K);  ``w1``/``wg``: (K, F);  ``w2``: (F, N).
    ``tile_m`` must divide M (the FTL solver only emits divisors)."""
    act_f = activation(act)
    ys = []
    for xm in _tiles(x, tile_m):
        y = _up(xm, w1, wg, b1, act_f) @ w2
        if b2 is not None:
            y = y + b2
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=-2)


def mlp_partial_scan(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                     wg: torch.Tensor | None = None,
                     b1: torch.Tensor | None = None,
                     b2: torch.Tensor | None = None, *, act: str = "gelu",
                     tile_m: int) -> torch.Tensor:
    """Partial-schedule MLP: up projection (+gate+act) looped over token
    tiles, hidden tensor materialized once, down GEMM un-tiled."""
    act_f = activation(act)
    h = torch.cat([_up(xm, w1, wg, b1, act_f).to(x.dtype)
                   for xm in _tiles(x, tile_m)], dim=-2)
    y = h @ w2
    if b2 is not None:
        y = y + b2
    return y.to(x.dtype)


def mlp_from_plan(plan: TilePlan, x: torch.Tensor, w1: torch.Tensor,
                  w2: torch.Tensor, wg: torch.Tensor | None = None,
                  b1: torch.Tensor | None = None,
                  b2: torch.Tensor | None = None, *,
                  act: str = "gelu") -> torch.Tensor:
    """Execute an ``fusion.mlp`` plan with the loop executor (M tiling)."""
    return mlp_scan(x, w1, w2, wg, b1, b2, act=act, tile_m=plan.tile("M"))
