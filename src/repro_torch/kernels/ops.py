"""Public kernel API of the port: the dispatch.

Every op here:
  * with ``backend='auto'`` calls the kernel wrapper, which launches the
    CUDA kernel for a CUDA tensor and runs the plain version for a CPU
    tensor — the decision is the tensor's device, nothing else;
  * with ``backend='ref'`` runs the plain PyTorch version
    (:mod:`repro_torch.kernels.ref`): the layer-per-layer baseline.

Each kernel's block sizes come from its own shared-memory footprint
against the planning target's fast level: fixed tiles for ``gemm`` and
``flash_attention`` (the registry qualifies them on that footprint), a
planned F slice and cluster for the fused MLP
(:func:`repro_torch.kernels.fused_mlp.plan_blocks`, on ``target``).
"""
from __future__ import annotations

from typing import Literal

from repro_torch.core import hw as hwlib

from . import flash_attention as _flash
from . import fused_mlp as _fused
from . import gemm as _gemm
from . import ref as _ref

Backend = Literal["auto", "ref"]


def _check_backend(backend: str) -> None:
    if backend not in ("auto", "ref"):
        raise ValueError(f"backend must be 'auto' or 'ref', got {backend!r}")


def gemm(x, w, *, backend: Backend = "auto"):
    _check_backend(backend)
    if backend == "ref":
        return _ref.gemm(x, w)
    return _gemm.gemm(x, w)


def fused_mlp(x, w1, w2, wg=None, b1=None, b2=None, *, act: str = "gelu",
              backend: Backend = "auto",
              target: hwlib.Target | None = None):
    """Full fused MLP; ``x`` may have leading batch dims (flattened)."""
    _check_backend(backend)
    if backend == "ref":
        return _ref.mlp(x, w1, w2, wg, b1, b2, act=act)
    *lead, m, k = x.shape
    y = _fused.fused_mlp(x.reshape(-1, k).contiguous(), w1, w2, wg, b1, b2,
                         act=act, target=target)
    return y.reshape(*lead, m, w2.shape[1])


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              q_offset: int = 0, backend: Backend = "auto"):
    _check_backend(backend)
    if backend == "ref":
        return _ref.attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window, q_offset=q_offset)
