"""Tiled GEMM ``y = x @ w`` as a hand-written Hopper kernel.

Source note.  Replaces the TPU kernel ``repro/kernels/gemm.py:gemm``
(fp32 accumulator, cast to ``x.dtype`` on the flush).  On the serving
path it carries the QKV/O projections of ``run_block``
(``core/ftl/executor_block.py:_project``).  At llama3.2-3b's projection
shapes (M = 1024, K = 3072, N = 3072 / 1024) the work is compute-bound on
an H100: ~2·M·N·K FLOP against ~25 MB of operands.  The kernel
(``csrc/gemm.cu``) computes 128 x 128 output tiles on the warp-level
tensor cores (``mma.sync`` m16n8k16, bf16 in, fp32 accumulate) and walks K
in steps of 32 through a two-stage ``cp.async`` ring so loads overlap the
multiply; ragged M / N / K edges load as zeros and store masked.  The
plain version is :func:`repro_torch.kernels.ref.gemm`.
"""
from __future__ import annotations

import torch

from . import _build, ref

# shared memory of one block (csrc/gemm_tile.cuh: As + Bs, two stages
# each)
BLOCK = (128, 128, 32)            # (block_m, block_n, block_k)
SMEM_BYTES = 2 * (128 * 40 + 32 * 136) * 2

# kernel launches since the last reset (``chip_smoke.py`` reads it)
launches = 0


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` (M, K) @ ``w`` (K, N) → (M, N) in ``x.dtype``.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel or raises."""
    global launches
    if x.device.type == "cpu" and w.device.type == "cpu":
        return ref.gemm(x, w)
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError(f"gemm: x on {x.device}, w on {w.device}; both "
                         f"must be on one CUDA device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"gemm kernel takes bfloat16, got {x.dtype} @ "
                        f"{w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemm kernel takes contiguous operands")
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    vec = int(k % 8 == 0 and n % 8 == 0 and _aligned(x, w))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _build.lib().rt_gemm(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                  m, n, k, vec, stream)
    _build.check(rc, "gemm")
    launches += 1
    return y
