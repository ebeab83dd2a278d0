"""GEMM + activation ``y = act(x @ w + b)`` as a hand-written Hopper
kernel: the paper's benchmark op.

Source note.  Replaces the TPU kernel ``repro/kernels/gemm_gelu.py:
gemm_act``: the pre-activation lives only in an fp32 accumulator tile, and
the bias and the activation are applied in fp32 in the epilogue before the
one rounding to ``x.dtype``.  On the serving path it is the up projection
of the partial-schedule MLP (``core/ftl/registry.py:_run_cuda_partial_mlp``),
which the planner picks for granite-20b's ungated gelu MLP on the ``h100``
target.  At granite's widths (6144 -> 24576) the work is compute-bound at
M = 2048 (6.2e11 FLOP against 428 MB) and bound by the 302 MB weight panel
at M = 128.  The kernel (``csrc/gemm_act.cu``) is the GEMM kernel's tile
loop (``csrc/gemm_tile.cuh``: 128 x 128 output tiles on ``mma.sync``
m16n8k16, K in steps of 32 through a two-stage ``cp.async`` ring, ragged
edges zero-filled and stored masked) with its own epilogue.  The plain
version is :func:`repro_torch.kernels.ref.gemm_act`.
"""
from __future__ import annotations

import torch

from . import _build, ref
from . import gemm as _gemm

# shared memory of one block: the GEMM kernel's tile loop
SMEM_BYTES = _gemm.SMEM_BYTES

# kernel launches since the last reset (``chip_smoke.py`` reads it)
launches = 0


def gemm_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
             *, act: str = "gelu") -> torch.Tensor:
    """``act(x (M, K) @ w (K, N) + b (N,))`` → (M, N) in ``x.dtype``;
    ``b`` may be None.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel or raises."""
    global launches
    ts = (x, w) if b is None else (x, w, b)
    if all(t.device.type == "cpu" for t in ts):
        return ref.gemm_act(x, w, b, act=act)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError(f"gemm_act: x on {x.device}, w on {w.device}"
                         f"{'' if b is None else f', b on {b.device}'}; "
                         f"all must be on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f"gemm_act kernel takes bfloat16, got "
                        f"{[str(t.dtype) for t in ts]}")
    if act not in ref.ACT_CODES:
        raise ValueError(f"gemm_act: unknown activation {act!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm_act: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"gemm_act: bias {tuple(b.shape)} for "
                         f"{w.shape[1]} columns")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("gemm_act kernel takes contiguous operands")
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    vec = int(k % 8 == 0 and n % 8 == 0 and _gemm._aligned(x, w))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _build.lib().rt_gemm_act(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), m, n, k, vec, ref.ACT_CODES[act], stream)
    _build.check(rc, "gemm_act")
    launches += 1
    return y
