"""GEMM + activation ``y = act(x @ w + b)`` as a hand-written Hopper
kernel: the paper's benchmark op.

Source note.  Replaces the TPU kernel ``repro/kernels/gemm_gelu.py:
gemm_act``: the pre-activation lives only in fp32 (accumulator registers,
or split-K partials), and the bias and the activation are applied in fp32
to the whole sum before the one rounding to ``x.dtype``.  On the serving
path it is the up projection of the partial-schedule MLP
(``core/ftl/registry.py:_run_cuda_partial_mlp``), which the planner picks
for granite-20b's ungated gelu MLP on the ``h100`` target.  At granite's
widths (6144 -> 24576) the work is compute-bound at M = 2048 (6.2e11 FLOP
against 428 MB) and bound by the 302 MB weight panel at M = 128.  The
kernel (``csrc/gemm_act.cu``) runs the GEMM kernel's loops
(``csrc/gemm_tile.cuh``) with its own epilogue, on the route, tile width,
split and grid that :func:`repro_torch.kernels.gemm.schedule` picks from
shape and alignment: TMA + ``wgmma`` for operands a TMA tensor map takes,
split along K where the tiles are too few to fill the SMs (the epilogue
then runs in the reduction, after the sum: gelu of a sum is not the sum
of gelus), ``mma.sync`` for the rest.  The plain version is
:func:`repro_torch.kernels.ref.gemm_act`.
"""
from __future__ import annotations

import torch

from . import _build, ref
from . import gemm as _gemm

# shared memory of one block: the GEMM kernel's tile loops
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
    _build.no_backward("gemm_act", *ts)
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
    if x.shape[0] == 0 or w.shape[1] == 0:
        return torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                           device=x.device)
    y = run_schedule(x, w, b, act, _gemm.plan(x, w))
    launches += 1
    return y


def run_schedule(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                 act: str, s: _gemm.Schedule) -> torch.Tensor:
    """``act(x @ w + b)`` by the kernel on schedule ``s``, for checked CUDA
    operands (what :func:`gemm_act` launches with ``gemm.plan(x, w)``;
    ``chip_smoke.py`` times other schedules with it).  Counts no
    launch."""
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ws = _gemm.workspace(s, x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _build.lib().rt_gemm_act(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), None if ws is None else ws.data_ptr(), m, n, k,
            ref.ACT_CODES[act], int(s.route == "tma"), s.block_n,
            s.split_k, s.grid, stream)
    _build.check(rc, "gemm_act")
    return y
