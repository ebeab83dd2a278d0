"""RG-LRU scan ``h_t = a_t * h_{t-1} + x_t`` as a hand-written Hopper
kernel.

Source note.  Replaces the TPU kernel ``repro/kernels/rg_lru.py:
rg_lru_scan``: the carry in fp32 from ``h0`` (zeros when None), every
``h_t`` rounded to the input dtype, the final carry returned in fp32.
Every recurrent layer's prefill runs it
(``models/recurrent.py:rec_block``), at (B, T, W) = (1, prefill bucket,
lru_width).  It moves 6 bytes per element and does 2 FLOPs, so bytes
bound it: ``6·B·T·W + 8·B·W`` over the card's memory rate, about 30 µs
at B = 1, T = W = 4096 on an H100.  The kernel (``csrc/rg_lru.cu``)
gives each lane of a one-warp block one channel's carry in a register
and walks time through a four-stage ``cp.async`` ring of 64-step chunks
in shared memory; unlike the TPU kernel it takes any T and W.  The plain
version is :func:`repro_torch.kernels.ref.rg_lru_scan`.
"""
from __future__ import annotations

import torch

from . import _build, ref

# kernel launches since the last reset (``chip_smoke.py`` reads it)
launches = 0


def rg_lru_scan(x: torch.Tensor, a: torch.Tensor,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, a (B, T, W); h0 (B, W) or None → (h (B, T, W) in ``x.dtype``,
    h_T (B, W) in fp32).

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel or raises."""
    global launches
    ts = [t for t in (x, a, h0) if t is not None]
    if all(t.device.type == "cpu" for t in ts):
        return ref.rg_lru_scan(x, a, h0)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("rg_lru_scan: x, a, h0 must be on one CUDA device")
    if x.dtype != torch.bfloat16 or a.dtype != torch.bfloat16:
        raise TypeError(f"rg_lru_scan kernel takes bfloat16 x and a, got "
                        f"{x.dtype}/{a.dtype}")
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"rg_lru_scan: x {tuple(x.shape)} and a "
                         f"{tuple(a.shape)} must be one (B, T, W) shape")
    b, t, w = x.shape
    if h0 is not None and (h0.shape != (b, w) or h0.dtype != torch.float32):
        raise ValueError(f"rg_lru_scan: h0 must be ({b}, {w}) float32, got "
                         f"{tuple(h0.shape)} {h0.dtype}")
    if not all(u.is_contiguous() for u in ts):
        raise ValueError("rg_lru_scan kernel takes contiguous operands")
    h = torch.empty_like(x)
    if t == 0 or b == 0 or w == 0:
        return h, (torch.zeros((b, w), dtype=torch.float32, device=x.device)
                   if h0 is None else h0.clone())
    h_t = torch.empty((b, w), dtype=torch.float32, device=x.device)
    vec = int(w % 8 == 0 and x.data_ptr() % 16 == 0
              and a.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _build.lib().rt_rg_lru_scan(
            x.data_ptr(), a.data_ptr(),
            None if h0 is None else h0.data_ptr(), h.data_ptr(),
            h_t.data_ptr(), b, t, w, vec, stream)
    _build.check(rc, "rg_lru_scan")
    launches += 1
    return h, h_t
