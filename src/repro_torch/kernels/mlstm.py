"""The stabilised mLSTM scan (xLSTM) as a hand-written Hopper kernel.

Source note.  Replaces the TPU kernel ``repro/kernels/mlstm.py:
mlstm_scan``: per (batch, head), from ``C = 0, n = 0, m = 0``, the
matrix memory ``C`` (Dh × Dh), normaliser ``n`` and log-space stabiliser
``m`` carried in fp32, ``q̃ = q·Dh^-0.5`` in fp32, every ``h_t`` rounded
once to bf16.  With ``return_state`` it also returns the final ``C``,
``n`` and ``m`` in fp32 (what ``repro.kernels.ref.mlstm_scan(...,
return_state=True)`` computes): every mLSTM layer's prefill in serving
runs it so, and the stateless ``forward`` runs it without.  About
``5·Dh²`` fp32 operations a step and head against ``8·Dh`` bytes, so fp32
arithmetic bounds it: ``5·B·H·T·Dh²`` operations over the card's fp32
rate, about 0.64 ms at B = 1, H = 4, T = 2048, Dh = 1024 on an H100.  The
kernel (``csrc/mlstm.cu``) splits each head's C by rows across blocks
that never talk to each other: each warp keeps four rows of C and all of
n in its lanes' registers and reduces ``C·q̃`` and ``n·q̃`` with warp
shuffles; time is staged through a ``cp.async`` ring.  Unlike the TPU
kernel it takes any T.  The plain version is
:func:`repro_torch.kernels.ref.mlstm_scan`.
"""
from __future__ import annotations

import torch

from . import _build, ref

# kernel launches since the last reset (``chip_smoke.py`` reads it)
launches = 0

MAX_HEAD_DIM = 1024


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_pre: torch.Tensor, f_pre: torch.Tensor, *,
               return_state: bool = False):
    """q, k, v (B, H, T, Dh); i_pre, f_pre (B, H, T) → h (B, H, T, Dh) in
    ``q.dtype``, and with ``return_state`` also ``{"C": (B, H, Dh, Dh),
    "n": (B, H, Dh), "m": (B, H)}`` in fp32.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel or raises.  The kernel takes contiguous bf16 q, k, v, fp32
    gates and a head dim that is a multiple of 32 up to 1024."""
    global launches
    ts = (q, k, v, i_pre, f_pre)
    if all(t.device.type == "cpu" for t in ts):
        return ref.mlstm_scan(q, k, v, i_pre, f_pre,
                              return_state=return_state)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("mlstm_scan: q, k, v, i_pre, f_pre must be on one "
                         "CUDA device")
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v)) or \
            not all(t.dtype == torch.float32 for t in (i_pre, f_pre)):
        raise TypeError(f"mlstm_scan kernel takes bfloat16 q, k, v and "
                        f"float32 gates, got {q.dtype}/{k.dtype}/{v.dtype} "
                        f"and {i_pre.dtype}/{f_pre.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or \
            i_pre.shape != q.shape[:3] or f_pre.shape != q.shape[:3]:
        raise ValueError(f"mlstm_scan: q, k, v {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} must be one "
                         f"(B, H, T, Dh) shape and the gates "
                         f"{tuple(i_pre.shape)}, {tuple(f_pre.shape)} its "
                         f"(B, H, T)")
    b, h, t, dh = q.shape
    if dh % 32 or not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"mlstm_scan kernel takes a head dim that is a "
                         f"multiple of 32 up to {MAX_HEAD_DIM}, got {dh}")
    if b * h > 65535:
        raise ValueError(f"mlstm_scan kernel takes at most 65535 (batch, "
                         f"head) pairs, got {b * h}")
    if not all(u.is_contiguous() for u in ts) or \
            any(u.data_ptr() % 16 for u in (q, k, v)):
        raise ValueError("mlstm_scan kernel takes contiguous operands, "
                         "q, k, v 16-byte aligned")
    out = torch.empty_like(q)
    state = None
    if return_state:
        state = {"C": torch.empty((b, h, dh, dh), dtype=torch.float32,
                                  device=q.device),
                 "n": torch.empty((b, h, dh), dtype=torch.float32,
                                  device=q.device),
                 "m": torch.empty((b, h), dtype=torch.float32,
                                  device=q.device)}
    if t == 0 or b * h == 0:
        if state is not None:
            for s in state.values():
                s.zero_()
        return (out, state) if return_state else out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _build.lib().rt_mlstm_scan(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
            f_pre.data_ptr(), out.data_ptr(),
            *((state["C"].data_ptr(), state["n"].data_ptr(),
               state["m"].data_ptr()) if return_state
              else (None, None, None)),
            b * h, t, dh, stream)
    _build.check(rc, "mlstm_scan")
    launches += 1
    return (out, state) if return_state else out
