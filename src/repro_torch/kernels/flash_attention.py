"""Flash (online-softmax) attention as a hand-written Hopper kernel.

Source note.  Replaces the TPU kernel
``repro/kernels/flash_attention.py:flash_attention``: GQA (q-head h reads
kv-head ``h // (Hq / Hk)``), causal and local-window masks, a query
position offset, the -1e30 mask constant with zero guards so a fully
masked row gives zeros, q·k and the softmax statistics in fp32, P rounded
to the input dtype before P·V.  Every prefill runs it
(``models/layers.py:attention_prefill``), and so does ``run_block``.  At
the serving prefill lengths (T ≤ 1024, Dh = 128) one head's work is small,
so latency and occupancy bound it; at long T it turns compute-bound.  The
kernel (``csrc/flash_attention.cu``) gives each 64-query tile of a head
one block of four warps; each warp keeps its running max / sum and output
accumulator in registers, and its 16 rows' Q fragments too at Dh ≤ 128
(at Dh = 256 they come from the Q tile in shared memory at every k step:
the output accumulator alone takes 128 registers a thread), turns the S
accumulators into P fragments without a trip through shared memory, and
streams 64-key tiles of K and V through a two-stage ``cp.async`` ring.
Key tiles the causal or window mask hides from the whole query tile are
skipped; ragged Tq / Tk are zero-filled and masked.  The plain version is
:func:`repro_torch.kernels.ref.attention`.
"""
from __future__ import annotations

import torch

from . import _build, ref

BLOCK = (64, 64)                  # (block_q, block_k)
HEAD_DIMS = (64, 128, 256)


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block: Q tile + two K and two V
    tiles, rows padded by 8 (csrc/flash_attention.cu: launch)."""
    bq, bk = BLOCK
    return (bq + 4 * bk) * (head_dim + 8) * 2


# kernel launches since the last reset (``chip_smoke.py`` reads it)
launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, Tq, Dh), k/v (B, Hk, Tk, Dh) → (B, Hq, Tq, Dh).

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel or raises."""
    global launches
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if not all(t.is_cuda and t.device == q.device for t in (k, v)) \
            or not q.is_cuda:
        raise ValueError("flash_attention: q, k, v must be on one CUDA "
                         "device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"flash_attention kernel takes bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, tq, dh = q.shape
    _, hk, tk, dk = k.shape
    if k.shape[0] != b or dk != dh or hq % hk:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {dh}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got "
                         f"{q_offset}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes contiguous, "
                         "16-byte aligned q, k, v")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _build.lib().rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, hq, hk, tq, tk, dh, int(causal),
            0 if window is None else int(window), int(q_offset), stream)
    _build.check(rc, "flash_attention")
    launches += 1
    return o
