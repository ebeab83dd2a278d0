"""Tiled GEMM ``y = x @ w`` as a hand-written Hopper kernel.

Source note.  Replaces the TPU kernel ``repro/kernels/gemm.py:gemm``
(fp32 accumulator, cast to ``x.dtype`` on the flush).  On the serving
path it is granite-20b's MLP down projection
(``core/ftl/registry.py:_run_cuda_partial_mlp``, every prefill layer) and
the QKV/O projections of ``run_block``.  At M = 2048 the down projection
is compute-bound on an H100 (~2·M·N·K FLOP against ~428 MB of operands);
at a 128-row prefill bucket it is bound by the 302 MB weight panel.

The kernel (``csrc/gemm.cu`` over ``csrc/gemm_tile.cuh``) has two routes,
chosen here from shape and alignment alone (:func:`tma_ok`,
:func:`schedule`), never on whether a launch succeeds:

* ``tma`` — K and N multiples of 8 and both operands 16-byte aligned
  (what a TMA tensor map takes).  A persistent, warp-specialised loop: one
  producer warp keeps TMA loads of 128 x 64 tiles of x and 64 x BN tiles
  of w in flight through a 192 KB shared-memory ring, and two consumer
  warpgroups run ``wgmma`` on 128 x BN output tiles (BN = 128 or 256),
  walked in groups along M so that blocks running together share w's
  panels in L2.  Where the tiles are too few to fill the SMs (granite's
  MQA wk/wv, N = 128; a short prefill bucket) K is cut into ``split_k``
  ranges whose fp32 partials a second launch sums in a fixed order before
  the epilogue: deterministic, no atomics.
* ``mma.sync`` — anything else (K or N not a multiple of 8, an unaligned
  view): one 128 x 128 tile per block on ``mma.sync`` m16n8k16 with
  element-wise loads, ragged edges zero-filled.

The plain version is :func:`repro_torch.kernels.ref.gemm`.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from . import _build, ref

BLOCK_M, BLOCK_K = 128, 64       # the TMA route's tile rows and k step
BLOCK_N = (256, 128)             # its tile widths, the wider preferred
SYNC_BLOCK = 128                 # the mma.sync route's square tile
# dynamic shared memory of one block on the TMA route (csrc/gemm_tile.cuh:
# a 192 KB ring, 256 B of mbarriers, 1 KB to align the ring for the
# 128-byte swizzle); the mma.sync route takes 38 KB of static memory
SMEM_BYTES = 192 * 1024 + 256 + 1024
H100_SMS = 132
MIN_SPLIT_STEPS = 4              # k steps a split range holds at least
MAX_SPLIT = 16
# published peaks of one H100 SXM, which the schedule's estimate divides
# by: bf16 tensor-core FLOP/s of one SM, HBM bytes/s
SM_FLOPS = 989e12 / H100_SMS
HBM_BPS = 3.35e12

# kernel launches since the last reset (``chip_smoke.py`` reads it); one a
# call, also where split-K adds the reduction's launch
launches = 0


@dataclasses.dataclass(frozen=True)
class Schedule:
    """What the launcher runs: the route (``"tma"`` or ``"mma.sync"``), the
    tile width, the number of K ranges, the blocks launched and the bytes
    of the fp32 partials' workspace."""
    route: str
    block_n: int
    split_k: int
    grid: int
    workspace_bytes: int

    @property
    def label(self) -> str:
        return (f"tma+splitk={self.split_k}" if self.split_k > 1
                else self.route)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tma_ok(k: int, n: int, *ptrs: int) -> bool:
    """Whether a TMA tensor map takes the operands: row pitches (K and N
    bf16) multiples of 16 bytes and every base pointer 16-byte aligned."""
    return k > 0 and k % 8 == 0 and n % 8 == 0 and all(
        p % 16 == 0 for p in ptrs)


def k_ranges(k: int, split: int) -> list[tuple[int, int]]:
    """The K range of each split, in elements, as the kernel cuts it: the
    ``ceil(k / BLOCK_K)`` k steps shared out evenly, range s being steps
    [s·steps // split, (s + 1)·steps // split)."""
    steps = _cdiv(k, BLOCK_K)
    return [(s * steps // split * BLOCK_K,
             min((s + 1) * steps // split * BLOCK_K, k))
            for s in range(split)]


def _estimate_s(m: int, n: int, steps: int, bn: int, split: int,
                tiles: int, sms: int) -> float:
    """Seconds the TMA route would take at the tensor cores' peak: the
    busiest SM's units (whole waves of tiles · split) of 128 x bn x
    ceil(steps / split) · 64 products, plus the partials written and read
    back through HBM once."""
    waves = _cdiv(tiles * split, sms)
    t = waves * 2 * BLOCK_M * bn * BLOCK_K * _cdiv(steps, split) / SM_FLOPS
    if split > 1:
        t += 2 * split * m * n * 4 / HBM_BPS
    return t


def schedule(m: int, n: int, k: int, *, tma: bool = True,
             sms: int = H100_SMS, block_n: int | None = None) -> Schedule:
    """The launch for an (m, k) @ (k, n) product on ``sms`` SMs.

    ``tma`` (from :func:`tma_ok`) false: the mma.sync route, one block a
    128 x 128 tile.  Otherwise the tile width (``block_n`` if given) and
    split with the least estimate (:func:`_estimate_s`), fewer splits and
    then the wider tile on a tie; K is split only where the tiles alone
    leave SMs idle, into at most MAX_SPLIT ranges of at least
    MIN_SPLIT_STEPS k steps.  The grid is persistent: min(units, sms)."""
    if not tma:
        return Schedule("mma.sync", SYNC_BLOCK, 1,
                        _cdiv(m, BLOCK_M) * _cdiv(n, SYNC_BLOCK), 0)
    steps = _cdiv(k, BLOCK_K)
    best = None
    for bn in BLOCK_N if block_n is None else (block_n,):
        tiles = _cdiv(m, BLOCK_M) * _cdiv(n, bn)
        top = 1 if tiles >= sms else max(1, min(
            steps // MIN_SPLIT_STEPS, MAX_SPLIT))
        for split in range(1, top + 1):
            key = (_estimate_s(m, n, steps, bn, split, tiles, sms), split)
            if best is None or key < best[0]:
                best = (key, bn, split, tiles)
    _, bn, split, tiles = best
    return Schedule("tma", bn, split, min(tiles * split, sms),
                    split * m * n * 4 if split > 1 else 0)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(x: torch.Tensor, w: torch.Tensor) -> Schedule:
    """The schedule the wrappers launch for CUDA operands ``x @ w``."""
    m, k = x.shape
    n = w.shape[1]
    return schedule(m, n, k, tma=tma_ok(k, n, x.data_ptr(), w.data_ptr()),
                    sms=sm_count(x.device.index))


def workspace(s: Schedule, like: torch.Tensor) -> torch.Tensor | None:
    """The fp32 partials of a split-K schedule, else None."""
    if s.split_k == 1:
        return None
    return torch.empty(s.workspace_bytes // 4, dtype=torch.float32,
                       device=like.device)


def run_schedule(x: torch.Tensor, w: torch.Tensor,
                 s: Schedule) -> torch.Tensor:
    """``x @ w`` by the kernel on schedule ``s``, for checked CUDA operands
    (what :func:`gemm` launches with ``plan(x, w)``; ``chip_smoke.py``
    times other schedules with it).  Counts no launch."""
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ws = workspace(s, x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _build.lib().rt_gemm(
            x.data_ptr(), w.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), m, n, k,
            int(s.route == "tma"), s.block_n, s.split_k, s.grid, stream)
    _build.check(rc, "gemm")
    return y


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` (M, K) @ ``w`` (K, N) → (M, N) in ``x.dtype``.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel or raises."""
    global launches
    if x.device.type == "cpu" and w.device.type == "cpu":
        return ref.gemm(x, w)
    _build.no_backward("gemm", x, w)
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
    if x.shape[0] == 0 or w.shape[1] == 0:
        return torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                           device=x.device)
    y = run_schedule(x, w, plan(x, w))
    launches += 1
    return y
