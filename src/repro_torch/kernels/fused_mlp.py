"""Fused MLP ``y = act(x@w1 + b1) [⊙ (x@wg)] @ w2 + b2`` as a
hand-written Hopper kernel — the paper's fusion, whose (M, d_ff) hidden
tensor never reaches device memory.

Source note.  Replaces the TPU kernel ``repro/kernels/fused_mlp.py:
fused_mlp``: fp32 accumulation, h rounded to ``x.dtype`` before the second
product, b2 added in fp32 on the flush.  Under ``ftl_mode="fused"`` every
MLP of the serving path runs it, at M = the prefill bucket and at M =
slots during decode.  On an H100 the prefill case (M = 1024, llama3.2-3b
widths) is compute-bound (~155 GFLOP, ~156 us at the bf16 peak) and the
decode case bound by the 151 MB of weights (~45 us at 3.35 TB/s).

Dataflow (``csrc/fused_mlp.cu``).  The TPU kernel keeps N whole and
carries a (block_m, N) fp32 accumulator across the F grid axis; at
N = 3072 that is 768 KiB even at block_m = 64, beyond the 227 KiB of
shared memory a Hopper block may claim, and Hopper blocks run in no order,
so nothing carries between them.  This kernel splits F across blocks:
block (i, s) computes the hidden slice h[M tile i, F slice s] into shared
memory on ``wgmma`` (a producer warp keeps TMA loads of x, w1, wg and then
w2 tiles in flight through one mbarrier ring; one consumer warpgroup per
64 rows), multiplies it by the matching rows of w2 one 256-wide N chunk at
a time and stores each chunk's fp32 partial.  The partials are summed in
the same kernel: helper warps count each stored chunk on an arrival
counter, and the block whose arrival completes a chunk's count adds the
F / BF partials in slice order, adds b2 in fp32 and writes y, so y is
bit-identical from launch to launch (:func:`sum_partials` is the plain
form of that sum).  One launch a call: the counters are zeroed once and
every launch leaves them zero.  Tiling N and recomputing h per N chunk
instead would redo the up projections N / 256 times.

What runs is decided here, in pure Python (:func:`schedule`): the M tile
(64 rows up to M = 256, else 128), the F slice, the hidden chunk, the
ring's depth (as many slots as shared memory holds beside h), the grid and
the scratch bytes.  At decode the slice is the narrowest 128-wide multiple
that keeps the grid within half the SMs; at prefill it is the slice with
the least estimated time, counting wave quantisation, the ring's depth and
the partials' bytes, an estimate fitted to the card's times.  The plain
version is :func:`repro_torch.kernels.ref.mlp`.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import hw as hwlib
from repro_torch.core.ftl.solver import InfeasibleError

from . import _build, ref
from .gemm import H100_SMS, HBM_BPS, SM_FLOPS, sm_count

BLOCK_M = (64, 128)               # M tile heights: one or two consumers
HIDDEN_CHUNK = (64, 128)          # hidden columns an up-phase pass holds
BLOCK_N = 256                     # N chunk of the down phase and the sum
ROWS = 64                         # rows an arrival counter covers
F_ALIGN = 64                      # lattice of the F slice width
BOX = 64 * 64 * 2                 # one 64 x 64 bf16 TMA box
MIN_STAGES, MAX_STAGES = 2, 8     # ring slots the kernel takes
BAR_BYTES = 512                   # the ring's and the count queue's mbarriers
SMEM_LIMIT = 232_448              # dynamic shared memory a block may use
GROUP_M = 8                       # M tiles the grid walks slice by slice
# The prefill estimate (:func:`_estimate_s`), fitted to the kernel's times
# measured on an H100 at llama3.2-3b's and recurrentgemma-9b's widths:
# the products run at EFFICIENCY[block_m] of the tensor cores' peak,
# slowed by DEPTH_COST[stages] where the ring is shallow, and the fp32
# partials cost PARTIAL_COST times their bytes (written and read) at the
# HBM rate, beside the products rather than under them.
EFFICIENCY = {64: 0.45, 128: 0.5}
DEPTH_COST = {2: 1.1, 3: 1.05}
PARTIAL_COST = 1.5


def stage_bytes(block_m: int, hidden_chunk: int, gated: bool) -> int:
    """One ring slot: an up-phase step (a block_m x 64 tile of x and the
    64 x hidden_chunk tiles of w1 and wg) or a down-phase step (a 64 x
    BLOCK_N tile of w2), whichever is larger."""
    up = block_m * 128 + (2 if gated else 1) * hidden_chunk // 64 * BOX
    return max(up, BLOCK_N // 64 * BOX)


def smem_bytes(block_m: int, block_f: int, hidden_chunk: int, stages: int,
               gated: bool) -> int:
    """Dynamic shared memory of one block: the 1 KB that aligns it to the
    128-byte swizzle, the (block_m, block_f) bf16 hidden slice, the ring
    and its barriers.  Mirrors ``rt_fused_mlp_smem_bytes``."""
    return (1024 + block_m * block_f * 2 + BAR_BYTES
            + stages * stage_bytes(block_m, hidden_chunk, gated))


def stages_for(block_m: int, block_f: int, hidden_chunk: int, gated: bool,
               smem_limit: int = SMEM_LIMIT) -> int:
    """Ring slots that fit beside the hidden slice, at most MAX_STAGES
    (below MIN_STAGES: the slice does not fit)."""
    free = smem_limit - smem_bytes(block_m, block_f, hidden_chunk, 0, gated)
    return min(MAX_STAGES,
               max(0, free) // stage_bytes(block_m, hidden_chunk, gated))


def hidden_chunk_for(block_m: int, block_f: int, gated: bool,
                     smem_limit: int = SMEM_LIMIT) -> int:
    """128 hidden columns a pass where the slice takes them and the ring
    still holds three slots, else 64: on the card a third slot of the
    narrower chunk beats two of the wider one."""
    if block_f % 128 == 0 and stages_for(block_m, block_f, 128, gated,
                                         smem_limit) >= 3:
        return 128
    return 64


def block_f_choices(f: int, block_m: int, gated: bool,
                    smem_limit: int = SMEM_LIMIT) -> list[int]:
    """F slices on the lattice that divide ``f`` and fit a block of
    ``block_m`` rows with at least MIN_STAGES ring slots, ascending."""
    return [bf for bf in range(F_ALIGN, f + 1, F_ALIGN)
            if f % bf == 0 and stages_for(
                block_m, bf, hidden_chunk_for(block_m, bf, gated,
                                              smem_limit),
                gated, smem_limit) >= MIN_STAGES]


@dataclasses.dataclass(frozen=True)
class Schedule:
    """What the launcher runs: the M tile, the F slice, the hidden chunk,
    the N chunk, the ring's slots, the blocks launched, their shared
    memory and the scratch: the fp32 partials and the arrival
    counters."""
    block_m: int
    block_f: int
    hidden_chunk: int
    block_n: int
    stages: int
    grid: int
    smem_bytes: int
    partial_bytes: int
    counter_bytes: int

    @property
    def label(self) -> str:
        return (f"BM={self.block_m} BF={self.block_f} FC={self.hidden_chunk}"
                f" stages={self.stages} grid={self.grid}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _estimate_s(m: int, k: int, f: int, n: int, gated: bool, block_m: int,
                block_f: int, stages: int, sms: int) -> float:
    """Seconds at prefill: whole waves of blocks, each running its
    products at EFFICIENCY of the tensor cores' peak, slowed by its ring's
    depth, plus the fp32 partials written and read at the HBM rate."""
    ups = 2 if gated else 1
    slices = f // block_f
    waves = _cdiv(_cdiv(m, block_m) * slices, sms)
    products = (2 * block_m * block_f * (ups * k + n) / SM_FLOPS
                / EFFICIENCY[block_m] * DEPTH_COST.get(stages, 1.0))
    return waves * products + PARTIAL_COST * 8 * slices * m * n / HBM_BPS


@functools.lru_cache(maxsize=4096)
def schedule(m: int, k: int, f: int, n: int, gated: bool,
             n_sm: int = H100_SMS, *, smem_limit: int = SMEM_LIMIT,
             block_m: int | None = None,
             block_f: int | None = None) -> Schedule:
    """The launch for x (m, k) through w1 (k, f) and w2 (f, n) on ``n_sm``
    SMs, each block allowed ``smem_limit`` bytes of shared memory.

    ``block_m`` and ``block_f`` fix the M tile and the F slice where
    given.  The tile is 64 rows up to m = 256 and 128 beyond (measured on
    the card: up to 256 rows the 64-row tile's larger grid wins, beyond it
    the 128-row tile's halved weight traffic does).  At m <= 64 (decode:
    the weight stream bounds it) the slice is the narrowest multiple of
    128 whose grid is at most half the SMs: 128-wide slices read the
    weights in 256-byte rows, and that many blocks already carry the
    stream (measured on the card).  Beyond it, the slice with the least
    :func:`_estimate_s`, the wider on a tie.  The hidden chunk is
    :func:`hidden_chunk_for`'s; the ring takes every slot that fits beside
    h.  Raises :class:`~repro_torch.core.ftl.InfeasibleError` when no
    slice fits."""
    if block_m is None:
        block_m = BLOCK_M[0] if m <= 4 * BLOCK_M[0] else BLOCK_M[1]
    if block_m not in BLOCK_M:
        raise ValueError(f"fused_mlp: block_m={block_m} not in {BLOCK_M}")
    cands = block_f_choices(f, block_m, gated, smem_limit)
    if block_f is not None:
        if block_f not in cands:
            raise ValueError(
                f"fused_mlp: block_f={block_f} is not a multiple of "
                f"{F_ALIGN} dividing F={f} that fits {smem_limit} B at "
                f"block_m={block_m}")
        cands = [block_f]
    if not cands:
        raise InfeasibleError(
            f"fused_mlp: no F slice of d_ff={f} fits {smem_limit} B of "
            f"shared memory (the smallest footprint is "
            f"{min_smem_bytes(gated)} B)")

    def chunk_and_depth(bf):
        fc = hidden_chunk_for(block_m, bf, gated, smem_limit)
        return fc, stages_for(block_m, bf, fc, gated, smem_limit)

    if len(cands) == 1:
        bf = cands[0]
    elif m <= BLOCK_M[0]:
        bf = next((c for c in cands if c % 128 == 0 and f // c <= n_sm // 2),
                  cands[-1])
    else:
        bf = min(cands, key=lambda c: (_estimate_s(
            m, k, f, n, gated, block_m, c, chunk_and_depth(c)[1], n_sm),
            -c))
    fc, stages = chunk_and_depth(bf)
    return Schedule(
        block_m=block_m, block_f=bf, hidden_chunk=fc, block_n=BLOCK_N,
        stages=stages, grid=_cdiv(m, block_m) * (f // bf),
        smem_bytes=smem_bytes(block_m, bf, fc, stages, gated),
        partial_bytes=4 * (f // bf) * m * n,
        counter_bytes=4 * _cdiv(m, ROWS) * _cdiv(n, BLOCK_N))


def block_of(b: int, tiles_m: int, slices: int) -> tuple[int, int]:
    """(M tile, F slice) of block ``b``, as the kernel maps it: groups of
    GROUP_M tiles, each walked slice by slice with the tile fastest."""
    first = b // (GROUP_M * slices) * GROUP_M
    span = min(tiles_m - first, GROUP_M)
    i = b - first * slices
    return first + i % span, i // span


def min_smem_bytes(gated: bool = True) -> int:
    """The smallest footprint any schedule has: 64 rows, a 64-wide slice
    and MIN_STAGES slots (what the registry qualifies the kernel on)."""
    return smem_bytes(BLOCK_M[0], F_ALIGN, 64, MIN_STAGES, gated)


def sum_partials(part: torch.Tensor, b2: torch.Tensor | None = None,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's sum in plain PyTorch: ``part`` (S, M, N) fp32
    partials summed chunk by chunk (ROWS rows by BLOCK_N columns, the
    tiles of the arrival counters) in slice order 0, 1, ..., S - 1, b2
    added in fp32, rounded to ``dtype`` once."""
    s, m, n = part.shape
    y = torch.empty((m, n), dtype=dtype, device=part.device)
    for r in range(0, m, ROWS):
        for c in range(0, n, BLOCK_N):
            acc = part[0, r:r + ROWS, c:c + BLOCK_N].clone()
            for i in range(1, s):
                acc += part[i, r:r + ROWS, c:c + BLOCK_N]
            if b2 is not None:
                acc += b2[c:c + BLOCK_N].float()
            y[r:r + ROWS, c:c + BLOCK_N] = acc.to(dtype)
    return y


# arrival counters of each (device, stream): zeroed once, left zero by
# every launch
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counters(dev: torch.device, stream: int, nbytes: int) -> torch.Tensor:
    key = (dev.index, stream)
    c = _COUNTERS.get(key)
    if c is None or 4 * c.numel() < nbytes:
        c = torch.zeros(nbytes // 4, dtype=torch.int32, device=dev)
        _COUNTERS[key] = c
    return c


def run_schedule(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                 wg: torch.Tensor | None, b1: torch.Tensor | None,
                 b2: torch.Tensor | None, act: str,
                 s: Schedule) -> torch.Tensor:
    """The fused MLP by the kernel on schedule ``s``, for checked CUDA
    operands (what :func:`fused_mlp` launches with its schedule;
    ``chip_smoke.py`` times other schedules with it).  Counts no
    launch."""
    m, k = x.shape
    f, n = w2.shape
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = torch.empty(s.partial_bytes // 4, dtype=torch.float32,
                       device=x.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        count = _counters(x.device, stream, s.counter_bytes)
        rc = _build.lib().rt_fused_mlp(
            x.data_ptr(), w1.data_ptr(), ptr(wg), w2.data_ptr(), ptr(b1),
            ptr(b2), part.data_ptr(), count.data_ptr(), y.data_ptr(), m, k,
            f, n, ref.ACT_CODES[act], s.block_m, s.block_f, s.hidden_chunk,
            s.stages, stream)
    _build.check(rc, "fused_mlp")
    return y


# kernel launches since the last reset (``chip_smoke.py`` reads it)
launches = 0


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              wg: torch.Tensor | None = None, b1: torch.Tensor | None = None,
              b2: torch.Tensor | None = None, *, act: str = "gelu",
              target: hwlib.Target | None = None,
              block_f: int | None = None) -> torch.Tensor:
    """``x`` (M, K) → (M, N).  ``block_f`` is the F slice; None lets
    :func:`schedule` pick it.  ``target``, where given, caps a block's
    shared memory at its fast level.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel or raises."""
    global launches
    ts = [t for t in (x, w1, w2, wg, b1, b2) if t is not None]
    if all(t.device.type == "cpu" for t in ts):
        return ref.mlp(x, w1, w2, wg, b1, b2, act=act)
    _build.no_backward("fused_mlp", *ts)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("fused_mlp: every operand must be on one CUDA "
                         "device")
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f"fused_mlp kernel takes bfloat16, got "
                        f"{[t.dtype for t in ts]}")
    if act not in ref.ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    if x.dim() != 2:
        raise ValueError(f"fused_mlp kernel takes 2-D x, got "
                         f"{tuple(x.shape)}")
    m, k = x.shape
    kf, f = w1.shape
    f2, n = w2.shape
    if kf != k or f2 != f or (wg is not None and wg.shape != w1.shape) \
            or (b1 is not None and b1.shape != (f,)) \
            or (b2 is not None and b2.shape != (n,)):
        raise ValueError("fused_mlp: operand shapes do not chain: "
                         f"{[tuple(t.shape) for t in ts]}")
    if k % 8 or n % 8 or f % F_ALIGN:
        raise ValueError(f"fused_mlp kernel needs K, N multiples of 8 and "
                         f"F a multiple of {F_ALIGN}; got K={k} F={f} N={n}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError("fused_mlp kernel takes contiguous, 16-byte "
                         "aligned operands")
    if m == 0:
        return torch.empty((0, n), dtype=x.dtype, device=x.device)
    limit = SMEM_LIMIT if target is None \
        else min(SMEM_LIMIT, target.fast.capacity_bytes)
    s = schedule(m, k, f, n, wg is not None, sm_count(x.device.index),
                 smem_limit=limit, block_f=block_f)
    y = run_schedule(x, w1, w2, wg, b1, b2, act, s)
    launches += 1
    return y
