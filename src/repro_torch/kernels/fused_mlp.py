"""Fused MLP ``y = act(x@w1 + b1) [⊙ (x@wg)] @ w2 + b2`` as a
hand-written Hopper kernel — the paper's fusion, whose (M, d_ff) hidden
tensor never reaches device memory.

Source note.  Replaces the TPU kernel ``repro/kernels/fused_mlp.py:
fused_mlp``: fp32 accumulation, h rounded to ``x.dtype`` before the second
product, b2 added in fp32 on the flush.  Under ``ftl_mode="fused"`` every
MLP of the serving path runs it, at M = the prefill bucket and at M =
slots during decode.  On an H100 the prefill case (M = 1024, llama3.2-3b
widths) is compute-bound (~155 GFLOP) and the decode case memory-bound on
the 151 MB of weights.

Dataflow (``csrc/fused_mlp.cu``).  The TPU kernel keeps N whole and
carries a (block_m, N) fp32 accumulator across the F grid axis; at
N = 3072 that is 768 KiB even at block_m = 64, beyond the 227 KiB of
shared memory a Hopper block may claim, and Hopper blocks run in no order,
so nothing carries between them.  This kernel splits F across blocks:
block (i, s) computes the hidden slice h[64 i : 64 i + 64, BF s : BF s +
BF] into shared memory, multiplies it by the matching rows of w2 and
writes an fp32 partial of y; a second pass sums the F / BF partials with
b2 in fp32.  Tiling N and recomputing h per N tile instead would redo the
up projections N / 128 = 24 times.

The split is not free: the partials cost ``2 * 4 * M * N * F / BF`` bytes
of device traffic (:func:`partial_bytes`), where writing and reading the
bf16 h would cost ``2 * 2 * M * F``: at M = 1024 and llama3.2-3b's
widths, 201 MB of partials at BF = 1024 (the widest slice that fits
shared memory) and 403 MB at BF = 512, against h's 34 MB.
:func:`plan_blocks` prices each F slice on a Hopper lattice (64-row
tiles, BF a multiple of 64, k steps of 16) that fits the target's fast
level by a roofline that counts the partials' bytes beside the
operands', stretched by how its blocks occupy the SMs, and takes the
cheapest.  At M = 1024 that is BF = 512: one block of BF = 1024 per SM
cannot hide its load latency, and two of BF = 512 can, which outweighs
the extra partials.  The plain version is
:func:`repro_torch.kernels.ref.mlp`.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.core import hw as hwlib
from repro_torch.core.ftl.solver import InfeasibleError

from . import _build, ref

BLOCK_M, BLOCK_K, BLOCK_N = 64, 32, 128
F_ALIGN = 64                      # lattice of the F slice width
# An H100 SM holds 233,472 B of shared memory for its resident blocks, of
# which the runtime reserves 1 KiB per block, and 65,536 registers: room
# for three blocks of 256 threads of the gated kernel that steps the
# hidden columns 64 at a time, two of the one that steps them 128 at a
# time (``chip_smoke.py`` holds :func:`blocks_per_sm` against the CUDA
# runtime's occupancy).  A block of 8 warps alone on an SM leaves the
# tensor cores waiting on its loads; it takes two resident blocks to hide
# them (``chip_smoke.py``'s F-slice sweep: at M = 1024 a slice that fits
# twice per SM beats one that fits once).
SM_SMEM_BYTES, SMEM_RESERVED_BYTES = 233_472, 1024
BLOCKS_PER_SM_BY_REGISTERS = {64: 3, 128: 2}
LATENCY_BLOCKS = 2


def smem_bytes(block_f: int) -> int:
    """Dynamic shared memory of one block at F slice ``block_f``: the
    (64, block_f) bf16 hidden slice plus the two-stage staging ring the
    up projections (x, w1, wg tiles) and then the down projection (w2
    tiles) share.  Mirrors ``rt_fused_mlp_smem_bytes`` in the source."""
    fc = 128 if block_f % 128 == 0 else 64
    up = 2 * (BLOCK_M * (BLOCK_K + 8) + 2 * BLOCK_K * (fc + 8)) * 2
    down = 2 * BLOCK_K * (BLOCK_N + 8) * 2
    return BLOCK_M * (block_f + 8) * 2 + max(up, down)


def blocks_per_sm(block_f: int) -> int:
    """Blocks of the gated kernel at F slice ``block_f`` one SM holds at
    once: the fewer that its shared memory and its registers allow."""
    fc = 128 if block_f % 128 == 0 else 64
    return min(SM_SMEM_BYTES // (smem_bytes(block_f) + SMEM_RESERVED_BYTES),
               BLOCKS_PER_SM_BY_REGISTERS[fc])


def feasible_block_f(d_ff: int, target: hwlib.Target) -> list[int]:
    """F slice widths on the lattice whose footprint fits ``target``'s
    fast level, ascending."""
    return [bf for bf in range(F_ALIGN, d_ff + 1, F_ALIGN)
            if d_ff % bf == 0
            and smem_bytes(bf) <= target.fast.capacity_bytes]


def partial_bytes(m: int, n: int, d_ff: int, block_f: int) -> int:
    """Device-memory bytes of the fp32 partials at F slice ``block_f``:
    each written once and read once."""
    return 2 * 4 * (d_ff // block_f) * m * n


@functools.lru_cache(maxsize=512)
def plan_blocks(m: int, k: int, d_ff: int, n: int, target: hwlib.Target,
                n_sm: int = 132, gated: bool = True) -> tuple[int, int]:
    """(block_m, block_f) for ``m`` tokens on a card with ``n_sm`` SMs.

    Each feasible F slice is priced by a roofline: the larger of the FLOPs
    over the target's peak and the bytes over its backing memory's rate —
    the operands read once, y written once, and the slice's partials
    written and read once — spread evenly over the card's SMs.  It is then
    stretched by how the slice's blocks occupy them: the blocks run in
    waves of :func:`blocks_per_sm` per SM, and an SM runs a wave at full
    rate only with :data:`LATENCY_BLOCKS` or more of them, so a wave
    takes ``max(r, LATENCY_BLOCKS)`` block-times, ``r`` the most blocks
    an SM holds in it.  The cheapest wins; a tie goes to the wider slice.
    Raises :class:`~repro_torch.core.ftl.InfeasibleError` when no slice
    fits."""
    cands = feasible_block_f(d_ff, target)
    if not cands:
        raise InfeasibleError(
            f"fused_mlp: no F slice of d_ff={d_ff} fits the "
            f"{target.fast.capacity_bytes} B {target.fast.name} of "
            f"{target.name} (smallest needs {smem_bytes(F_ALIGN)} B)")
    ups = 2 if gated else 1
    bw = target.levels[-1].bw_bytes_per_s
    flops_s = 2 * m * d_ff * (ups * k + n) / target.flops
    operands = 2 * (m * k + ups * k * d_ff + d_ff * n + m * n)

    def cost(bf: int) -> tuple[float, int]:
        roof = max(flops_s, (operands + partial_bytes(m, n, d_ff, bf)) / bw)
        blocks = math.ceil(m / BLOCK_M) * (d_ff // bf)
        slots = max(1, blocks_per_sm(bf)) * n_sm
        full, rest = divmod(blocks, slots)
        waves = [slots] * full + ([rest] if rest else [])
        block_times = sum(max(math.ceil(w / n_sm), LATENCY_BLOCKS)
                          for w in waves)
        # one block-time is the roofline's time for n_sm blocks' work
        return roof * block_times * n_sm / blocks, -bf

    return BLOCK_M, min(cands, key=cost)


# kernel launches since the last reset (``chip_smoke.py`` reads it)
launches = 0


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              wg: torch.Tensor | None = None, b1: torch.Tensor | None = None,
              b2: torch.Tensor | None = None, *, act: str = "gelu",
              target: hwlib.Target | None = None,
              block_f: int | None = None) -> torch.Tensor:
    """``x`` (M, K) → (M, N).  ``block_f`` is the F slice; None plans it
    (:func:`plan_blocks`) on ``target``, the process's default target
    when that is None.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel or raises."""
    global launches
    ts = [t for t in (x, w1, w2, wg, b1, b2) if t is not None]
    if all(t.device.type == "cpu" for t in ts):
        return ref.mlp(x, w1, w2, wg, b1, b2, act=act)
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
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    if block_f is None:
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        _, block_f = plan_blocks(
            m, k, f, n, target if target is not None
            else hwlib.default_target(), n_sm, wg is not None)
    if block_f <= 0 or block_f % F_ALIGN or f % block_f:
        raise ValueError(f"fused_mlp: block_f={block_f} must be a multiple "
                         f"of {F_ALIGN} dividing F={f}")
    part = torch.empty((f // block_f, m, n), dtype=torch.float32,
                       device=x.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _build.lib().rt_fused_mlp(
            x.data_ptr(), w1.data_ptr(), ptr(wg), w2.data_ptr(), ptr(b1),
            ptr(b2), part.data_ptr(), y.data_ptr(), m, k, f, n, block_f,
            ref.ACT_CODES[act], stream)
    _build.check(rc, "fused_mlp")
    launches += 1
    return y
