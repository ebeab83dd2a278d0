"""Flash (online-softmax) attention as a hand-written Hopper kernel.

Source note.  Replaces the TPU kernel
``repro/kernels/flash_attention.py:flash_attention``: GQA (q-head h reads
kv-head ``h // (Hq / Hk)``), causal and local-window masks, a query
position offset, the -1e30 mask constant with zero guards so a fully
masked row gives zeros, q·k and the softmax statistics in fp32, P rounded
to the input dtype before P·V.  Every prefill runs it
(``models/layers.py:attention_prefill``), and so does ``run_block``.  At
prefill lengths it is compute-bound on the tensor cores (4·Tq·Tk·Dh FLOP
a head, halved by the causal mask).

The kernel (``csrc/flash_attention.cu``) is a TMA + ``wgmma`` loop: one
block per (query tile, head, batch), a producer warp keeping TMA loads of
K and V tiles in flight through an mbarrier ring, and one or two consumer
warpgroups of 64 query rows each running Q·Kᵀ and P·V on ``wgmma`` with
the softmax between them in registers.  What it runs is decided here, in
pure Python (:func:`schedule`): the tile height (128 rows, or 64 where 128
would leave SMs idle), the key tile width, the ring's depth, the grid and
the launch order of the query tiles, heaviest first; :func:`key_tiles`
gives each tile's span of key tiles and the ones that need no mask, as the
kernel computes them.  The plain version is
:func:`repro_torch.kernels.ref.attention`.

Training goes through :func:`attention`, a ``torch.autograd.Function``.
Its forward launches the same kernel built with a template flag that
also writes each row's fp32 logsumexp (+inf for a row that sees no key),
in the epilogue after the last ``wgmma`` wait, so serving's build holds
no trace of it.  Its backward launches ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_bwd`) on the forward's parts: D = rowsum(dO ∘ O)
into rows padded to 64 queries, then one block per (key tile, kv head,
batch, split) for dK and dV and one per (query tile, q head, batch) for
dQ, each a producer warp streaming TMA tiles through an mbarrier ring to
two (dQ: one or two) consumer warpgroups on ``wgmma``; P is recomputed
from the logsumexp, and P and dS enter the next products from registers.
dQ runs on a second stream beside dK/dV, joined before the call
returns.  A dK/dV block walks the group's q heads in a fixed order, so
that GQA's sum needs no atomics.  Its key tile is 128 keys at head dims
64 and 128 (each consumer group owning 64 keys and all of their dK and
dV columns) and 64 at 256 (both groups on the same keys, one computing
S and the other dP, trading them through shared memory, each keeping
half the columns).  dQ's query tile is 128 rows at head dim 128 and 64
at 64 and 256, where two groups share the 64 rows the same way.  P and dS enter the dV
and dK products as split-bf16 pairs (hi + lo): summed over a group's
heads and queries, their bf16 rounding alone leaves dK and dV outside
the bf16 tolerance at MQA 16/1, head dim 256.  Where the key tiles
alone leave SMs idle (MQA), the group's q heads are split across blocks
(:func:`bwd_splits`), and a small kernel sums the splits' fp32
partials in split order.  :func:`bwd_schedule` decides, in
pure Python, both kernels' tiles, ring depths, grids and launch orders
(heaviest first), and :func:`query_tiles` gives each key tile's span of
query tiles and the ones that need no mask, as the kernel computes
them.  It is compute-bound like the forward (10·Tq·Tk·Dh FLOP a head,
halved by the causal mask); it takes head dims 64, 128 and 256.  The
plain versions are :func:`repro_torch.kernels.ref.attention_lse` and
:func:`repro_torch.kernels.ref.attention_bwd`; on CPU tensors the same
Function runs them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
from torch.autograd.function import once_differentiable

from . import _build, ref
from .gemm import H100_SMS, sm_count

HEAD_DIMS = (64, 128, 256)
BWD_ROWS = 64                     # queries (dK/dV) or keys (dQ) a stage
# the backward's one build at each head dim: the dK/dV kernel's key tile
# and the dQ kernel's query tile
BWD_BLOCK_K = {64: 128, 128: 128, 256: 64}
BWD_BLOCK_Q = {64: 64, 128: 128, 256: 64}
BLOCK_Q = (128, 64)               # query tile heights, the taller preferred
MAX_STAGES = 4                    # K/V ring stages the kernel can hold
MAX_TILES = 1024                  # query tiles the launch order can list
SMEM_LIMIT = 232_448              # dynamic shared memory a block may use


def block_kv(head_dim: int) -> int:
    """Keys a K/V tile holds: 128, or 64 at head_dim 256 (registers: the
    fp32 output accumulator alone is 128 a thread there)."""
    return 64 if head_dim == 256 else 128


def _ring_bytes(head_dim: int, block_q: int, stages: int) -> int:
    # the Q tile, ``stages`` K and V tiles, 256 B of mbarriers and 1 KB to
    # align the ring to the 128-byte swizzle (csrc/flash_attention.cu:
    # Cfg::smem_bytes)
    return (1024 + block_q * head_dim * 2
            + 2 * stages * block_kv(head_dim) * head_dim * 2 + 256)


def stages_for(head_dim: int, block_q: int) -> int:
    """The K/V ring's depth: as many stages as fit a block's shared
    memory, at most MAX_STAGES (3 at head_dim 128, 2 or 3 at 256, 4 at
    64)."""
    n = MAX_STAGES
    while _ring_bytes(head_dim, block_q, n) > SMEM_LIMIT:
        n -= 1
    return n


def smem_bytes_for(head_dim: int, block_q: int) -> int:
    """Dynamic shared memory of one block at tile height ``block_q``."""
    return _ring_bytes(head_dim, block_q, stages_for(head_dim, block_q))


def smem_bytes(head_dim: int) -> int:
    """The largest footprint :func:`schedule` can pick at ``head_dim``
    (what the registry qualifies the kernel on)."""
    return max(smem_bytes_for(head_dim, bq) for bq in BLOCK_Q)


@dataclasses.dataclass(frozen=True)
class Span:
    """Key tiles [lo, hi) some row of a query tile sees, and [full_lo,
    full_hi) among them that every row sees whole: those run no mask."""
    lo: int
    full_lo: int
    full_hi: int
    hi: int

    @property
    def tiles(self) -> int:
        return self.hi - self.lo


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def key_tiles(tile: int, block_q: int, block_k: int, tq: int, tk: int,
              causal: bool, window: int | None, q_offset: int) -> Span:
    """The key tiles of query tile ``tile``, as the kernel computes them
    (csrc/flash_attention.cu: key_span); rows past ``tq`` do not count."""
    win = window or 0
    first = tile * block_q + q_offset
    last = min((tile + 1) * block_q, tq) - 1 + q_offset
    k_min = max(0, first - win + 1) if win else 0
    k_max = min(tk - 1, last) if causal else tk - 1
    if k_min > k_max:
        return Span(0, 0, 0, 0)
    f_min = max(0, last - win + 1) if win else 0
    f_max = min(tk - 1, first) if causal else tk - 1
    lo, hi = k_min // block_k, k_max // block_k + 1
    # clamped to hi, as the backward's query_tiles is: with a window and
    # Tq > Tk, f_min can lie past the last key tile
    full_lo = min(hi, max(lo, _cdiv(f_min, block_k)))
    full_hi = max(full_lo, min(hi, (f_max + 1) // block_k))
    return Span(lo, full_lo, full_hi, hi)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """What the launcher runs: the query tile height, the key tile width,
    the ring's stages, the blocks launched, their shared memory, and the
    query tiles in launch order (heaviest first)."""
    block_q: int
    block_k: int
    stages: int
    grid: int
    smem_bytes: int
    order: tuple[int, ...]

    @property
    def label(self) -> str:
        return (f"BQ={self.block_q} BKV={self.block_k} stages={self.stages} "
                f"grid={self.grid}")


@functools.lru_cache(maxsize=4096)
def schedule(b: int, hq: int, hk: int, tq: int, tk: int, dh: int,
             causal: bool, window: int | None, q_offset: int, *,
             sms: int = H100_SMS, block_q: int | None = None) -> Schedule:
    """The launch for q (b, hq, tq, dh) over k/v (b, hk, tk, dh) on
    ``sms`` SMs.

    The tile height is ``block_q`` if given, else 128 unless the grid
    would then fill less than one wave of the SMs, and 64 there.  One block
    per (query tile, q-head, batch); the query tiles launch in the order of
    their number of key tiles, most first, later tiles first on a tie."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {dh}")
    if hk < 1 or hq % hk:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hk}")
    if block_q is None:
        block_q = BLOCK_Q[0] if _cdiv(tq, BLOCK_Q[0]) * hq * b >= sms \
            else BLOCK_Q[1]
    if block_q not in BLOCK_Q:
        raise ValueError(f"block_q must be one of {BLOCK_Q}, got {block_q}")
    n = _cdiv(tq, block_q)
    if not 1 <= n <= MAX_TILES:
        raise ValueError(f"flash_attention kernel takes 1 to "
                         f"{MAX_TILES * block_q} queries, got {tq}")
    bk = block_kv(dh)
    spans = [key_tiles(i, block_q, bk, tq, tk, causal, window, q_offset)
             .tiles for i in range(n)]
    order = tuple(sorted(range(n), key=lambda i: (-spans[i], -i)))
    return Schedule(block_q, bk, stages_for(dh, block_q), n * hq * b,
                    smem_bytes_for(dh, block_q), order)


def plan(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
         window: int | None, q_offset: int) -> Schedule:
    """The schedule :func:`flash_attention` launches for CUDA q and k."""
    b, hq, tq, dh = q.shape
    return schedule(b, hq, k.shape[1], tq, k.shape[2], dh, bool(causal),
                    window, int(q_offset), sms=sm_count(q.device.index))


@functools.lru_cache(maxsize=4096)
def _order_array(order: tuple[int, ...]):
    return (ctypes.c_uint16 * len(order))(*order)


def run_schedule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 s: Schedule, *, causal: bool, window: int | None,
                 q_offset: int, lse: torch.Tensor | None = None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Attention by the kernel on schedule ``s``, for checked CUDA
    operands with ``k.shape[2] > 0`` (what :func:`flash_attention` launches
    with :func:`plan`; ``chip_smoke.py`` times other schedules with it).
    ``lse``, where given, is a (B, Hq, Tq) fp32 tensor the kernel fills
    with each row's logsumexp; ``out``, where given, a contiguous tensor
    like ``q`` the kernel writes o into (the card tests fill it with NaN
    first).  Counts no launch."""
    b, hq, tq, dh = q.shape
    _, hk, tk, _ = k.shape
    o = torch.empty_like(q) if out is None else out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _build.lib().rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            0 if lse is None else lse.data_ptr(),
            b, hq, hk, tq, tk, dh, int(causal),
            0 if window is None else int(window), int(q_offset),
            s.block_q, s.stages, _order_array(s.order), len(s.order),
            stream)
    _build.check(rc, "flash_attention")
    return o


# kernel launches since the last reset (``chip_smoke.py`` reads them): the
# forward kernel's, and the backward's (one for each call of
# :func:`flash_attention_bwd`, which runs all of its kernels)
launches = 0
bwd_launches = 0


def bwd_splits(b: int, hq: int, hk: int, tk: int, block_k: int,
               sms: int = H100_SMS) -> int:
    """Blocks the backward splits each kv head's group of q heads across:
    the fewest (a divisor of the group) whose dK/dV grid, one block per
    (``block_k``-key tile, kv head, batch, split), fills the card's
    ``sms`` SMs, else the whole group.  1 wherever the key tiles alone
    fill it."""
    group = hq // hk
    blocks = _cdiv(tk, block_k) * hk * b
    return next((d for d in range(1, group + 1)
                 if group % d == 0 and blocks * d >= sms), group)


def query_tiles(tile: int, block_k: int, block_q: int, tq: int, tk: int,
                causal: bool, window: int | None, q_offset: int) -> Span:
    """The query tiles that some row of key tile ``tile`` sees, and the
    ones among them that every real row sees whole, as the dK/dV kernel
    computes them (csrc/flash_attention_bwd.cu: query_span): the
    transpose of :func:`key_tiles`.  Rows past ``tq`` do not count; a key
    tile holding a key past ``tk`` has no whole query tile."""
    win = window or 0
    k0 = tile * block_k
    k1 = min(k0 + block_k, tk) - 1
    q_lo = max(0, k0 - q_offset) if causal else 0
    q_hi = min(tq - 1, k1 + win - 1 - q_offset) if win else tq - 1
    if q_lo > q_hi:
        return Span(0, 0, 0, 0)
    lo, hi = q_lo // block_q, q_hi // block_q + 1
    # rows that see every key of the tile: from the one that sees its last
    # key (causal) to the one that still sees its first (window)
    f_lo = max(0, k0 + block_k - 1 - q_offset) if causal else 0
    f_hi = k0 + win - 1 - q_offset if win else tq - 1
    full_lo = min(hi, max(lo, _cdiv(f_lo, block_q)))
    top = hi if f_hi >= tq - 1 else (f_hi + 1) // block_q
    full_hi = (full_lo if k0 + block_k > tk
               else max(full_lo, min(hi, top)))
    return Span(lo, full_lo, full_hi, hi)


def bwd_smem_bytes(kernel: str, head_dim: int, tile: int, stages: int
                   ) -> int:
    """Dynamic shared memory of one block of the backward's ``"dkdv"``
    kernel at key tile ``tile`` or its ``"dq"`` kernel at query tile
    ``tile``, with ``stages`` ring stages (csrc/flash_attention_bwd.cu:
    KvCfg and QCfg::smem_bytes): 1 KB to align to the 128-byte swizzle,
    the tiles held for the whole loop, the ring and 256 B of mbarriers."""
    if kernel == "dkdv":
        # K and V; a stage's Q and dO tiles and lse and D rows; the S^T /
        # dP^T trade where both groups share 64 keys
        trade = 2 * 32 * 128 * 4 if tile == 64 else 0
        return (1024 + 2 * tile * head_dim * 2
                + stages * (2 * BWD_ROWS * head_dim * 2 + 2 * BWD_ROWS * 4)
                + trade + 256)
    # Q and dO; a stage's K and V tiles; at head_dim 256, the S / dP trade
    # of two groups sharing 64 rows
    trade = 2 * 32 * 128 * 4 if head_dim == 256 else 0
    return (1024 + 2 * tile * head_dim * 2
            + 2 * stages * BWD_ROWS * head_dim * 2 + trade + 256)


def bwd_stages_for(kernel: str, head_dim: int, tile: int) -> int:
    """A backward ring's depth: as many stages as fit a block's shared
    memory, at most MAX_STAGES (2 at head_dim 256)."""
    n = MAX_STAGES
    while bwd_smem_bytes(kernel, head_dim, tile, n) > SMEM_LIMIT:
        n -= 1
    return n


@dataclasses.dataclass(frozen=True)
class BwdSchedule:
    """What the backward's launcher runs: the dK/dV kernel's key tile,
    ring stages, grid (key tiles x kv heads x batch x splits), shared
    memory and key tiles in launch order; the splits of a group's q heads;
    the dQ kernel's query tile, ring stages, grid, shared memory and query
    tiles in launch order.  Both orders heaviest first."""
    block_k: int
    kv_stages: int
    splits: int
    kv_grid: int
    kv_smem_bytes: int
    kv_order: tuple[int, ...]
    block_q: int
    q_stages: int
    q_grid: int
    q_smem_bytes: int
    q_order: tuple[int, ...]

    @property
    def label(self) -> str:
        return (f"dK/dV BK={self.block_k} stages={self.kv_stages} "
                f"splits={self.splits} grid={self.kv_grid}; dQ "
                f"BQ={self.block_q} stages={self.q_stages} "
                f"grid={self.q_grid}")


@functools.lru_cache(maxsize=4096)
def bwd_schedule(b: int, hq: int, hk: int, tq: int, tk: int, dh: int,
                 causal: bool, window: int | None, q_offset: int, *,
                 sms: int = H100_SMS) -> BwdSchedule:
    """The backward's launch for q (b, hq, tq, dh) over k/v (b, hk, tk,
    dh) on ``sms`` SMs.

    Each kernel's tile is the one built at ``dh`` (:data:`BWD_BLOCK_K`,
    :data:`BWD_BLOCK_Q`), and the splits fill the card at that key tile
    (:func:`bwd_splits`).  Each grid launches its tiles in the order of
    the tiles of the other axis they see, most first, later tiles first on
    a tie; every (kv head, batch, split) or (q head, batch) of a tile
    launches together."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {dh}")
    if hk < 1 or hq % hk:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hk}")
    block_k, block_q = BWD_BLOCK_K[dh], BWD_BLOCK_Q[dh]
    nk, nq = _cdiv(tk, block_k), _cdiv(tq, block_q)
    if not (1 <= nk <= MAX_TILES and 1 <= nq <= MAX_TILES):
        raise ValueError(f"flash_attention_bwd kernel at head_dim {dh} "
                         f"takes 1 to {MAX_TILES * block_q} queries and 1 "
                         f"to {MAX_TILES * block_k} keys, got {tq} and "
                         f"{tk}")
    splits = bwd_splits(b, hq, hk, tk, block_k, sms)
    mask = (tq, tk, causal, window, q_offset)
    seen_k = [query_tiles(j, block_k, BWD_ROWS, *mask).tiles
              for j in range(nk)]
    seen_q = [key_tiles(i, block_q, BWD_ROWS, *mask).tiles
              for i in range(nq)]
    kv_st = bwd_stages_for("dkdv", dh, block_k)
    q_st = bwd_stages_for("dq", dh, block_q)
    return BwdSchedule(
        block_k, kv_st, splits, nk * hk * b * splits,
        bwd_smem_bytes("dkdv", dh, block_k, kv_st),
        tuple(sorted(range(nk), key=lambda j: (-seen_k[j], -j))),
        block_q, q_st, nq * hq * b, bwd_smem_bytes("dq", dh, block_q, q_st),
        tuple(sorted(range(nq), key=lambda i: (-seen_q[i], -i))))


def bwd_plan(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
             window: int | None, q_offset: int) -> BwdSchedule:
    """The schedule :func:`flash_attention_bwd` launches for CUDA q, k."""
    b, hq, tq, dh = q.shape
    return bwd_schedule(b, hq, k.shape[1], tq, k.shape[2], dh, bool(causal),
                        window, int(q_offset), sms=sm_count(q.device.index))


def _check(what: str, *ts: torch.Tensor) -> None:
    q = ts[0]
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError(f"{what}: every operand must be on one CUDA "
                         f"device")
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f"{what} kernel takes bfloat16, got "
                        f"{[str(t.dtype) for t in ts]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError(f"{what} kernel takes contiguous, 16-byte aligned "
                         f"operands")


def _check_shapes(q, k, v, window, q_offset) -> None:
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


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool, window: int | None, q_offset: int,
             with_lse: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The forward kernel on CUDA q, k, v: (o, lse or None)."""
    global launches
    _check("flash_attention", q, k, v)
    _check_shapes(q, k, v, window, q_offset)
    b, hq, tq, _ = q.shape
    lse = (torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.numel() == 0:
        return torch.empty_like(q), lse
    if k.shape[2] == 0:              # no key: every row gives zeros
        if lse is not None:
            lse.fill_(float("inf"))
        return torch.zeros_like(q), lse
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o = run_schedule(q, k, v, plan(q, k, **kw), lse=lse, **kw)
    launches += 1
    return o, lse


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream the backward's dQ kernel runs on beside dK/dV: forked
    from the caller's stream after D's rows and joined into it before the
    call returns, so that the caller sees one stream's order."""
    return torch.cuda.Stream(device)


def run_bwd_schedule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                     s: BwdSchedule, *, causal: bool, window: int | None,
                     q_offset: int, out: tuple[torch.Tensor, ...] | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by the backward kernels on schedule ``s``, for checked
    CUDA operands with ``k.shape[2] > 0`` (what :func:`flash_attention_bwd`
    launches with :func:`bwd_plan`; ``chip_smoke.py`` times other
    schedules with it).  ``out``: dq, dk and dv to write into, else new
    tensors.  Counts no launch."""
    b, hq, tq, dh = q.shape
    _, hk, tk, _ = k.shape
    dq, dk, dv = out if out is not None else (
        torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    rows = torch.empty((2, b, hq, _cdiv(tq, BWD_ROWS) * BWD_ROWS),
                       dtype=torch.float32, device=q.device)
    partials = (torch.empty((2, s.splits, b, hk, tk, dh),
                            dtype=torch.float32, device=q.device)
                if s.splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        side = _side_stream(q.device).cuda_stream
        rc = _build.lib().rt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), rows.data_ptr(),
            None if partials is None else partials.data_ptr(), b, hq, hk,
            tq, tk, dh, int(causal), 0 if window is None else int(window),
            int(q_offset), s.block_k, s.block_q, s.kv_stages, s.q_stages,
            s.splits, _order_array(s.kv_order), len(s.kv_order),
            _order_array(s.q_order), len(s.q_order), stream, side)
    _build.check(rc, "flash_attention_bwd")
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """(dq, dk, dv) in bf16 by the backward kernels
    (``csrc/flash_attention_bwd.cu``) on :func:`bwd_plan`'s schedule, for
    CUDA q, k, v, the forward's output o and row logsumexp ``lse``, and
    the output gradient ``do``.  :func:`repro_torch.kernels.ref.
    attention_bwd` is the plain version.  Head dims 64, 128 and 256; the
    q heads of a group split across :func:`bwd_splits` blocks."""
    global bwd_launches
    _check("flash_attention_bwd", q, k, v, o, do)
    _check_shapes(q, k, v, window, q_offset)
    b, hq, tq, dh = q.shape
    _, hk, tk, _ = k.shape
    if o.shape != q.shape or do.shape != q.shape \
            or lse.shape != (b, hq, tq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"{lse.dtype} for q {tuple(q.shape)}")
    if q.numel() == 0 or tk == 0:
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = run_bwd_schedule(q, k, v, o, lse, do, bwd_plan(q, k, **kw), **kw)
    bwd_launches += 1
    return out


def _plain(plain: bool, *ts: torch.Tensor) -> bool:
    return plain or all(t.device.type == "cpu" for t in ts)


class _Attention(torch.autograd.Function):
    """Attention with its gradient: the forward keeps o and the row
    logsumexp, the backward recomputes P from them.  On the CPU, or with
    ``plain``, both passes run the plain versions (``ref.attention_lse``,
    ``ref.attention_bwd``); on a CUDA tensor they launch the kernels or
    raise."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, plain):
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        ctx.kw, ctx.plain = kw, _plain(plain, q, k, v)
        o, lse = (ref.attention_lse(q, k, v, **kw) if ctx.plain
                  else _forward(q, k, v, with_lse=True, **kw))
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = ref.attention_bwd if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              q_offset: int = 0, plain: bool = False) -> torch.Tensor:
    """q (B, Hq, Tq, Dh), k/v (B, Hk, Tk, Dh) → (B, Hq, Tq, Dh), with its
    gradient where autograd asks for one.  A CPU tensor, or ``plain``,
    runs the plain versions; a CUDA tensor launches the forward kernel
    (and, in the backward pass, the backward kernels) or raises."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, causal, window, q_offset, plain)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if _plain(plain, q, k, v):
        return ref.attention(q, k, v, **kw)
    return _forward(q, k, v, with_lse=False, **kw)[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, Tq, Dh), k/v (B, Hk, Tk, Dh) → (B, Hq, Tq, Dh).

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel or raises.  Differentiable: see :func:`attention`."""
    return attention(q, k, v, causal=causal, window=window,
                     q_offset=q_offset)
