"""RG-LRU scan ``h_t = a_t * h_{t-1} + x_t`` as a hand-written Hopper
kernel.

Source note.  Replaces the TPU kernel ``repro/kernels/rg_lru.py:
rg_lru_scan``: the carry in fp32 from ``h0`` (zeros when None), every
``h_t`` rounded to the input dtype, the final carry returned in fp32.
Every recurrent layer's prefill runs it
(``models/recurrent.py:rec_block``), at (B, T, W) = (1, prefill bucket,
lru_width).  It moves 6 bytes per element and does 2 FLOPs, so bytes
bound it: ``6·B·T·W + 8·B·W`` over the card's memory rate, about 30 µs
at B = 1, T = W = 4096 on an H100.  A kernel that walks all T steps of a
channel in one thread is bound instead by the latency of that serial
chain, one chain per channel.

The kernel (``csrc/rg_lru.cu``) spreads time across blocks in one pass.
A block owns ``channel_tile`` channels and ``chunk`` steps of one batch
row; its publisher warp puts the tile of x and a in flight by TMA (64
steps a box and barrier), each compute thread folds 8 channels of a
16-step segment into the segment's aggregate (Π a, and the scan from 0),
and every 64 steps anchored at t = 0 make a unit whose aggregate the
block writes to a global scratch and the publisher releases with a flag.
Meanwhile its fold warps take the carry-in as the fold from ``h0`` over
every earlier unit, in order, once every earlier chunk has released its
units; the compute threads carry it through the block's own units and
segments and re-scan their steps from shared memory.  ``h_T`` is the fold
over all units.  Blocks take their chunks from an atomic ticket in launch
order, so a block waits only on blocks already running.  Every value is
fixed by the 16-step segments, the 64-step units and that order, never by
the schedule or the timing, and every product and sum is rounded on its
own as :func:`repro_torch.kernels.ref.rg_lru_scan` rounds them:
:func:`chunked_model` reproduces the kernel's bits on the CPU.
:func:`schedule` picks the tile and the chunk so that the grid fills the
card.  The plain version is :func:`repro_torch.kernels.ref.rg_lru_scan`.

Training goes through :func:`rg_lru_scan` too, as a
``torch.autograd.Function``.  Its forward launches the same kernel built
with a template flag that also writes the fp32 carry at each 64-step
unit's start (B·⌈T/64⌉·W·4 bytes, the anchors), where the compute thread
of the unit's first segment already holds it, so serving's build holds no
trace of it.  Its backward (``csrc/rg_lru_bwd.cu``,
:func:`rg_lru_scan_bwd`) runs the reverse recurrence ``g_t = dh_t +
a_{t+1}·g_{t+1}`` from ``g_T = dh_T + dh_t`` on the same structure run
backward in time: the same tiles, segments and units, tickets handed out
from the last chunk, and each chunk's carry-in the fold from ``dh_t``
over every later unit, in order from the end.  Each block recomputes its
steps' fp32 h_{t-1} from the anchors as the forward computed it (never
from the bf16 h), and writes dx = g and da = g·h_{t-1} in one pass: 10
bytes an element.  :func:`chunked_bwd_model` reproduces its bits on the
CPU; :func:`repro_torch.kernels.ref.rg_lru_bwd` is the plain version.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build, ref
from .gemm import H100_SMS

# kernel launches since the last reset (``chip_smoke.py`` reads them): the
# forward kernel's, and the backward's
launches = 0
bwd_launches = 0

SEGMENT = 16                      # steps a thread scans
UNIT = 64                         # steps a published aggregate covers
CHANNELS = 8                      # channels a thread owns (16 bytes)
CHANNEL_TILES = (8, 16, 32, 64, 128)
MAX_CHUNK = 1024
MAX_THREADS = 384
SMEM_LIMIT = 232_448              # dynamic shared memory a block may use
MAX_B = 65535
SYNC_HEADER = 4                   # 32-bit words before the flags
MIN_BLOCKS = 2 * H100_SMS         # the grid the schedule aims to reach
# (channel tile, chunk) in the order the schedule tries them: the largest
# tile whose grid reaches MIN_BLOCKS, else the last
LADDER = ((64, 256), (64, 128), (64, 64), (32, 64), (16, 64), (8, 64))


def compute_threads(channel_tile: int, chunk: int) -> int:
    """Threads that stage and scan: 8 channels x one 16-step segment
    each."""
    return channel_tile // CHANNELS * (chunk // SEGMENT)


def threads_for(channel_tile: int, chunk: int) -> int:
    """A block's threads (csrc/rg_lru.cu: Shape::threads): the compute
    threads in whole warps, a fold warp per 32 channels of the tile and
    one publisher warp."""
    return 32 * (-(-compute_threads(channel_tile, chunk) // 32)
                 + (2 if channel_tile > 32 else 1) + 1)


def smem_bytes(channel_tile: int, chunk: int) -> int:
    """One block's dynamic shared memory (csrc/rg_lru.cu: Shape::smem_bytes
    must agree): 128 bytes of alignment slack for TMA, x and a of its tile
    in bf16, the segments' and the units' aggregates (two fp32 a channel)
    and the carry-in (one)."""
    return (128 + 4 * chunk * channel_tile
            + chunk // SEGMENT * channel_tile * 8
            + chunk // UNIT * channel_tile * 8 + channel_tile * 4)


def bwd_smem_bytes(channel_tile: int, chunk: int) -> int:
    """One backward block's dynamic shared memory (csrc/rg_lru_bwd.cu:
    Shape::smem_bytes must agree): 128 bytes of slack, x, a and dh of its
    tile in bf16, the recomputed h_{t-1} in fp32, the segments' forward
    and backward aggregates, the units' backward aggregates (two fp32 a
    channel each), the units' anchors and the carry-in (one)."""
    return (128 + 10 * chunk * channel_tile
            + 2 * (chunk // SEGMENT) * channel_tile * 8
            + (chunk // UNIT) * channel_tile * (8 + 4) + channel_tile * 4)


def takes(channel_tile: int, chunk: int, backward: bool = False) -> bool:
    """The tiles and chunks the kernel takes (csrc/rg_lru.cu: takes), or
    the backward kernel (csrc/rg_lru_bwd.cu: takes)."""
    smem = (bwd_smem_bytes if backward else smem_bytes)(channel_tile, chunk)
    return (channel_tile in CHANNEL_TILES and UNIT <= chunk <= MAX_CHUNK
            and chunk % UNIT == 0
            and threads_for(channel_tile, chunk) <= MAX_THREADS
            and smem <= SMEM_LIMIT)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """What a call launches: the channel tile and chunk length of a
    block, its threads (compute warps of 8 channels x one 16-step segment
    a thread, a fold warp per 32 channels up to two, a publisher warp),
    the grid (one block a batch row, chunk and tile, in ticket order), a
    block's shared memory, the unit aggregates' scratch and the sync
    buffer's 32-bit words (a header, then one flag a block).  A block's
    tile arrives as TMA boxes of 64 steps, each on its own barrier: no
    ring (a block runs one chunk).  ``backward``: the backward kernel's
    launch, the same blocks and scratch with its own shared memory."""
    channel_tile: int
    chunk: int
    n_chunks: int
    n_tiles: int
    threads: int
    grid: int
    smem_bytes: int
    scratch_bytes: int
    sync_words: int
    segment: int = SEGMENT
    unit: int = UNIT
    backward: bool = False

    @property
    def warps(self) -> int:
        return -(-self.threads // 32)

    @property
    def label(self) -> str:
        return (f"{'backward, ' if self.backward else ''}tile "
                f"{self.channel_tile} ch, chunk {self.chunk}, "
                f"{self.threads} threads, grid {self.grid}")


def _blocks(b: int, t: int, w: int, channel_tile: int, chunk: int) -> int:
    return b * -(-t // chunk) * -(-w // channel_tile)


def schedule(b: int, t: int, w: int, chunk: int | None = None,
             channel_tile: int | None = None, *,
             backward: bool = False) -> Schedule:
    """The launch for (B, T, W): the first (tile, chunk) of
    :data:`LADDER` whose grid reaches :data:`MIN_BLOCKS`, two blocks an
    SM of an H100 (a chunk longer than T rounded up to a unit is
    skipped), else the ladder's last.  ``chunk`` or ``channel_tile`` may
    override either.  ``backward`` gives the backward kernel's launch,
    picked by the same rule.  Refuses B outside 1 to 65535, T < 1, W < 1
    and a tile and chunk the kernel does not take."""
    if not 0 < b <= MAX_B:
        raise ValueError(f"rg_lru_scan kernel takes 1 to {MAX_B} batch "
                         f"rows, got {b}")
    if t < 1 or w < 1:
        raise ValueError(f"rg_lru_scan kernel takes T, W >= 1, got "
                         f"T={t}, W={w}")
    t_units = -(-t // UNIT) * UNIT
    picks = [(ct, ck) for ct, ck in LADDER if ck <= t_units]
    pick = next((p for p in picks if _blocks(b, t, w, *p) >= MIN_BLOCKS),
                LADDER[-1])
    ct = pick[0] if channel_tile is None else channel_tile
    ck = pick[1] if chunk is None else chunk
    if not takes(ct, ck, backward):
        raise ValueError(f"rg_lru_scan kernel takes a tile of "
                         f"{CHANNEL_TILES} channels and a chunk of whole "
                         f"{UNIT}-step units up to {MAX_CHUNK} within "
                         f"{MAX_THREADS} threads and {SMEM_LIMIT} B, got "
                         f"tile {ct}, chunk {ck}")
    n_chunks, n_tiles = -(-t // ck), -(-w // ct)
    grid = b * n_chunks * n_tiles
    return Schedule(
        channel_tile=ct, chunk=ck, n_chunks=n_chunks, n_tiles=n_tiles,
        threads=threads_for(ct, ck), grid=grid,
        smem_bytes=(bwd_smem_bytes if backward else smem_bytes)(ct, ck),
        scratch_bytes=8 * b * (n_chunks - 1) * (ck // UNIT) * w,
        sync_words=SYNC_HEADER + grid, backward=backward)


def anchor_shape(b: int, t: int, w: int) -> tuple[int, int, int]:
    """The anchors a training forward writes: the fp32 carry at each
    64-step unit's start, (B, ⌈T/64⌉, W)."""
    return (b, -(-t // UNIT), w)


# the sync buffer of each (device, stream): a ticket and generation word
# and one flag a block, zeroed once; each launch leaves it for the next
_SYNC: dict[tuple[int, int], torch.Tensor] = {}


def _sync(dev: torch.device, stream: int, words: int) -> torch.Tensor:
    key = (dev.index, stream)
    s = _SYNC.get(key)
    if s is None or s.numel() < words:
        s = torch.zeros(words, dtype=torch.int32, device=dev)
        _SYNC[key] = s
    return s


def _check(x, a, h0) -> None:
    ts = [t for t in (x, a, h0) if t is not None]
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("rg_lru_scan: x, a, h0 must be on one CUDA device")
    if x.dtype != torch.bfloat16 or a.dtype != torch.bfloat16:
        raise TypeError(f"rg_lru_scan kernel takes bfloat16 x and a, got "
                        f"{x.dtype}/{a.dtype}")
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"rg_lru_scan: x {tuple(x.shape)} and a "
                         f"{tuple(a.shape)} must be one (B, T, W) shape")
    b, _, w = x.shape
    if h0 is not None and (h0.shape != (b, w) or h0.dtype != torch.float32):
        raise ValueError(f"rg_lru_scan: h0 must be ({b}, {w}) float32, got "
                         f"{tuple(h0.shape)} {h0.dtype}")
    if not all(u.is_contiguous() for u in ts):
        raise ValueError("rg_lru_scan kernel takes contiguous operands")


def _plain(plain: bool, *ts: torch.Tensor | None) -> bool:
    return plain or all(t.device.type == "cpu" for t in ts if t is not None)


def rg_lru_scan(x: torch.Tensor, a: torch.Tensor,
                h0: torch.Tensor | None = None, *, plain: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, a (B, T, W); h0 (B, W) or None → (h (B, T, W) in ``x.dtype``,
    h_T (B, W) in fp32), with their gradient where autograd asks for one.

    A CPU tensor, or ``plain``, runs the plain versions; a CUDA tensor
    launches the kernel (and, in the backward pass, the backward kernel)
    or raises."""
    ts = [t for t in (x, a, h0) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return _Scan.apply(x, a, h0, _plain(plain, *ts))
    if _plain(plain, *ts):
        return ref.rg_lru_scan(x, a, h0)
    return _forward(x, a, h0, with_anchors=False)[:2]


def _forward(x, a, h0, *, with_anchors: bool):
    """The forward kernel on CUDA x, a, h0: (h, h_T, the anchors or
    None)."""
    _check(x, a, h0)
    b, t, w = x.shape
    anchors = (torch.empty(anchor_shape(b, t, w), dtype=torch.float32,
                           device=x.device) if with_anchors else None)
    if t == 0 or b == 0 or w == 0:
        return torch.empty_like(x), (
            torch.zeros((b, w), dtype=torch.float32, device=x.device)
            if h0 is None else h0.clone()), anchors
    return (*_launch(x, a, h0, schedule(b, t, w), None, None, None,
                     anchors), anchors)


def run_schedule(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None,
                 sched: Schedule, *, out: torch.Tensor | None = None,
                 h_t: torch.Tensor | None = None,
                 scratch: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on ``sched`` (CUDA tensors, checked as
    :func:`rg_lru_scan` checks them; ``sched`` must be the shape's
    schedule at its tile and chunk).  ``out``, ``h_t`` and ``scratch``
    (``sched.scratch_bytes`` of fp32) may be handed in, as the card tests
    do to fill them with NaN first; otherwise they are allocated here.
    Counts a launch."""
    _check(x, a, h0)
    b, t, w = x.shape
    if sched != schedule(b, t, w, sched.chunk, sched.channel_tile):
        raise ValueError(f"rg_lru_scan: schedule {sched} is not the one "
                         f"for {tuple(x.shape)}")
    _check_scratch(scratch, sched)
    return _launch(x, a, h0, sched, out, h_t, scratch)


def _check_scratch(scratch, sched: Schedule) -> None:
    if scratch is not None and \
            scratch.numel() * scratch.element_size() < sched.scratch_bytes:
        raise ValueError(f"rg_lru_scan: scratch of "
                         f"{scratch.numel() * scratch.element_size()} B, "
                         f"the schedule needs {sched.scratch_bytes}")


def _vec(w: int, *ts: torch.Tensor) -> int:
    """16-byte rows: W % 8 == 0 and every bf16 operand 16-byte aligned."""
    return int(w % 8 == 0 and all(u.data_ptr() % 16 == 0 for u in ts))


def _launch(x, a, h0, sched: Schedule, out, h_t, scratch, anchors=None):
    global launches
    b, t, w = x.shape
    dev = x.device
    if out is None:
        out = torch.empty_like(x)
    if h_t is None:
        h_t = torch.empty((b, w), dtype=torch.float32, device=dev)
    if scratch is None:
        scratch = torch.empty(sched.scratch_bytes // 4, dtype=torch.float32,
                              device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        sync = _sync(dev, stream, sched.sync_words)
        rc = _build.lib().rt_rg_lru_scan(
            x.data_ptr(), a.data_ptr(),
            None if h0 is None else h0.data_ptr(), out.data_ptr(),
            h_t.data_ptr(), scratch.data_ptr(),
            None if anchors is None else anchors.data_ptr(),
            sync.data_ptr(), b, t, w, sched.channel_tile, sched.chunk,
            _vec(w, x, a, out), stream)
    _build.check(rc, "rg_lru_scan")
    launches += 1
    return out, h_t


def rg_lru_scan_bwd(x: torch.Tensor, a: torch.Tensor,
                    anchors: torch.Tensor, dh: torch.Tensor | None,
                    dh_t: torch.Tensor | None = None, *,
                    sched: Schedule | None = None,
                    dx: torch.Tensor | None = None,
                    da: torch.Tensor | None = None,
                    scratch: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, da, dh0) by the backward kernel (``csrc/rg_lru_bwd.cu``) for
    CUDA bf16 x and a, the training forward's ``anchors``, the bf16
    cotangent ``dh`` of h and the fp32 cotangent ``dh_t`` of h_T (None:
    zeros).  dx and da in bf16, dh0 in fp32.
    :func:`repro_torch.kernels.ref.rg_lru_bwd` is the plain version and
    :func:`chunked_bwd_model` gives the kernel's bits.  ``sched`` (the
    shape's backward schedule at some tile and chunk), ``dx``, ``da`` and
    ``scratch`` may be handed in, as the card tests do."""
    global bwd_launches
    _check(x, a, None)
    b, t, w = x.shape
    if dh is None:
        dh = torch.zeros_like(x)
    if dh.shape != x.shape or dh.dtype != torch.bfloat16 \
            or dh.device != x.device or not dh.is_contiguous():
        raise ValueError(f"rg_lru_scan_bwd: dh must be a contiguous bf16 "
                         f"{tuple(x.shape)} tensor beside x, got "
                         f"{tuple(dh.shape)} {dh.dtype}")
    if dh_t is not None and (
            dh_t.shape != (b, w) or dh_t.dtype != torch.float32
            or dh_t.device != x.device or not dh_t.is_contiguous()):
        raise ValueError(f"rg_lru_scan_bwd: dh_t must be ({b}, {w}) "
                         f"float32, got {tuple(dh_t.shape)} {dh_t.dtype}")
    if anchors.shape != anchor_shape(b, t, w) \
            or anchors.dtype != torch.float32 \
            or anchors.device != x.device or not anchors.is_contiguous():
        raise ValueError(f"rg_lru_scan_bwd: anchors must be a contiguous "
                         f"{anchor_shape(b, t, w)} float32 tensor, got "
                         f"{tuple(anchors.shape)} {anchors.dtype}")
    dx = torch.empty_like(x) if dx is None else dx
    da = torch.empty_like(a) if da is None else da
    dh0 = torch.empty((b, w), dtype=torch.float32, device=x.device)
    if t == 0 or b == 0 or w == 0:
        return dx, da, (torch.zeros_like(dh0) if dh_t is None
                        else dh_t.clone())
    if sched is None:
        sched = schedule(b, t, w, backward=True)
    elif sched != schedule(b, t, w, sched.chunk, sched.channel_tile,
                           backward=True):
        raise ValueError(f"rg_lru_scan_bwd: schedule {sched} is not a "
                         f"backward one for {tuple(x.shape)}")
    _check_scratch(scratch, sched)
    if scratch is None:
        scratch = torch.empty(sched.scratch_bytes // 4, dtype=torch.float32,
                              device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        sync = _sync(x.device, stream, sched.sync_words)
        rc = _build.lib().rt_rg_lru_bwd(
            x.data_ptr(), a.data_ptr(), dh.data_ptr(), anchors.data_ptr(),
            None if dh_t is None else dh_t.data_ptr(), dx.data_ptr(),
            da.data_ptr(), dh0.data_ptr(), scratch.data_ptr(),
            sync.data_ptr(), b, t, w, sched.channel_tile, sched.chunk,
            _vec(w, x, a, dh, dx, da), stream)
    _build.check(rc, "rg_lru_scan_bwd")
    bwd_launches += 1
    return dx, da, dh0


class _Scan(torch.autograd.Function):
    """The scan with its gradient.  On the CPU, or with ``plain``, both
    passes run the plain versions (``ref.rg_lru_scan``,
    ``ref.rg_lru_bwd``, which recomputes h); on a CUDA tensor the forward
    launches the kernel's training build, which keeps the fp32 anchors,
    and the backward the backward kernel, or they raise.  A cotangent
    autograd does not pass (h_T's, in training) comes as None: zeros."""

    @staticmethod
    def forward(ctx, x, a, h0, plain):
        ctx.set_materialize_grads(False)
        ctx.plain = plain
        if plain:
            h, h_t = ref.rg_lru_scan(x, a, h0)
            ctx.save_for_backward(x, a, h0)
        else:
            h, h_t, anchors = _forward(x, a, h0, with_anchors=True)
            ctx.save_for_backward(x, a, anchors)
        ctx.has_h0 = h0 is not None
        return h, h_t

    @staticmethod
    @once_differentiable
    def backward(ctx, dh, dh_t):
        x, a, third = ctx.saved_tensors
        if dh is not None:
            dh = dh.contiguous()
        if dh_t is not None:
            dh_t = dh_t.contiguous()
        if ctx.plain:
            dx, da, dh0 = ref.rg_lru_bwd(x, a, third, dh, dh_t)
        else:
            dx, da, dh0 = rg_lru_scan_bwd(x, a, third, dh, dh_t)
        return dx, da, dh0 if ctx.has_h0 else None, None


# ---------------------------------------------------------------------------
# the kernel's arithmetic, in plain PyTorch (tests only)
# ---------------------------------------------------------------------------

def _staged(x: torch.Tensor, a: torch.Tensor, sched: Schedule):
    """x and a in fp32 as the kernel stages them: padded past T with
    a = 1, x = 0 up to a whole unit, as (B, segments, segment, W)."""
    b, t, w = x.shape
    n_u = -(-t // sched.unit)
    pad = n_u * sched.unit - t
    shape = (b, n_u * sched.unit // sched.segment, sched.segment, w)
    return (F.pad(x.float(), (0, 0, 0, pad)).view(shape),
            F.pad(a.float(), (0, 0, 0, pad), value=1.0).view(shape))


def _fold(av: torch.Tensor, xv: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(A, X) of the steps along dimension 2, in order, from (1, 0):
    X ← a·X + x, A ← a·A."""
    A = torch.ones_like(av.select(2, 0))
    X = torch.zeros_like(A)
    for r in range(av.shape[2]):
        X = av[:, :, r] * X + xv[:, :, r]
        A = av[:, :, r] * A
    return A, X


def aggregates(x: torch.Tensor, a: torch.Tensor, *, sched: Schedule):
    """The kernel's aggregates: each segment's (A, X), (B, units,
    segments a unit, W), and each unit's, (B, units, W), in fp32; the
    units the kernel publishes are the first ``(n_chunks - 1) · chunk /
    unit``.  For the tests only."""
    xs, as_ = _staged(x, a, sched)
    b, n_s, _, w = xs.shape
    per = sched.unit // sched.segment
    sA, sX = (v.view(b, n_s // per, per, w) for v in _fold(as_, xs))
    return (sA, sX), _fold(sA, sX)


def chunked_model(x: torch.Tensor, a: torch.Tensor,
                  h0: torch.Tensor | None = None, *, sched: Schedule
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``csrc/rg_lru.cu``'s decomposition and rounding points, in plain
    PyTorch on any device, for any float dtype (fp32 carry).

    Steps past T are padded as a = 1, x = 0 up to a whole unit.  Each
    segment of ``sched.segment`` steps anchored at t = 0 folds its steps
    from (A, X) = (1, 0): X ← a·X + x, A ← a·A; each unit of
    ``sched.unit`` steps folds its segments' aggregates in time order the
    same way (:func:`aggregates`); the carry at each unit's start is the
    fold from ``h0`` (or 0) over every earlier unit, ``K ← A_u·K + X_u``;
    the carry at each segment's start continues from its unit's through
    the unit's earlier segments; each step is re-scanned from there,
    ``h ← a·h + x``, and rounded once to ``x.dtype``; h_T is the carry
    past the last unit.  Every product and sum is a separate fp32
    operation, as the kernel's ``__fmul_rn`` and ``__fadd_rn`` are.
    Nothing here depends on the schedule's tile or chunk, nor does the
    kernel's result.  Returns what :func:`rg_lru_scan` returns.  For the
    tests only: nothing on the served path calls it."""
    b, t, w = x.shape
    xs, as_, H, k = _segment_starts(x, a, h0, sched)
    out = torch.empty_like(xs)
    for r in range(sched.segment):
        H = as_[:, :, r] * H + xs[:, :, r]
        out[:, :, r] = H
    return out.view(b, -1, w)[:, :t].to(x.dtype), k


def _segment_starts(x, a, h0, sched: Schedule):
    """The staged x and a, the fp32 carry at each segment's start (B,
    segments, W) and h_T, as the forward kernel computes them: each
    unit's carry (its anchor) folded from h0 over every earlier unit,
    then on through the unit's earlier segments."""
    b, t, w = x.shape
    xs, as_ = _staged(x, a, sched)
    (sA, sX), (uA, uX) = aggregates(x, a, sched=sched)
    k = (torch.zeros((b, w), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    carries = []
    for u in range(uA.shape[1]):
        carries.append(k)
        k = uA[:, u] * k + uX[:, u]
    H = torch.stack(carries, 1)                      # (B, units, W)
    starts = []
    for q in range(sA.shape[2]):
        starts.append(H)
        H = sA[:, :, q] * H + sX[:, :, q]
    return xs, as_, torch.stack(starts, 2).view(b, -1, w), k


def chunked_bwd_model(x: torch.Tensor, a: torch.Tensor,
                      dh: torch.Tensor | None,
                      dh_t: torch.Tensor | None = None,
                      h0: torch.Tensor | None = None, *, sched: Schedule
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``csrc/rg_lru_bwd.cu``'s decomposition and rounding points, in
    plain PyTorch on any device: what :func:`rg_lru_scan_bwd` returns,
    bit for bit, for a forward from ``h0``.

    The reverse recurrence is the forward's form run backward in time,
    ``g_t = c_t·g_{t+1} + dh_t`` with ``c_t = a_{t+1}`` (1 for the last
    step and past T, where dh is padded 0 up to a whole unit), from
    ``dh_t`` (or 0).  Each 16-step segment folds its steps from the last,
    (C, G) = (1, 0): G ← c·G + dh, C ← c·C; each 64-step unit folds its
    segments' aggregates from the last the same way; the carry at each
    unit's end is the fold from ``dh_t`` over every later unit, from the
    last, ``K ← C_u·K + G_u``, and at each segment's end it continues
    from its unit's through the unit's later segments; each step is then
    re-scanned from there, dx_t = g_t and da_t = g_t·h_{t-1}, and dh0 =
    a_0·g_0.  h_{t-1} is the fp32 carry exactly as the forward kernel
    computes it (:func:`chunked_model`: the anchors, then the segments).
    Every product and sum is a separate fp32 operation.  Nothing here
    depends on the schedule's tile or chunk, nor does the kernel's
    result.  For the tests only."""
    b, t, w = x.shape
    xs, as_, H, _ = _segment_starts(x, a, h0, sched)
    shape = xs.shape
    n_s, seg = shape[1], shape[2]
    per = sched.unit // seg
    pad = n_s * seg - t
    dhs = (torch.zeros(shape, dtype=torch.float32, device=x.device)
           if dh is None else F.pad(dh.float(), (0, 0, 0, pad)).view(shape))
    af = as_.reshape(b, -1, w)
    c = torch.cat([af[:, 1:], torch.ones_like(af[:, :1])], 1).view(shape)
    hp = torch.empty_like(xs)                       # h_{t-1}
    for r in range(seg):
        hp[:, :, r] = H
        H = as_[:, :, r] * H + xs[:, :, r]
    C = torch.ones_like(xs[:, :, 0])
    G = torch.zeros_like(C)
    for r in reversed(range(seg)):
        G = c[:, :, r] * G + dhs[:, :, r]
        C = c[:, :, r] * C
    sC, sG = C.view(b, -1, per, w), G.view(b, -1, per, w)
    uC, uG = torch.ones_like(sC[:, :, 0]), torch.zeros_like(sG[:, :, 0])
    for q in reversed(range(per)):
        uG = sC[:, :, q] * uG + sG[:, :, q]
        uC = sC[:, :, q] * uC
    k = (torch.zeros((b, w), dtype=torch.float32, device=x.device)
         if dh_t is None else dh_t.float())
    ends = []
    for u in reversed(range(uC.shape[1])):
        ends.append(k)
        k = uC[:, u] * k + uG[:, u]
    K = torch.stack(ends[::-1], 1)                  # (B, units, W)
    seg_ends = []
    for q in reversed(range(per)):
        seg_ends.append(K)
        K = sC[:, :, q] * K + sG[:, :, q]
    G = torch.stack(seg_ends[::-1], 2).view(b, -1, w)
    dx, da = torch.empty_like(xs), torch.empty_like(xs)
    for r in reversed(range(seg)):
        G = c[:, :, r] * G + dhs[:, :, r]
        dx[:, :, r] = G
        da[:, :, r] = G * hp[:, :, r]
    dh0 = as_[:, 0, 0] * G[:, 0]
    return (dx.view(b, -1, w)[:, :t].to(x.dtype),
            da.view(b, -1, w)[:, :t].to(a.dtype), dh0)
