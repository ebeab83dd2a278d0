"""The stabilised mLSTM scan (xLSTM) as a hand-written Hopper kernel, with
its gradient.

Source note.  Replaces the TPU kernel ``repro/kernels/mlstm.py:
mlstm_scan``: per (batch, head), from ``C = 0, n = 0, m = 0``, the
matrix memory ``C`` (Dh × Dh), normaliser ``n`` and log-space stabiliser
``m`` carried in fp32, ``q̃ = q·Dh^-0.5``, every ``h_t`` rounded once to
bf16.  With ``return_state`` it also returns the final ``C``, ``n`` and
``m`` in fp32 (what ``repro.kernels.ref.mlstm_scan(..., return_state=
True)`` computes): every mLSTM layer's prefill in serving runs it so, and
the stateless ``forward`` runs it without.

The kernel (``csrc/mlstm.cu``) computes the scan chunkwise on the tensor
cores.  Inside a chunk of L = 64 steps anchored at t = 0, with b_t the
in-chunk cumulative sum of log σ(f) and m_t the reference's own
step-by-step stabiliser, the recurrence unrolls exactly to

    C_t = exp(b_t + m_prev − m_t)·C_prev
          + Σ_{s≤t} exp(b_t − b_s + i_s − m_t)·v_s k_sᵀ

(every weight ≤ 1), so a chunk is four products: ``S = Q Kᵀ``, the
inter-chunk ``Q C_prevᵀ``, the intra-chunk ``(S∘D) V`` and the state
update ``Cᵀ ← g·Cᵀ + Kᵀ (w∘V)``; ``n`` rides along as one more row of
``C`` in the products that read it.  Every fp32 operand of a product
(the state, ``S∘D``, ``w∘V``) enters the tensor cores as a bf16 hi/lo
pair, two products into one fp32 accumulator: a single bf16 rounding of
them misses the state's tolerance (:func:`chunkwise_model` with
``split=False``; ``tests/test_torch_mlstm_chunkwise.py``).  Bound on an
H100: the function's ``4·Dh² + 4·L·Dh`` tensor-core operations a step
and head against ``8·Dh`` bytes, so operations bound it: 0.037 ms at
B = 1, H = 4, T = 2048, Dh = 1024.  The split products double that
work (``8·Dh² + 6·L·Dh``, 0.073 ms).  A call is two
device kernels: ``mlstm_qk_kernel`` writes each chunk's ``Q Kᵀ`` (fp32,
``4·L²`` bytes a chunk and head) and ``mlstm_scan_kernel`` runs the
chunks in order, one block per 32 columns of one head's C.
:func:`schedule` picks the ring's depth and both grids from the shape
alone.  The plain version is :func:`repro_torch.kernels.ref.mlstm_scan`.

Training goes through :func:`mlstm_scan` too, as a
``torch.autograd.Function``.  Its forward launches the same kernel built
with a template flag that also writes what the backward reads: at each
chunk's start the fp32 state it already holds (``C_prev`` with ``n_prev``
as one more row, (Dh + 1) × Dh, and ``m_prev``), and at each step the
fp32 h and the denominator with the sign the output took through it
(:func:`saved_shapes`).  Its backward (``csrc/mlstm_bwd.cu``,
:func:`mlstm_scan_bwd`) is what autodiff of the plain scan computes,
with one simplification that is exact: h does not depend on m (the
stabilised state is exp(−m)·the unstabilised one, and so is the floor),
so the gradient is the one with m held constant.  With m frozen the gates'
gradients are row dots: ``d i_s = k_s·dk_s`` and ``d log σ(f_r) =
Σ_{t ≥ r} (q_t·dq_t − k_t·dk_t)``.  Per chunk, from the saved state and
the end-of-chunk state gradient dC (carried backward)::

    dH̃ = [dh/den, −(dh·h)/den·sign(n·q̃)]   (0 where the floor wins)
    dP = dH̃ Vᵉˣᵗᵀ,   dQ = gq∘(dH̃ C_prevᵉˣᵗ) + (dP∘D) K
    dK = (dP∘D)ᵀ Q + w∘(Vᵉˣᵗ dC),   dV = (S∘D)ᵀ dNum + w∘(K dCᵀ)
    dC ← g_end·dC + dH̃ᵀ (gq∘Q)

Four device kernels: a prep kernel per (chunk, head) forms the gates'
weights, ``(S∘D/den)ᵀ`` (fp32) and ``dP∘D`` (a bf16 pair), L × L each; a
state pass, the forward's scan kernel run from the last chunk back with
the tensors swapped (``dCᵀ ← g_end·dCᵀ + Qᵀ [gi∘dH̃ | gn]`` has the state
update's shape, ``w∘(K dCᵀ)`` the inter-chunk product's and ``(S∘D)ᵀ
dNum`` the intra-chunk one's), one block per 32 columns of dv of one
head: it writes dV whole, and each chunk's end-gradient dC for dK, but
not the last chunk's, which is zero; a gradient kernel per (64 columns,
chunk, head) and output (dQ or dK) takes the full Dh sum inside the block
through a TMA ring, the fp32 state tile split into a bf16 pair in
registers as ``wgmma``'s A operand, and writes its columns' share of the
row dots; a gate kernel sums the shares in a fixed order and takes the
reverse cumulative sum.  The same split-bf16 rule, no atomics: two
launches are bit-identical.  :func:`bwd_schedule` gives the grids,
footprints and scratch; :func:`chunkwise_bwd_model` the arithmetic on
the CPU, in the kernels' order; :func:`repro_torch.kernels.ref.mlstm_bwd`
is the plain version.  Bound: ``8·Dh² + 10·L·Dh`` operations a step and
head, and the saved states read once (``PERF.md``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build, ref

# kernel launches since the last reset (``chip_smoke.py`` reads them): the
# forward's, one a call (two device kernels), and the backward's, one a
# call (four device kernels)
launches = 0
bwd_launches = 0

MAX_HEAD_DIM = 1024
SMEM_LIMIT = 232_448              # dynamic shared memory a block may use
CHUNK = 64                        # the chunk length the kernels take
DV = 32                           # columns of one head's C a block owns
OWNERS = 4                        # warpgroups that hold the state
MAX_STAGES = 8                    # Q/K ring stages the kernel can hold
QK_STAGES = 4                     # the Q Kᵀ kernel's ring
CHUNK_BUFFERS = 2                 # the gate scan runs a chunk ahead
MAX_BH = 65535                    # (batch, head) pairs: grid dimension y
# the backward's gradient kernel: columns of dQ or dK a block owns, and
# its ring's stages
BWD_COLS = 64
GRAD_STAGES = 3
# the backward's state pass: one ring stage an owner, as the forward's
# scan (stages_for).  Slot s is then filled for owner s only, so an
# owner's parity wait, which knows only that its own previous tile has
# landed, finds the slot's previous phase complete whatever order TMA
# completes loads in.  At six stages a slot's previous tile was another
# owner's, and the card gave other bits now and then, then a launch
# failure; eight do not fit.
BWD_STATE_STAGES = OWNERS


def dk_tiles(head_dim: int) -> int:
    """64-row tiles of Cᵀ's Dh rows, padded to a multiple of the four
    owner warpgroups (the rows past Dh stay zero)."""
    return OWNERS * -(-head_dim // (64 * OWNERS))


def _slot_bytes() -> int:
    # a Q and a K tile (L rows x 64 columns, bf16) and the state's hi / lo
    # pair for one 64-row tile of Cᵀ (40 rows: 32 columns of C, n, and 7
    # zero rows, x 64, bf16)
    return 2 * CHUNK * 128 + 2 * 40 * 128


def _chunk_bytes() -> int:
    # one chunk buffer: w∘V's hi and lo (32 x L bf16), V with its ones row
    # (40 x L) and w's hi / lo pair (8 x L), 1 KB-aligned; the chunk's
    # weights (5 L + 2 fp32, padded to 16 bytes); its staged i, f (fp32)
    # and 32 columns of V (bf16)
    return (2 * 32 * 128 + 40 * 128 + 1024 + (5 * CHUNK + 4) * 4
            + 2 * CHUNK * 4 + CHUNK * 64)


def smem_bytes_for(stages: int) -> int:
    """Dynamic shared memory of one scan block (csrc/mlstm.cu:
    Cfg::smem_bytes must agree): 1 KB of alignment slack, the ring, the
    chunk buffers and 256 B of mbarriers."""
    return (1024 + stages * _slot_bytes() + CHUNK_BUFFERS * _chunk_bytes()
            + 256)


def stages_for() -> int:
    """The ring's depth: the largest multiple of :data:`OWNERS` that fits,
    at most MAX_STAGES (4: eight do not fit).  Each owner warpgroup waits
    on a slot's full barrier by phase parity, which is sound only if the
    slot's previous tile was the owner's own: the owner has waited for
    it, so the barrier cannot be a phase behind.  An owner's tiles are
    every fourth (tile nt belongs to owner nt mod 4), so with a multiple
    of four stages slot s only ever holds owner s mod 4's tiles.  With
    any other depth a slot serves the owners in turn, and an owner knows
    only that its own earlier tile has landed, not the other owner's tile
    the slot held before: if TMA completes that one later, the wait sees
    the parity it waits for a phase early and reads a slot TMA is still
    filling (the backward's state pass, the same kernel shape, gave other
    bits and then a launch failure at six stages on the card; this
    kernel faulted at two and three)."""
    n = MAX_STAGES - MAX_STAGES % OWNERS
    while smem_bytes_for(n) > SMEM_LIMIT:
        n -= OWNERS
    assert n >= OWNERS, n
    return n


def qk_smem_bytes() -> int:
    """Dynamic shared memory of one ``Q Kᵀ`` block: 1 KB of slack,
    QK_STAGES of a 64-row Q tile and an L-row K tile, 256 B of
    mbarriers."""
    return 1024 + QK_STAGES * (64 * 128 + CHUNK * 128) + 256


@dataclasses.dataclass(frozen=True)
class Schedule:
    """What a call launches: the chunk length, the 64-row tiles of Cᵀ
    (``dk_tiles``, ``tiles_per_owner`` a warpgroup), the ring's stages,
    the scan's grid (32-column slices of C, batch × heads), the ``Q Kᵀ``
    kernel's blocks, each kernel's shared memory and the fp32 scratch of
    ``Q Kᵀ`` the two kernels pass between them."""
    chunk: int
    n_chunks: int
    dk_tiles: int
    stages: int
    grid: tuple[int, int]
    qk_grid: int
    smem_bytes: int
    qk_smem_bytes: int
    scratch_bytes: int

    @property
    def tiles_per_owner(self) -> int:
        return self.dk_tiles // OWNERS

    @property
    def label(self) -> str:
        return (f"L={self.chunk}, {self.stages} stages, grid "
                f"{self.grid[0]}x{self.grid[1]} + qk {self.qk_grid}")


def _check_shape(b: int, h: int, t: int, dh: int, what: str) -> None:
    if dh % 32 or not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"{what} kernel takes a head dim that is a "
                         f"multiple of 32 up to {MAX_HEAD_DIM}, got {dh}")
    if not 0 < b * h <= MAX_BH:
        raise ValueError(f"{what} kernel takes 1 to {MAX_BH} (batch, "
                         f"head) pairs, got {b * h}")
    if t < 1:
        raise ValueError(f"{what} kernel takes T >= 1, got {t}")


def schedule(b: int, h: int, t: int, dh: int) -> Schedule:
    """The launch for (B, H, T, Dh), in chunks of :data:`CHUNK` steps.
    Refuses a head dim that is not a multiple of 32 up to 1024, more than
    65535 (batch, head) pairs, and T < 1."""
    _check_shape(b, h, t, dh, "mlstm_scan")
    n_chunks = -(-t // CHUNK)
    stages = stages_for()
    return Schedule(
        chunk=CHUNK, n_chunks=n_chunks, dk_tiles=dk_tiles(dh), stages=stages,
        grid=(dh // DV, b * h), qk_grid=n_chunks * b * h,
        smem_bytes=smem_bytes_for(stages), qk_smem_bytes=qk_smem_bytes(),
        scratch_bytes=4 * b * h * n_chunks * CHUNK * CHUNK)


def saved_shapes(b: int, h: int, t: int, dh: int) -> dict:
    """What a training forward writes for the backward: ``states``, the
    fp32 state at each chunk's start (C_prev's Dh rows, then n_prev),
    ``m0`` its m_prev, ``hf`` the fp32 h before its bf16 rounding, and
    ``den`` each step's denominator with the sign h took through it (+1
    or −1 where |n·q̃| won, 0 where the floor exp(−m) won)."""
    nc = -(-t // CHUNK)
    return {"states": (b, h, nc, dh + 1, dh), "m0": (b, h, nc),
            "hf": (b, h, t, dh), "den": (b, h, t, 2)}


def _check(q, k, v, i_pre, f_pre) -> None:
    ts = (q, k, v, i_pre, f_pre)
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
    if not all(u.is_contiguous() for u in ts) or \
            any(u.data_ptr() % 16 for u in (q, k, v)):
        raise ValueError("mlstm_scan kernel takes contiguous operands, "
                         "q, k, v 16-byte aligned")


def _plain(plain: bool, *ts: torch.Tensor) -> bool:
    return plain or all(t.device.type == "cpu" for t in ts)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_pre: torch.Tensor, f_pre: torch.Tensor, *,
               return_state: bool = False, plain: bool = False):
    """q, k, v (B, H, T, Dh); i_pre, f_pre (B, H, T) → h (B, H, T, Dh) in
    ``q.dtype``, and with ``return_state`` also ``{"C": (B, H, Dh, Dh),
    "n": (B, H, Dh), "m": (B, H)}`` in fp32; h with its gradient where
    autograd asks for one.

    A CPU tensor, or ``plain``, runs the plain versions; a CUDA tensor
    launches the kernel (and, in the backward pass, the backward kernels)
    or raises.  The kernel takes contiguous bf16 q, k, v, fp32 gates and
    a head dim that is a multiple of 32 up to 1024.  The final state has
    no gradient on the card: a CUDA call with ``return_state`` under
    autograd raises (serving's prefill, which asks for the state, runs
    without autograd)."""
    ts = (q, k, v, i_pre, f_pre)
    is_plain = _plain(plain, *ts)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in ts)
    if grad and not return_state:
        return _Scan.apply(q, k, v, i_pre, f_pre, is_plain)
    if is_plain:
        return ref.mlstm_scan(q, k, v, i_pre, f_pre,
                              return_state=return_state)
    if grad:
        raise NotImplementedError("mlstm_scan: the final state has no "
                                  "backward kernel; call it without "
                                  "return_state to train")
    return _forward(q, k, v, i_pre, f_pre, return_state=return_state,
                    train=False)[0]


def _forward(q, k, v, i_pre, f_pre, *, return_state: bool, train: bool):
    """The forward kernel on CUDA tensors: (h or (h, state), the saved
    tensors of :func:`saved_shapes` with ``train``, else None)."""
    _check(q, k, v, i_pre, f_pre)
    b, h, t, dh = q.shape
    saved = None
    if train:
        saved = {n: torch.empty(s, dtype=torch.float32, device=q.device)
                 for n, s in saved_shapes(b, h, t, dh).items()}
    if t == 0 or b * h == 0:
        out = torch.empty_like(q)
        if not return_state:
            return out, saved
        return (out, {"C": q.new_zeros((b, h, dh, dh), dtype=torch.float32),
                      "n": q.new_zeros((b, h, dh), dtype=torch.float32),
                      "m": q.new_zeros((b, h), dtype=torch.float32)}), saved
    return _launch(q, k, v, i_pre, f_pre, schedule(b, h, t, dh),
                   return_state, None, None, None, saved), saved


def run_schedule(q, k, v, i_pre, f_pre, sched: Schedule, *,
                 return_state: bool = False, out=None, state=None,
                 scratch=None, saved=None):
    """Launch the kernel on ``sched`` (CUDA tensors, checked as
    :func:`mlstm_scan` checks them; ``sched`` must be the shape's
    schedule).  ``out``, ``state`` (a dict of C, n, m), ``scratch``
    (``sched.scratch_bytes`` of fp32) and ``saved`` (the tensors of
    :func:`saved_shapes`: the training build) may be handed in, as the
    card tests do to fill them with NaN first; otherwise they are
    allocated here (and ``saved`` is not written)."""
    _check(q, k, v, i_pre, f_pre)
    b, h, t, dh = q.shape
    if sched != schedule(b, h, t, dh):
        raise ValueError(f"mlstm_scan: schedule {sched} is not the one for "
                         f"{tuple(q.shape)}")
    if scratch is not None and \
            scratch.numel() * scratch.element_size() < sched.scratch_bytes:
        raise ValueError(f"mlstm_scan: scratch of "
                         f"{scratch.numel() * scratch.element_size()} B, "
                         f"the schedule needs {sched.scratch_bytes}")
    if saved is not None:
        _check_saved(saved, q)
    return _launch(q, k, v, i_pre, f_pre, sched, return_state, out, state,
                   scratch, saved)


def _check_saved(saved: dict, q: torch.Tensor) -> None:
    want = saved_shapes(*q.shape)
    if set(saved) != set(want) or any(
            saved[n].shape != want[n] or saved[n].dtype != torch.float32
            or saved[n].device != q.device or not saved[n].is_contiguous()
            for n in want):
        raise ValueError(f"mlstm_scan: the saved tensors must be "
                         f"contiguous float32 {want}")


def _launch(q, k, v, i_pre, f_pre, sched: Schedule, return_state: bool,
            out, state, scratch, saved=None):
    global launches
    b, h, t, dh = q.shape
    dev = q.device
    if out is None:
        out = torch.empty_like(q)
    if return_state and state is None:
        state = {"C": torch.empty((b, h, dh, dh), dtype=torch.float32,
                                  device=dev),
                 "n": torch.empty((b, h, dh), dtype=torch.float32,
                                  device=dev),
                 "m": torch.empty((b, h), dtype=torch.float32, device=dev)}
    if scratch is None:
        scratch = torch.empty(sched.scratch_bytes // 4, dtype=torch.float32,
                              device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _build.lib().rt_mlstm_scan(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
            f_pre.data_ptr(), out.data_ptr(),
            *((state["C"].data_ptr(), state["n"].data_ptr(),
               state["m"].data_ptr()) if return_state
              else (None, None, None)),
            scratch.data_ptr(),
            *((saved["states"].data_ptr(), saved["m0"].data_ptr(),
               saved["hf"].data_ptr(), saved["den"].data_ptr())
              if saved is not None else (None, None, None, None)),
            b * h, t, dh, sched.stages, stream)
    _build.check(rc, "mlstm_scan")
    launches += 1
    return (out, state) if return_state else out


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

def prep_smem_bytes() -> int:
    """Dynamic shared memory of one prep block (csrc/mlstm_bwd.cu:
    prep_smem_bytes must agree): two stages of Q, K, dh and V tiles of 64
    steps x 64 columns (bf16, rows padded by 8) and of h's (fp32, rows
    padded by 4), and 16 fp32 arrays of L steps."""
    return 2 * (4 * CHUNK * 72 * 2 + CHUNK * 68 * 4) + 16 * CHUNK * 4


def _bwd_slot_bytes() -> int:
    # a Q and a K tile (L rows x 64 columns, bf16) and the end-gradient's
    # hi / lo pair for one 64-row tile of dCᵀ (32 columns of dC x 64, bf16)
    return 2 * CHUNK * 128 + 2 * 32 * 128


def _bwd_chunk_bytes() -> int:
    # one chunk buffer: gi∘dh's hi and lo and dh (32 x L bf16 each, K-major
    # [dv][t]), gn's hi / lo pair (8 x L), (S∘D/den)ᵀ (L rows of 64 + 8
    # fp32), dh's 32 columns as loaded (L x 32 bf16) and the chunk's
    # weights (gi, gn, w, g_end: 4 L fp32); 1 KB-aligned
    raw = (3 * 32 * 128 + 1024 + CHUNK * 72 * 4 + CHUNK * 32 * 2
           + 4 * CHUNK * 4)
    return -(-raw // 1024) * 1024


def bwd_state_smem_bytes(stages: int) -> int:
    """... of one state-pass block (csrc/mlstm_bwd.cu: state_smem_bytes):
    1 KB of alignment slack, the ring, the two chunk buffers and 256 B of
    mbarriers; the same at every head dim."""
    return (1024 + stages * _bwd_slot_bytes()
            + CHUNK_BUFFERS * _bwd_chunk_bytes() + 256)


def grad_smem_bytes() -> int:
    """... of one gradient block: 1 KB of slack, GRAD_STAGES ring stages
    (a 64-step x 64-column bf16 box of dh or V and a 64 x 64 fp32 tile of
    the saved state or its gradient), the Q and K boxes and dS's bf16 pair
    (L x L each), 7 fp32 arrays of 64 (the columns' scale, the rank-1
    term's weight and values, the row dots' four warp shares) and 64 B of
    mbarriers."""
    return (1024 + GRAD_STAGES * 3 * CHUNK * 128 + 4 * CHUNK * 128
            + 7 * 64 * 4 + 64)


@dataclasses.dataclass(frozen=True)
class BwdSchedule:
    """What a backward call launches: the chunks, the column tiles of a
    gradient block, the state pass's ring depth, each kernel's grid and
    shared memory, and its fp32 scratch: the end-gradient of each chunk's
    state but the last (``grad_state``, zero at one chunk), each chunk's
    two L × L matrices and weights (``chunk``), and the row dots' column
    shares (``dots``)."""
    chunk: int
    n_chunks: int
    col_tiles: int
    state_stages: int
    prep_grid: tuple[int, int]
    state_grid: tuple[int, int]
    grad_grid: tuple[int, int, int]
    gate_grid: int
    prep_smem_bytes: int
    state_smem_bytes: int
    grad_smem_bytes: int
    grad_state_bytes: int
    chunk_bytes: int
    dots_bytes: int

    @property
    def scratch_bytes(self) -> int:
        return self.grad_state_bytes + self.chunk_bytes + self.dots_bytes

    @property
    def label(self) -> str:
        g = self.grad_grid
        return (f"L={self.chunk}, prep {self.prep_grid[0]}x"
                f"{self.prep_grid[1]}, state {self.state_grid[0]}x"
                f"{self.state_grid[1]} ({self.state_stages} stages), grad "
                f"{g[0]}x{g[1]}x{g[2]}, gates {self.gate_grid}")


def bwd_schedule(b: int, h: int, t: int, dh: int) -> BwdSchedule:
    """The backward's launch for (B, H, T, Dh): prep blocks per (chunk,
    head), state-pass blocks per 32 columns of dv and head, gradient
    blocks per (64 columns x 2 outputs, chunk, head), one gate block a
    head.  Refuses what :func:`schedule` refuses."""
    _check_shape(b, h, t, dh, "mlstm_scan_bwd")
    bh = b * h
    nc = -(-t // CHUNK)
    tiles = -(-dh // BWD_COLS)
    stages = BWD_STATE_STAGES
    return BwdSchedule(
        chunk=CHUNK, n_chunks=nc, col_tiles=tiles, state_stages=stages,
        prep_grid=(nc, bh), state_grid=(dh // DV, bh),
        grad_grid=(2 * tiles, nc, bh), gate_grid=bh,
        prep_smem_bytes=prep_smem_bytes(),
        state_smem_bytes=bwd_state_smem_bytes(stages),
        grad_smem_bytes=grad_smem_bytes(),
        grad_state_bytes=4 * bh * (nc - 1) * (dh + 1) * dh,
        chunk_bytes=4 * bh * nc * (2 * CHUNK * CHUNK + 4 * CHUNK),
        dots_bytes=4 * bh * 2 * tiles * t)


def mlstm_scan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_pre: torch.Tensor, f_pre: torch.Tensor, saved: dict,
                   dh: torch.Tensor, *, grads: tuple | None = None,
                   scratch: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv, di, df) by the backward kernels (``csrc/mlstm_bwd.cu``)
    for CUDA bf16 q, k, v, fp32 gates, the training forward's ``saved``
    tensors and the bf16 cotangent ``dh`` of h: dq, dk, dv in bf16, di
    and df in fp32.  :func:`repro_torch.kernels.ref.mlstm_bwd` is the
    plain version and :func:`chunkwise_bwd_model` the arithmetic.
    ``grads`` (the five outputs) and ``scratch`` (``scratch_bytes`` of
    :func:`bwd_schedule`) may be handed in, as the card tests do to fill
    them with NaN first."""
    global bwd_launches
    _check(q, k, v, i_pre, f_pre)
    _check_saved(saved, q)
    if dh.shape != q.shape or dh.dtype != torch.bfloat16 \
            or dh.device != q.device or not dh.is_contiguous() \
            or dh.data_ptr() % 16:
        raise ValueError(f"mlstm_scan_bwd: dh must be a contiguous, 16-byte "
                         f"aligned bf16 {tuple(q.shape)} tensor beside q, "
                         f"got {tuple(dh.shape)} {dh.dtype}")
    b, h, t, d = q.shape
    if grads is None:
        grads = (torch.empty_like(q), torch.empty_like(k),
                 torch.empty_like(v), torch.empty_like(i_pre),
                 torch.empty_like(f_pre))
    sched = bwd_schedule(b, h, t, d)
    if scratch is None:
        scratch = torch.empty(sched.scratch_bytes // 4, dtype=torch.float32,
                              device=q.device)
    elif scratch.numel() * scratch.element_size() < sched.scratch_bytes:
        raise ValueError(f"mlstm_scan_bwd: scratch of "
                         f"{scratch.numel() * scratch.element_size()} B, "
                         f"the schedule needs {sched.scratch_bytes}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _build.lib().rt_mlstm_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
            f_pre.data_ptr(), saved["states"].data_ptr(),
            saved["m0"].data_ptr(), saved["hf"].data_ptr(),
            saved["den"].data_ptr(), dh.data_ptr(),
            *(g.data_ptr() for g in grads), scratch.data_ptr(),
            b * h, t, d, stream)
    _build.check(rc, "mlstm_scan_bwd")
    bwd_launches += 1
    return grads


class _Scan(torch.autograd.Function):
    """The scan with its gradient.  With ``plain`` both passes run the
    plain versions (``ref.mlstm_scan``; ``ref.mlstm_bwd``, autograd
    through the plain scan run again in checkpointed chunks); otherwise
    the forward launches the kernel's training build, which keeps the
    tensors of :func:`saved_shapes`, and the backward the backward
    kernels, or they raise."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, f_pre, plain):
        ctx.plain = plain
        if plain:
            ctx.save_for_backward(q, k, v, i_pre, f_pre)
            return ref.mlstm_scan(q, k, v, i_pre, f_pre)
        h, saved = _forward(q, k, v, i_pre, f_pre, return_state=False,
                            train=True)
        ctx.names = tuple(saved)
        ctx.save_for_backward(q, k, v, i_pre, f_pre, *saved.values())
        return h

    @staticmethod
    @once_differentiable
    def backward(ctx, dh):
        q, k, v, i_pre, f_pre, *rest = ctx.saved_tensors
        dh = dh.contiguous()
        if ctx.plain:
            grads = ref.mlstm_bwd(q, k, v, i_pre, f_pre, dh)
        elif q.shape[2] == 0 or q.shape[0] * q.shape[1] == 0:
            grads = tuple(torch.zeros_like(x) for x in (q, k, v, i_pre,
                                                        f_pre))
        else:
            grads = mlstm_scan_bwd(q, k, v, i_pre, f_pre,
                                   dict(zip(ctx.names, rest)), dh)
        return (*grads, None)


# ---------------------------------------------------------------------------
# the kernels' arithmetic, in plain PyTorch (tests only)
# ---------------------------------------------------------------------------

def _split(x: torch.Tensor, split: bool) -> list[torch.Tensor]:
    """x as the bf16 operands the kernel feeds the tensor cores: the pair
    hi = bf16(x), lo = bf16(x - hi), or hi alone; as fp32 tensors."""
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()] if split else [hi]


def _mm(a_parts: list[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    """Σ over the parts of a @ b in fp32: one accumulator, two products."""
    out = a_parts[0] @ b
    for a in a_parts[1:]:
        out = out + a @ b
    return out


def _gate_scan(lf: torch.Tensor, ig: torch.Tensor, m_prev: torch.Tensor,
               c: int, L: int):
    """Chunk c's b_t (the in-chunk sum of log σ(f)) and m_t (the
    stabiliser step by step, as the reference computes it), (B, H, L)
    each, from m_prev."""
    mm, bb = m_prev, torch.zeros_like(m_prev)
    ms, bs = [], []
    for u in range(L):
        bb = bb + lf[..., c * L + u]
        mm = torch.maximum(lf[..., c * L + u] + mm, ig[..., c * L + u])
        ms.append(mm)
        bs.append(bb)
    return torch.stack(bs, -1), torch.stack(ms, -1)


def _padded(q, k, v, i_pre, f_pre, L: int):
    """q, k, v in fp32 and the gates, padded to whole chunks with steps
    of i = -inf, f = +inf and zero q, k, v (they contribute exact zeros);
    log σ(f) for the gates."""
    t = q.shape[2]
    pad = -(-t // L) * L - t
    qf, kf, vf = (F.pad(x.float(), (0, 0, 0, pad)) for x in (q, k, v))
    ig = F.pad(i_pre.float(), (0, pad), value=-math.inf)
    lf = F.logsigmoid(F.pad(f_pre.float(), (0, pad), value=math.inf))
    return qf, kf, vf, ig, lf


def _chunkwise(q, k, v, i_pre, f_pre, chunk: int, split: bool):
    """The forward kernel's chunks: (fp32 h of every padded step, the
    final C, n, m, and per chunk what the training build saves)."""
    b, h, t, dh = q.shape
    scale = dh ** -0.5
    L = chunk
    nc = -(-t // L)
    qf, kf, vf, ig, lf = _padded(q, k, v, i_pre, f_pre, L)
    C = q.new_zeros((b, h, dh, dh), dtype=torch.float32)   # C[dv, dk]
    n = q.new_zeros((b, h, dh), dtype=torch.float32)
    m = q.new_zeros((b, h), dtype=torch.float32)
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    out = q.new_empty((b, h, nc * L, dh), dtype=torch.float32)
    den_all = q.new_empty((b, h, nc * L, 2), dtype=torch.float32)
    states, m0 = [], []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        Q, K, V, i_c = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl], ig[..., sl]
        m_prev = m
        b_t, m_t = _gate_scan(lf, ig, m_prev, c, L)
        a, e = b_t - m_t, i_c - b_t
        gq = scale * torch.exp(b_t + m_prev[..., None] - m_t)
        floor = torch.exp(-m_t)
        b_end, m_end = b_t[..., -1], m_t[..., -1]
        w = torch.exp(e + (b_end - m_end)[..., None])
        g_end = torch.exp(b_end + m_prev - m_end)

        S = Q @ K.transpose(-1, -2)
        D = torch.where(causal, scale * torch.exp(a[..., :, None]
                                                  + e[..., None, :]), 0.0)
        P = _split(S * D, split)
        ext = torch.cat([C, n[..., None, :]], -2)          # (dv + 1, dk)
        states.append(ext)
        m0.append(m_prev)
        parts = _split(ext, split)
        inter = Q @ parts[0].transpose(-1, -2)
        for part in parts[1:]:
            inter = inter + Q @ part.transpose(-1, -2)
        vx = torch.cat([V, torch.ones_like(V[..., :1])], -1)
        hx = gq[..., None] * inter + _mm(P, vx)
        nq = hx[..., dh]
        den = torch.maximum(nq.abs(), floor)
        out[:, :, sl] = hx[..., :dh] / den[..., None]
        den_all[:, :, sl, 0] = den
        den_all[:, :, sl, 1] = torch.where(nq.abs() > floor, torch.sign(nq),
                                           0.0)

        wv = _split(w[..., None] * V, split)
        C = g_end[..., None, None] * C + _mm(
            [x.transpose(-1, -2) for x in wv], K)
        n = g_end[..., None] * n + _mm(
            [x[..., None, :] for x in _split(w, split)], K)[..., 0, :]
        m = m_end
    saved = {"states": torch.stack(states, 2), "m0": torch.stack(m0, -1),
             "hf": out[:, :, :t], "den": den_all[:, :, :t]}
    return out, {"C": C, "n": n, "m": m}, saved


def chunkwise_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_pre: torch.Tensor, f_pre: torch.Tensor, *,
                    chunk: int = CHUNK, split: bool = True,
                    return_state: bool = False, saved: bool = False):
    """``csrc/mlstm.cu``'s decomposition and rounding points on the CPU.

    Chunks of ``chunk`` steps anchored at t = 0, the last padded with
    steps of gates i = -inf, f = +inf and zero q, k, v (they contribute
    exact zeros); per chunk the stabiliser m step by step as the
    reference computes it, b the in-chunk cumulative sum of log σ(f), the
    weights exp(b_t - b_s + i_s - m_t), ``S = Q Kᵀ`` on the bf16 inputs,
    ``(S∘D) V`` and ``Q C_prevᵀ`` (n as one more row of C) and the state
    update ``C ← g·C + (w∘V)ᵀ K`` with every fp32 operand split into a
    bf16 hi/lo pair (``split=False``: rounded once to bf16), all
    accumulated in fp32; n's update ``n ← g·n + w Kᵀ`` with w split the
    same way, as the kernel runs it on the tensor cores (an m64n8
    product).  Returns what :func:`mlstm_scan` returns, and with
    ``saved`` also what the training build saves
    (:func:`saved_shapes`).  For the tests only: nothing on the served
    path calls it."""
    t = q.shape[2]
    out, state, kept = _chunkwise(q, k, v, i_pre, f_pre, chunk, split)
    h_out = out[:, :, :t].to(q.dtype)
    res = (h_out, state) if return_state else h_out
    return (res, kept) if saved else res


def chunkwise_bwd_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        i_pre: torch.Tensor, f_pre: torch.Tensor,
                        dh: torch.Tensor, *, chunk: int = CHUNK,
                        split: bool = True) -> tuple[torch.Tensor, ...]:
    """``csrc/mlstm_bwd.cu``'s decomposition and rounding points on the
    CPU: (dq, dk, dv) in their inputs' dtype and (di, df) in fp32, for
    the forward :func:`chunkwise_model` runs (its saved tensors).

    m held constant (the exact gradient: h does not depend on m).  Per
    chunk, with the forward's weights recomputed from the gates and
    m_prev: ``inv = 1/den``, ``dHn = −sign·(dh·h_fp32)/den`` (0 where
    the floor won), ``gi = gq·inv``, ``gn = gq·dHn``; ``S = Q Kᵀ`` and
    ``U = dh Vᵀ`` on the bf16 inputs; ``Pi = (S∘D)·inv``, ``dS = (inv·U
    + dHn)∘D``.  The state pass walks the chunks from the last, dC = 0
    there; at chunk c, dC its end-gradient, it forms::

        dV = w∘(K dC[:Dh]ᵀ) + Piᵀ dh

    keeps dC for dK unless c is the last chunk (dC is zero there), and
    takes ``dC ← g_end·dC + [gi∘dh | gn]ᵀ Q``.  Then per chunk, X its
    saved start state::

        dQ = gi∘(dh X[:Dh]) + gn ⊗ X[Dh] + dS K
        dK = w∘(V dC[:Dh]) + w ⊗ dC[Dh] + dSᵀ Q   (dSᵀ Q alone on the last)

    every fp32 operand of a product split into a bf16 hi/lo pair
    (``split=False``: rounded once), sums in fp32.  The gates from the
    fp32 row dots: di = k·dk, d log σ(f) the reverse cumulative sum of
    q·dq − k·dk over the whole sequence, df = σ(−f)·d log σ(f).  For the
    tests only."""
    b, h, t, d = q.shape
    L = chunk
    nc = -(-t // L)
    per = _bwd_chunks(q, k, v, i_pre, f_pre, dh, L, split)
    # the state pass, from the last chunk: dV, and the end-gradients
    G = q.new_zeros((b, h, d + 1, d), dtype=torch.float32)
    ends = [None] * nc
    dq, dk, dv = (torch.empty((b, h, nc * L, d), dtype=torch.float32,
                              device=q.device) for _ in range(3))
    for c in reversed(range(nc)):
        z = per[c]
        sl = slice(c * L, (c + 1) * L)
        dv[:, :, sl] = _sum_mm(z["K"], [x.transpose(-1, -2) for x in
                                        _split(G[..., :d, :], split)]) \
            * z["w"][..., None] + _mm(_split(z["Pi"].transpose(-1, -2),
                                             split), z["dH"])
        if c < nc - 1:
            ends[c] = G
        A = torch.cat([z["gi"][..., None] * z["dH"], z["gn"][..., None]], -1)
        G = z["g_end"][..., None, None] * G + _mm(
            [x.transpose(-1, -2) for x in _split(A, split)], z["Q"])
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        z = per[c]
        X = z["X"]
        gi, gn = z["gi"][..., None], z["gn"][..., None]
        dq[:, :, sl] = _sum_mm(z["dH"], _split(X[..., :d, :], split)) * gi \
            + gn * X[..., d:, :] + _mm(_split(z["dS"], split), z["K"])
        dk[:, :, sl] = _grad_k(z, ends[c], split)
    qf, kf = (F.pad(x.float(), (0, 0, 0, nc * L - t)) for x in (q, k))
    qd = (qf * dq).sum(-1)[..., :t]
    kd = (kf * dk).sum(-1)[..., :t]
    dlf = torch.flip(torch.cumsum(torch.flip(qd - kd, [-1]), -1), [-1])
    df = dlf * torch.sigmoid(-f_pre.float())
    return (dq[:, :, :t].to(q.dtype), dk[:, :, :t].to(k.dtype),
            dv[:, :, :t].to(v.dtype), kd, df)


def _bwd_chunks(q, k, v, i_pre, f_pre, dh, L: int, split: bool
                ) -> list[dict]:
    """Per chunk what the prep kernel forms (and the operands the other
    kernels read), for the forward :func:`chunkwise_model` runs with
    ``split``: Q, K, V, dh and X (the saved start state) in fp32, the
    weights w, g_end, gi, gn, and the L × L matrices Pi and dS."""
    b, h, t, d = q.shape
    scale = d ** -0.5
    nc = -(-t // L)
    _, _, kept = _chunkwise(q, k, v, i_pre, f_pre, L, split)
    qf, kf, vf, ig, lf = _padded(q, k, v, i_pre, f_pre, L)
    pad = nc * L - t
    dhf = F.pad(dh.float(), (0, 0, 0, pad))
    hf = F.pad(kept["hf"], (0, 0, 0, pad))
    den = F.pad(kept["den"], (0, 0, 0, pad), value=1.0)
    den[:, :, t:, 1] = 0.0
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    per = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        Q, K, V, i_c = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl], ig[..., sl]
        m_prev = kept["m0"][..., c]
        b_t, m_t = _gate_scan(lf, ig, m_prev, c, L)
        a, e = b_t - m_t, i_c - b_t
        gq = scale * torch.exp(b_t + m_prev[..., None] - m_t)
        b_end, m_end = b_t[..., -1], m_t[..., -1]
        dn, sg = den[:, :, sl, 0], den[:, :, sl, 1]
        dH = dhf[:, :, sl]
        r = (dH * hf[:, :, sl]).sum(-1)
        inv = 1.0 / dn
        dhn = -sg * r / dn
        D = torch.where(causal, scale * torch.exp(a[..., :, None]
                                                  + e[..., None, :]), 0.0)
        S = Q @ K.transpose(-1, -2)
        U = dH @ V.transpose(-1, -2)
        per.append(dict(Q=Q, K=K, V=V, dH=dH, X=kept["states"][:, :, c],
                        w=torch.exp(e + (b_end - m_end)[..., None]),
                        g_end=torch.exp(b_end + m_prev - m_end),
                        gi=gq * inv, gn=gq * dhn,
                        Pi=(S * D) * inv[..., None],
                        dS=(inv[..., None] * U + dhn[..., None]) * D))
    return per


def _grad_k(z: dict, G: torch.Tensor | None, split: bool) -> torch.Tensor:
    """A chunk's dK from its end-gradient G: ``w∘(V G[:Dh]) + w ⊗ G[Dh]
    + dSᵀ Q``; with ``G=None`` (the last chunk, where G is zero) the last
    term alone, as the gradient kernel runs it there."""
    out = _mm(_split(z["dS"].transpose(-1, -2), split), z["Q"])
    if G is None:
        return out
    d = G.shape[-1]
    w = z["w"][..., None]
    return _sum_mm(z["V"], _split(G[..., :d, :], split)) * w \
        + w * G[..., d:, :] + out


def _sum_mm(a: torch.Tensor, b_parts: list[torch.Tensor]) -> torch.Tensor:
    """Σ over the parts of a @ b in fp32 (a bf16-exact, b split)."""
    out = a @ b_parts[0]
    for p in b_parts[1:]:
        out = out + a @ p
    return out
