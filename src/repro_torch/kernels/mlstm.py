"""The stabilised mLSTM scan (xLSTM) as a hand-written Hopper kernel.

Source note.  Replaces the TPU kernel ``repro/kernels/mlstm.py:
mlstm_scan``: per (batch, head), from ``C = 0, n = 0, m = 0``, the
matrix memory ``C`` (Dh × Dh), normaliser ``n`` and log-space stabiliser
``m`` carried in fp32, ``q̃ = q·Dh^-0.5``, every ``h_t`` rounded once to
bf16.  With ``return_state`` it also returns the final ``C``, ``n`` and
``m`` in fp32 (what ``repro.kernels.ref.mlstm_scan(..., return_state=
True)`` computes): every mLSTM layer's prefill in serving runs it so, and
the stateless ``forward`` runs it without.

The kernel (``csrc/mlstm.cu``) computes the scan chunkwise on the tensor
cores.  Inside a chunk of L steps anchored at t = 0, with b_t the
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
:func:`schedule` picks the chunk length, the ring's depth and both
grids from the shape alone.  The plain version is
:func:`repro_torch.kernels.ref.mlstm_scan`.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from . import _build, ref

# kernel launches since the last reset (``chip_smoke.py`` reads it); one
# a call, which runs two device kernels
launches = 0

MAX_HEAD_DIM = 1024
SMEM_LIMIT = 232_448              # dynamic shared memory a block may use
CHUNKS = (64, 128)                # chunk lengths the kernel takes
DV = 32                           # columns of one head's C a block owns
OWNERS = 4                        # warpgroups that hold the state
MAX_STAGES = 8                    # Q/K ring stages the kernel can hold
QK_STAGES = 4                     # the Q Kᵀ kernel's ring
MAX_BH = 65535                    # (batch, head) pairs: grid dimension y


def dk_tiles(head_dim: int) -> int:
    """64-row tiles of Cᵀ's Dh rows, padded to a multiple of the four
    owner warpgroups (the rows past Dh stay zero)."""
    return OWNERS * -(-head_dim // (64 * OWNERS))


def _slot_bytes(chunk: int) -> int:
    # a Q and a K tile (chunk rows x 64 columns, bf16) and the state's
    # hi / lo pair for one 64-row tile of Cᵀ (40 rows: 32 columns of C,
    # n, and 7 zero rows, x 64, bf16)
    return 2 * chunk * 128 + 2 * 40 * 128


def chunk_buffers(chunk: int) -> int:
    """Chunk buffers: two at L = 64 (the gate scan runs a chunk ahead),
    one at L = 128 (so that the ring keeps :data:`OWNERS` stages)."""
    return 2 if chunk == 64 else 1


def _chunk_bytes(chunk: int) -> int:
    # one chunk buffer: w∘V's hi and lo (32 x chunk bf16), V with its ones
    # row (40 x chunk) and w's hi / lo pair (8 x chunk), 1 KB-aligned; the
    # chunk's weights (5 chunk + 2 fp32, padded to 16 bytes); its staged
    # i, f (fp32) and 32 columns of V (bf16)
    boxes = chunk // 64
    return (2 * boxes * 32 * 128 + boxes * 40 * 128 + boxes * 1024
            + (5 * chunk + 4) * 4 + 2 * chunk * 4 + chunk * 64)


def smem_bytes_for(chunk: int, stages: int) -> int:
    """Dynamic shared memory of one scan block (csrc/mlstm.cu:
    Cfg::smem_bytes must agree): 1 KB of alignment slack, the ring, the
    chunk buffers and 256 B of mbarriers."""
    return (1024 + stages * _slot_bytes(chunk)
            + chunk_buffers(chunk) * _chunk_bytes(chunk) + 256)


def stages_for(chunk: int) -> int:
    """The ring's depth: as many stages as fit, at most MAX_STAGES (7 at
    L = 64, 4 at L = 128).  The kernel takes no fewer than :data:`OWNERS`.
    Each owner warpgroup waits on a slot's full barrier by phase parity,
    and before its tile nt it knows only that its own tile nt − 4 has
    landed.  With fewer stages than owners the slot's previous tile,
    nt − stages > nt − 4, may not have landed: the barrier is one phase
    behind, shows the parity waited for, and the owner reads a slot that
    TMA is still filling (at two and three stages this faulted on the
    card)."""
    n = MAX_STAGES
    while smem_bytes_for(chunk, n) > SMEM_LIMIT:
        n -= 1
    assert n >= OWNERS, (chunk, n)
    return n


def qk_smem_bytes(chunk: int) -> int:
    """Dynamic shared memory of one ``Q Kᵀ`` block: 1 KB of slack,
    QK_STAGES of a 64-row Q tile and a chunk-row K tile, 256 B of
    mbarriers."""
    return 1024 + QK_STAGES * (64 * 128 + chunk * 128) + 256


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


def schedule(b: int, h: int, t: int, dh: int,
             chunk: int | None = None) -> Schedule:
    """The launch for (B, H, T, Dh): chunks of 64 steps unless ``chunk``
    names another length of :data:`CHUNKS`.  Refuses a head dim that is
    not a multiple of 32 up to 1024, more than 65535 (batch, head) pairs,
    and T < 1."""
    if dh % 32 or not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"mlstm_scan kernel takes a head dim that is a "
                         f"multiple of 32 up to {MAX_HEAD_DIM}, got {dh}")
    if not 0 < b * h <= MAX_BH:
        raise ValueError(f"mlstm_scan kernel takes 1 to {MAX_BH} (batch, "
                         f"head) pairs, got {b * h}")
    if t < 1:
        raise ValueError(f"mlstm_scan kernel takes T >= 1, got {t}")
    chunk = CHUNKS[0] if chunk is None else chunk
    if chunk not in CHUNKS:
        raise ValueError(f"mlstm_scan kernel takes a chunk of {CHUNKS}, "
                         f"got {chunk}")
    n_chunks = -(-t // chunk)
    stages = stages_for(chunk)
    return Schedule(
        chunk=chunk, n_chunks=n_chunks, dk_tiles=dk_tiles(dh), stages=stages,
        grid=(dh // DV, b * h), qk_grid=chunk // 64 * n_chunks * b * h,
        smem_bytes=smem_bytes_for(chunk, stages),
        qk_smem_bytes=qk_smem_bytes(chunk),
        scratch_bytes=4 * b * h * n_chunks * chunk * chunk)


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


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_pre: torch.Tensor, f_pre: torch.Tensor, *,
               return_state: bool = False):
    """q, k, v (B, H, T, Dh); i_pre, f_pre (B, H, T) → h (B, H, T, Dh) in
    ``q.dtype``, and with ``return_state`` also ``{"C": (B, H, Dh, Dh),
    "n": (B, H, Dh), "m": (B, H)}`` in fp32.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel or raises.  The kernel takes contiguous bf16 q, k, v, fp32
    gates and a head dim that is a multiple of 32 up to 1024."""
    ts = (q, k, v, i_pre, f_pre)
    if all(t.device.type == "cpu" for t in ts):
        return ref.mlstm_scan(q, k, v, i_pre, f_pre,
                              return_state=return_state)
    _build.no_backward("mlstm_scan", *ts)
    _check(q, k, v, i_pre, f_pre)
    b, h, t, dh = q.shape
    if t == 0 or b * h == 0:
        out = torch.empty_like(q)
        if not return_state:
            return out
        return out, {"C": q.new_zeros((b, h, dh, dh), dtype=torch.float32),
                     "n": q.new_zeros((b, h, dh), dtype=torch.float32),
                     "m": q.new_zeros((b, h), dtype=torch.float32)}
    return _launch(q, k, v, i_pre, f_pre, schedule(b, h, t, dh),
                   return_state, None, None, None)


def run_schedule(q, k, v, i_pre, f_pre, sched: Schedule, *,
                 return_state: bool = False, out=None, state=None,
                 scratch=None):
    """Launch the kernel on ``sched`` (CUDA tensors, checked as
    :func:`mlstm_scan` checks them; ``sched`` must be the shape's schedule
    at its chunk length).  ``out``, ``state`` (a dict of C, n, m) and
    ``scratch`` (``sched.scratch_bytes`` of fp32) may be handed in, as the
    card tests do to fill them with NaN first; otherwise they are
    allocated here."""
    _check(q, k, v, i_pre, f_pre)
    b, h, t, dh = q.shape
    if sched != schedule(b, h, t, dh, sched.chunk):
        raise ValueError(f"mlstm_scan: schedule {sched} is not the one for "
                         f"{tuple(q.shape)}")
    if scratch is not None and \
            scratch.numel() * scratch.element_size() < sched.scratch_bytes:
        raise ValueError(f"mlstm_scan: scratch of "
                         f"{scratch.numel() * scratch.element_size()} B, "
                         f"the schedule needs {sched.scratch_bytes}")
    return _launch(q, k, v, i_pre, f_pre, sched, return_state, out, state,
                   scratch)


def _launch(q, k, v, i_pre, f_pre, sched: Schedule, return_state: bool,
            out, state, scratch):
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
            scratch.data_ptr(), b * h, t, dh, sched.chunk, sched.stages,
            stream)
    _build.check(rc, "mlstm_scan")
    launches += 1
    return (out, state) if return_state else out


# ---------------------------------------------------------------------------
# the kernel's arithmetic, in plain PyTorch (tests only)
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


def chunkwise_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_pre: torch.Tensor, f_pre: torch.Tensor, *,
                    chunk: int, split: bool = True,
                    return_state: bool = False):
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
    product).  Returns what :func:`mlstm_scan` returns.  For the tests
    only: nothing on the served path calls it."""
    b, h, t, dh = q.shape
    scale = dh ** -0.5
    L = chunk
    nc = -(-t // L)
    pad = nc * L - t
    qf, kf, vf = (F.pad(x.float(), (0, 0, 0, pad)) for x in (q, k, v))
    ig = F.pad(i_pre.float(), (0, pad), value=-math.inf)
    lf = F.logsigmoid(F.pad(f_pre.float(), (0, pad), value=math.inf))
    C = q.new_zeros((b, h, dh, dh), dtype=torch.float32)   # C[dv, dk]
    n = q.new_zeros((b, h, dh), dtype=torch.float32)
    m = q.new_zeros((b, h), dtype=torch.float32)
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    out = q.new_empty((b, h, nc * L, dh), dtype=torch.float32)
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        Q, K, V, i_c = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl], ig[..., sl]
        m_prev, mm = m, m
        bb = torch.zeros_like(m)
        ms, bs = [], []
        for u in range(L):
            bb = bb + lf[..., c * L + u]
            mm = torch.maximum(lf[..., c * L + u] + mm, i_c[..., u])
            ms.append(mm)
            bs.append(bb)
        m_t, b_t = torch.stack(ms, -1), torch.stack(bs, -1)
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
        parts = _split(ext, split)
        inter = Q @ parts[0].transpose(-1, -2)
        for part in parts[1:]:
            inter = inter + Q @ part.transpose(-1, -2)
        vx = torch.cat([V, torch.ones_like(V[..., :1])], -1)
        hx = gq[..., None] * inter + _mm(P, vx)
        den = torch.maximum(hx[..., dh].abs(), floor)
        out[:, :, sl] = hx[..., :dh] / den[..., None]

        wv = _split(w[..., None] * V, split)
        C = g_end[..., None, None] * C + _mm(
            [x.transpose(-1, -2) for x in wv], K)
        n = g_end[..., None] * n + _mm(
            [x[..., None, :] for x in _split(w, split)], K)[..., 0, :]
        m = m_end
    h_out = out[:, :, :t].to(q.dtype)
    if return_state:
        return h_out, {"C": C, "n": n, "m": m}
    return h_out
