"""Plain PyTorch versions of the port's kernels.

Each function is the ground truth its CUDA kernel is held against
(``chip_smoke.py`` on the card, ``tests/test_torch_kernels.py`` against
``repro.kernels.ref`` on the CPU), and what a kernel wrapper runs when the
tensor it was given lies on the CPU.  ``mlp`` materializes the hidden
tensor exactly like the paper's unfused schedule.  Products accumulate in
fp32 (inputs upcast; a bf16 x bf16 product is exact in fp32), matching
``preferred_element_type=float32`` in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.roofline.op_cost import pad_steps as _pad
from repro_torch.roofline.op_cost import steps

_ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,
    "silu": F.silu,
    "relu": F.relu,
    "identity": lambda x: x,
}

# activation codes of the CUDA kernels (csrc/common.cuh: rt::act)
ACT_CODES = {"gelu": 0, "gelu_exact": 1, "silu": 2, "relu": 3,
             "identity": 4}


def act_fn(name: str):
    return _ACTS[name]


# ---------------------------------------------------------------------------
# GEMM family
# ---------------------------------------------------------------------------

def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def gemm_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
             *, act: str = "gelu") -> torch.Tensor:
    """The paper's benchmark op: ``act(x @ w + b)``."""
    h = torch.matmul(x.float(), w.float())
    if b is not None:
        h = h + b.float()
    return act_fn(act)(h).to(x.dtype)


def mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
        wg: torch.Tensor | None = None, b1: torch.Tensor | None = None,
        b2: torch.Tensor | None = None, *, act: str = "gelu") -> torch.Tensor:
    """Layer-per-layer MLP (materializes the hidden tensor)."""
    xf = x.float()
    h = torch.matmul(xf, w1.float())
    if b1 is not None:
        h = h + b1.float()
    h = act_fn(act)(h)
    if wg is not None:
        h = h * torch.matmul(xf, wg.float())
    y = torch.matmul(h.to(x.dtype).float(), w2.float())
    if b2 is not None:
        y = y + b2.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA + causal + local window)
# ---------------------------------------------------------------------------

def _scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
            window: int | None, q_offset: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scaled scores (B, Hk, group, Tq, Tk) in fp32 and the (Tq, Tk)
    mask of the keys each query sees."""
    b, hq, tq, dh = q.shape
    hk, tk = k.shape[1], k.shape[2]
    if hq % hk:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hk}")
    qg = q.reshape(b, hk, hq // hk, tq, dh).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * dh ** -0.5
    qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return s, mask


def _attend(s: torch.Tensor, mask: torch.Tensor, q: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return o.reshape(q.shape).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, Tq, Dh), k/v (B, Hk, Tk, Dh) → (B, Hq, Tq, Dh).

    A row with every key masked (a local window) gives zeros, not NaN."""
    s, mask = _scores(q, k, causal=causal, window=window, q_offset=q_offset)
    return _attend(s, mask, q, v)


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0, block_k: int = 1024
                        ) -> torch.Tensor:
    """:func:`attention` by an online softmax over key blocks of
    ``block_k`` (one block where ``block_k`` does not divide Tk): the
    (Tq, Tk) scores exist only as (Tq, block_k) tiles, the schedule the
    flash kernel runs, in plain PyTorch ops that autograd differentiates
    (the reference's ``repro.kernels.ref.attention_blockwise``, a
    ``lax.scan``).  fp32 accumulation; a row that sees no key gives
    zeros."""
    b, hq, tq, dh = q.shape
    hk, tk = k.shape[1], k.shape[2]
    group = hq // hk
    if tk % block_k:
        block_k = tk
    qg = q.reshape(b, hk, group, tq, dh).float()
    scale = dh ** -0.5
    qpos = torch.arange(tq, device=q.device) + q_offset
    acc = torch.zeros((b, hk, group, tq, dh), dtype=torch.float32,
                      device=q.device)
    m_run = torch.full((b, hk, group, tq), -1e30, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, hk, group, tq), dtype=torch.float32,
                        device=q.device)
    for j in range(tk // block_k):
        kj = k[:, :, j * block_k:(j + 1) * block_k]
        vj = v[:, :, j * block_k:(j + 1) * block_k]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kj.float()) * scale
        kpos = j * block_k + torch.arange(block_k, device=q.device)
        mask = torch.ones((tq, block_k), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m_run, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + p.sum(-1)
        pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(),
                          vj.float())
        acc = acc * alpha[..., None] + pv
        m_run = m_new
    out = acc / torch.where(l_run == 0.0, 1.0, l_run)[..., None]
    return out.reshape(b, hq, tq, dh).to(q.dtype)


def attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention` and the fp32 logsumexp of each row's scaled,
    masked scores (B, Hq, Tq), which the backward pass reads.  A row that
    sees no key has lse = +inf, so that exp(s - lse) is 0 on it."""
    s, mask = _scores(q, k, causal=causal, window=window, q_offset=q_offset)
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    lse = lse.masked_fill(torch.isneginf(lse), float("inf"))
    return _attend(s, mask, q, v), lse.reshape(q.shape[:3])


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  q_offset: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention` for the output gradient ``do``,
    from the softmax-gradient equations in fp32 (P recomputed from
    ``lse``, masked entries 0)::

        P = exp(S - lse),  dV = Pᵀ dO,  dP = dO Vᵀ,
        D = rowsum(dO ∘ O),  dS = P ∘ (dP - D),
        dQ = dS K · Dh^-0.5,  dK = dSᵀ Q · Dh^-0.5

    summed over the q heads of each kv head (GQA); each in its input's
    dtype.  A row that sees no key gives zero gradients."""
    b, hq, tq, dh = q.shape
    hk = k.shape[1]
    s, mask = _scores(q, k, causal=causal, window=window, q_offset=q_offset)
    shape = (b, hk, hq // hk, tq)
    p = torch.where(mask, torch.exp(s - lse.float().reshape(shape)[..., None]),
                    torch.zeros((), device=s.device))
    dog = do.reshape(*shape, dh).float()
    qg = q.reshape(*shape, dh).float()
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v.float())
    dsum = (dog * o.reshape(*shape, dh).float()).sum(-1)
    ds = p * (dp - dsum[..., None])
    scale = dh ** -0.5
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma) — gated linear recurrence
# ---------------------------------------------------------------------------

def rg_lru_scan(x: torch.Tensor, a: torch.Tensor,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t * h_{t-1} + x_t`` over time, per channel.

    x, a (B, T, W); h0 (B, W) or None for zeros.  The carry is fp32; returns
    (all h in ``x.dtype``, final h in fp32)."""
    b, t, w = x.shape
    h = (torch.zeros((b, w), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    xf, af = x.float(), a.float()
    hs = torch.empty((b, t, w), dtype=torch.float32, device=x.device)
    for i in steps(t):
        h = af[:, i] * h + xf[:, i]
        hs[:, i] = h
    return hs.to(x.dtype), h


def rg_lru_bwd(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None,
               dh: torch.Tensor | None, dh_t: torch.Tensor | None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, da, dh0) of :func:`rg_lru_scan` for the cotangents ``dh`` of
    all h (B, T, W) and ``dh_t`` of the final h (B, W); None means zeros.
    The reverse recurrence in fp32, from the end::

        g_T = dh_T + dh_t,   g_t = dh_t + a_{t+1} g_{t+1},
        dx_t = g_t,   da_t = g_t h_{t-1},   dh0 = a_1 g_1

    with h_{t-1} the fp32 carry (h0 at t = 1), recomputed here, as the
    reference's ``lax.scan`` keeps it.  dx and da come back in their
    inputs' dtypes, dh0 in fp32."""
    b, t, w = x.shape
    dev = x.device
    xf, af = x.float(), a.float()
    hp = torch.empty((b, t, w), dtype=torch.float32, device=dev)
    h = (torch.zeros((b, w), dtype=torch.float32, device=dev)
         if h0 is None else h0.float())
    for i in steps(t):
        hp[:, i] = h
        h = af[:, i] * h + xf[:, i]
    dhf = (torch.zeros((b, t, w), dtype=torch.float32, device=dev)
           if dh is None else dh.float())
    g = (torch.zeros((b, w), dtype=torch.float32, device=dev)
         if dh_t is None else dh_t.float())
    dx = torch.empty((b, t, w), dtype=torch.float32, device=dev)
    da = torch.empty_like(dx)
    for j in steps(t):
        i = t - 1 - j
        g = g + dhf[:, i]
        dx[:, i] = g
        da[:, i] = g * hp[:, i]
        g = af[:, i] * g
    return dx.to(x.dtype), da.to(a.dtype), g


# ---------------------------------------------------------------------------
# mLSTM (xLSTM) — matrix-memory recurrence, stabilized
# ---------------------------------------------------------------------------

def _mlstm_steps(C, n, m, qf, kf, vf, ig, fg, scale: float, branch=None):
    """The stabilized recurrence over the steps of ``qf`` … ``fg`` (fp32,
    (B, H, t, Dh) and (B, H, t)) from the state ``C``, ``n``, ``m``:
    returns the new state and the fp32 h of each step (B, H, t, Dh).
    ``branch`` (B, H, t), where given, picks each step's side of the
    denominator's max instead of the comparison: ±1 takes ``±nᵀq̃`` (the
    sign of nᵀq̃ where |nᵀq̃| won), 0 the floor ``exp(-m)``.
    Every product is an elementwise fp32 product summed in fp32 (no
    matrix product, so no TF32)."""
    hs = []
    for s in steps(qf.shape[2]):
        it, kt, vt = ig[..., s], kf[:, :, s], vf[:, :, s]
        logf = F.logsigmoid(fg[..., s])
        m_new = torch.maximum(logf + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(logf + m - m_new)
        C = f_[..., None, None] * C + i_[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])
        n = f_[..., None] * n + i_[..., None] * kt
        qs = qf[:, :, s] * scale
        num = (C * qs[..., None, :]).sum(-1)
        nq, floor = (n * qs).sum(-1), torch.exp(-m_new)
        if branch is None:
            den = torch.maximum(nq.abs(), floor)
        else:
            den = torch.where(branch[..., s] != 0, branch[..., s] * nq, floor)
        hs.append(num / den[..., None])
        m = m_new
    _pad(hs, qf.shape[2])
    return C, n, m, torch.stack(hs, 2)


def _zero_state(q: torch.Tensor):
    b, h, _, dh = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.zeros((b, h, dh, dh), **f32),
            torch.zeros((b, h, dh), **f32), torch.zeros((b, h), **f32))


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_pre: torch.Tensor, f_pre: torch.Tensor, *,
               return_state: bool = False):
    """Stabilized mLSTM recurrence (xLSTM eqs. 19-27), per (batch, head)
    from ``C = 0, n = 0, m = 0``::

        C_t = f'_t C_{t-1} + i'_t v_t k_tᵀ ;  n_t = f'_t n_{t-1} + i'_t k_t
        h_t = C_t q̃_t / max(|n_tᵀ q̃_t|, exp(-m_t))

    with the log-space stabilizer ``m``.  q, k, v (B, H, T, Dh); i_pre,
    f_pre (B, H, T).  Returns h in ``q.dtype`` (rounded once) and, with
    ``return_state``, ``{"C", "n", "m"}`` in fp32.  A Python loop over
    time, batched over (B, H); every product is an elementwise fp32
    product summed in fp32 (no matrix product, so no TF32)."""
    if q.shape[2] == 0:
        C, n, m = _zero_state(q)
        out = torch.empty_like(q)
    else:
        C, n, m, hs = _mlstm_steps(
            *_zero_state(q), q.float(), k.float(), v.float(),
            i_pre.float(), f_pre.float(), q.shape[-1] ** -0.5)
        out = hs.to(q.dtype)
    if return_state:
        return out, {"C": C, "n": n, "m": m}
    return out


def _chunk_scan(q, k, v, i_pre, f_pre, chunk: int, branch=None):
    """The plain scan in chunks of ``chunk`` steps (the last may be
    shorter), each chunk's steps under ``torch.utils.checkpoint`` when
    autograd records them: the backward pass keeps only the state at the
    chunk boundaries and runs each chunk again.  (fp32 h, C, n, m).
    ``branch`` as :func:`_mlstm_steps`'s, over all T steps."""
    scale = q.shape[-1] ** -0.5
    C, n, m = _zero_state(q)
    qf, kf, vf = q.float(), k.float(), v.float()
    ig, fg = i_pre.float(), f_pre.float()
    remat = torch.is_grad_enabled()
    hs = []
    t = q.shape[2]
    # chunks of one length are steps of one shape (a priced loop)
    chunks = steps(t // chunk) if t % chunk == 0 else range(-(-t // chunk))
    for c in chunks:
        sl = slice(c * chunk, (c + 1) * chunk)
        args = (C, n, m, qf[:, :, sl], kf[:, :, sl], vf[:, :, sl],
                ig[..., sl], fg[..., sl], scale,
                None if branch is None else branch[..., sl])
        C, n, m, hc = (checkpoint(_mlstm_steps, *args, use_reentrant=False)
                       if remat else _mlstm_steps(*args))
        hs.append(hc)
    _pad(hs, -(-t // chunk))
    return torch.cat(hs, 2), C, n, m


def mlstm_scan_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       i_pre: torch.Tensor, f_pre: torch.Tensor, *,
                       chunk: int = 256, return_state: bool = False):
    """:func:`mlstm_scan` with time-chunked rematerialization (the
    reference's ``mlstm_scan_chunked``): ``chunk`` is halved until it
    divides T, and each chunk's steps run under a checkpoint, so that
    autograd keeps only the (Dh × Dh) state at chunk boundaries,
    O(T/chunk·Dh²) bytes instead of the plain scan's O(T·Dh²), and runs
    each chunk again in the backward pass.  The same values as
    :func:`mlstm_scan`, bit for bit."""
    t = q.shape[2]
    if t == 0:
        return mlstm_scan(q, k, v, i_pre, f_pre, return_state=return_state)
    while t % chunk:
        chunk //= 2
    hs, C, n, m = _chunk_scan(q, k, v, i_pre, f_pre, chunk)
    out = hs.to(q.dtype)
    if return_state:
        return out, {"C": C, "n": n, "m": m}
    return out


# chunk of the plain gradient's rematerialized scan (the kernel's L)
BWD_CHUNK = 64


def mlstm_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              i_pre: torch.Tensor, f_pre: torch.Tensor, dh: torch.Tensor,
              branch: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv, di, df) of :func:`mlstm_scan`'s h for the cotangent
    ``dh``: autograd through the plain recurrence, the reference's
    gradient (the TPU kernel has no backward of its own: ``jax.grad``
    differentiates the plain scan).  The scan runs again here in chunks
    of :data:`BWD_CHUNK` steps, each under a checkpoint, so that it keeps
    only the state at chunk boundaries.  dq, dk, dv in their inputs'
    dtypes, di and df in fp32.

    ``branch`` (B, H, T) takes the gradient on a given side of each
    step's denominator max (as :func:`_mlstm_steps`): the kernel's own
    sides, from its saved ``den[..., 1]``.  Where |nᵀq̃| and exp(-m) tie
    within rounding, the kernel's scan and the plain one may take
    different sides, whose gradients differ (h is not differentiable
    there); on the kernel's sides the two are the same function."""
    ins = [x.detach().requires_grad_() for x in (q, k, v, i_pre, f_pre)]
    with torch.enable_grad():
        hs = _chunk_scan(*ins, BWD_CHUNK, branch)[0].to(q.dtype)
        grads = torch.autograd.grad(hs, ins, dh, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(ins, grads))
