"""Recurrent temporal-mixing blocks of the port: mLSTM + sLSTM (xLSTM)
and the RG-LRU recurrent block (Griffin / RecurrentGemma).

The counterpart of the reference ``repro.models.recurrent``, with its
casts kept exactly.  Sequence paths run the scans (the mLSTM and RG-LRU
kernels for CUDA tensors, their plain versions for CPU tensors); the
sLSTM scan and every decode step are plain PyTorch, as they are plain JAX
in the reference: single-step updates on constant-size state, kept in
fp32 (mLSTM ``C``/``n``/``m``, sLSTM ``h``/``c``/``n``/``m``, RG-LRU
``h`` and the causal conv's last ``conv_width - 1`` inputs).  Decode
steps update the state in place, where the reference returns new arrays.

Serving pads prompts on the right up to a bucket; every block's
``length=`` takes the state at the prompt's real end.  The RG-LRU's
padded steps scan with ``a = 1`` and ``u = 0`` (exact in bf16) and its
conv state is the inputs that end at ``length - 1``; the mLSTM's padded
steps get gates ``i = -inf`` and ``f = +inf``, so ``i' = 0``, ``f' = 1``
and ``m`` is unchanged: the carry passes through exactly; the sLSTM keeps
the state of step ``length - 1``.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.distributed.act_sharding import placed
from repro_torch.kernels import ops
from repro_torch.roofline.op_cost import pad_steps, steps

from .layers import init_linear, init_norm, linear, norm

Params = dict[str, Any]

_LRU_C = 8.0
_GATES = ("z", "i", "f", "o")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _linear_f32(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``linear`` on fp32 ``x``: the weights promoted to fp32, as JAX
    promotes a bf16 weight against an fp32 input."""
    y = x @ p["w"].float()
    if "b" in p:
        y = y + p["b"].float()
    return y


# ===========================================================================
# mLSTM (xLSTM) block
# ===========================================================================

def init_mlstm_block(cfg, gen: torch.Generator, dtype: torch.dtype,
                     device: torch.device, lead: tuple[int, ...] = ()
                     ) -> Params:
    d = cfg.d_model
    e = cfg.xlstm_expand * d
    h = cfg.n_heads
    dh = e // h
    kw = dict(dtype=dtype, device=device, lead=lead)
    f32 = dict(dtype=torch.float32, device=device, lead=lead)

    # q/k/v are block-diagonal per head (xLSTM eq. 24's head-wise
    # projections): (H, dh, dh) instead of dense (e, e)
    def blockdiag():
        w = torch.randn((*lead, h, dh, dh), generator=gen, device=device,
                        dtype=torch.float32)
        return {"w": placed(w.mul_(dh ** -0.5).to(dtype))}

    return {
        "norm": init_norm(d, cfg.norm, dtype, device, lead),
        "up": init_linear(gen, d, 2 * e, bias=False, **kw),
        "wq": blockdiag(),
        "wk": blockdiag(),
        "wv": blockdiag(),
        "wi": init_linear(gen, e, h, bias=True, **f32),
        "wf": init_linear(gen, e, h, bias=True, **f32),
        "head_norm": init_norm(e, "rmsnorm", dtype, device, lead),
        "down": init_linear(gen, e, d, bias=False,
                            scale=e ** -0.5 / math.sqrt(2 * cfg.n_layers),
                            **kw),
    }


def _mlstm_qkvif(cfg, p: Params, xin: torch.Tensor):
    b, s, e = xin.shape
    h = cfg.n_heads
    xh = xin.reshape(b, s, h, e // h)
    q = torch.einsum("bshd,hde->bhse", xh, p["wq"]["w"])
    k = torch.einsum("bshd,hde->bhse", xh, p["wk"]["w"])
    v = torch.einsum("bshd,hde->bhse", xh, p["wv"]["w"])
    i_pre = linear(p["wi"], xin.float()).transpose(1, 2)
    f_pre = linear(p["wf"], xin.float()).transpose(1, 2) + 3.0
    return q, k, v, i_pre, f_pre


def _mlstm_out(cfg, p: Params, hcell: torch.Tensor, z: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """Head norm, the output gate ``silu(z)`` and the down projection of
    the cell output ``hcell`` (B, S, E)."""
    hcell = norm(p["head_norm"], hcell, "rmsnorm")
    out = hcell * F.silu(z.float()).to(x.dtype)
    return linear(p["down"], out)


def mlstm_block(cfg, p: Params, x: torch.Tensor, *,
                return_state: bool = False, length: int | None = None):
    """x: (B, S, D) -> (B, S, D); residual added by caller.  ``length``
    (≤ S) is the prompt's real length when the sequence is padded on the
    right: the padded steps' gates carry the state through unchanged, so
    the returned state is the one after ``length`` tokens.

    ``cfg.mlstm_chunk > 0`` (the reference's time-chunked rematerialised
    scan, which keeps only chunk-boundary states for the backward pass)
    runs the plain chunked scan for a CPU tensor, exactly as the reference
    does, and the kernel's Function for a CUDA tensor: that Function
    already saves only the states at its own chunks' starts (the
    schedule's chunk length, not ``mlstm_chunk``).  With ``return_state``
    the scan is unchunked, as in the reference."""
    xn = norm(p["norm"], x, cfg.norm)
    up = linear(p["up"], xn)
    xin, z = up.chunk(2, dim=-1)                        # (B, S, E) each
    q, k, v, i_pre, f_pre = _mlstm_qkvif(cfg, p, xin)
    b, s = x.shape[0], x.shape[1]
    if length is not None and length < s:
        pad = torch.arange(s, device=x.device) >= length
        i_pre = i_pre.masked_fill(pad, float("-inf"))
        f_pre = f_pre.masked_fill(pad, float("inf"))
    state = None
    if return_state:
        hcell, state = ops.mlstm(q, k, v, i_pre, f_pre, return_state=True)
    else:
        hcell = ops.mlstm(q, k, v, i_pre, f_pre, chunk=cfg.mlstm_chunk)
    hcell = hcell.transpose(1, 2).reshape(b, s, -1)
    y = _mlstm_out(cfg, p, hcell, z, x)
    return (y, state) if return_state else y


def init_mlstm_state(cfg, batch: int, device: torch.device,
                     lead: tuple[int, ...] = ()) -> Params:
    e = cfg.xlstm_expand * cfg.d_model
    h = cfg.n_heads
    dh = e // h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((*lead, batch, h, dh, dh), **f32),
        "n": torch.zeros((*lead, batch, h, dh), **f32),
        "m": torch.zeros((*lead, batch, h), **f32),
    }


def mlstm_block_decode(cfg, p: Params, x: torch.Tensor, state: Params
                       ) -> tuple[torch.Tensor, Params]:
    """One-token step (x (B, 1, D)) on constant-size state, updated in
    place; the returned state is the same tensors."""
    xn = norm(p["norm"], x, cfg.norm)
    up = linear(p["up"], xn)
    xin, z = up.chunk(2, dim=-1)
    q, k, v, i_pre, f_pre = _mlstm_qkvif(cfg, p, xin)
    qt = q[:, :, 0].float()                             # (B, H, Dh)
    kt = k[:, :, 0].float()
    vt = v[:, :, 0].float()
    it = i_pre[:, :, 0]
    ft = f_pre[:, :, 0]
    scale = qt.shape[-1] ** -0.5

    m = state["m"]
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_ = torch.exp(it - m_new)[..., None]
    f_ = torch.exp(logf + m - m_new)[..., None]
    C = state["C"].mul_(f_[..., None]).add_(
        i_[..., None] * (vt[..., :, None] * kt[..., None, :]))
    nvec = state["n"].mul_(f_).add_(i_ * kt)
    m.copy_(m_new)
    qs = qt * scale
    num = (C * qs[..., None, :]).sum(-1)
    den = torch.maximum((nvec * qs).sum(-1).abs(), torch.exp(-m_new))
    hcell = (num / den[..., None]).reshape(x.shape[0], 1, -1).to(x.dtype)
    return _mlstm_out(cfg, p, hcell, z, x), state


# ===========================================================================
# sLSTM block (scalar memory, per-head recurrent weights)
# ===========================================================================

def init_slstm_block(cfg, gen: torch.Generator, dtype: torch.dtype,
                     device: torch.device, lead: tuple[int, ...] = ()
                     ) -> Params:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    kw = dict(dtype=dtype, device=device, lead=lead)
    p: Params = {"norm": init_norm(d, cfg.norm, dtype, device, lead)}
    for g in _GATES:
        p[f"w{g}"] = init_linear(gen, d, d, bias=True, **kw)
        # block-diagonal recurrent weights: (H, dh, dh), kept in fp32
        p[f"r{g}"] = placed(torch.randn((*lead, h, dh, dh), generator=gen,
                                        device=device, dtype=torch.float32
                                        ).mul_(dh ** -0.5))
    p["down"] = init_linear(gen, d, d, bias=False,
                            scale=d ** -0.5 / math.sqrt(2 * cfg.n_layers),
                            **kw)
    return p


def init_slstm_state(cfg, batch: int, device: torch.device,
                     lead: tuple[int, ...] = ()) -> Params:
    return {g: torch.zeros((*lead, batch, cfg.d_model), dtype=torch.float32,
                           device=device) for g in ("h", "c", "n", "m")}


def _slstm_step(cfg, p: Params, state: Params, xt: Params) -> Params:
    """One sLSTM step; ``xt`` the gates' input pre-activations (B, D)
    (already W x + b).  Returns new fp32 state tensors."""
    h_prev = state["h"]
    b, d = h_prev.shape
    hh = h_prev.reshape(b, cfg.n_heads, -1)

    def rec(g):
        return torch.einsum("bhi,hij->bhj", hh, p[f"r{g}"]).reshape(b, d)

    zt = torch.tanh(xt["z"] + rec("z"))
    it = xt["i"] + rec("i")
    ft = xt["f"] + rec("f")
    ot = torch.sigmoid(xt["o"] + rec("o"))

    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + state["m"], it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(logf + state["m"] - m_new)
    c = f_ * state["c"] + i_ * zt
    n = f_ * state["n"] + i_
    h = ot * c / torch.clamp(n, min=1.0)
    return {"h": h, "c": c, "n": n, "m": m_new}


def slstm_block(cfg, p: Params, x: torch.Tensor, *,
                return_state: bool = False, length: int | None = None):
    """Full-sequence sLSTM block (a Python loop over time).  With
    ``length`` (≤ S) the returned state is the one after ``length``
    tokens; the steps past it are the bucket's padding."""
    xn = norm(p["norm"], x, cfg.norm).float()
    pre = {g: _linear_f32(p[f"w{g}"], xn) for g in _GATES}
    b, s, _ = x.shape
    length = s if length is None else length
    state = init_slstm_state(cfg, b, x.device)
    kept = state if length == 0 else None
    hs = []
    for t in steps(s):
        state = _slstm_step(cfg, p, state, {g: v[:, t] for g, v in
                                            pre.items()})
        hs.append(state["h"])
        if t == length - 1:
            kept = state
    if kept is None:            # a loop priced by trips ran 3 steps
        kept = state
    pad_steps(hs, s)
    out = torch.stack(hs, dim=1).to(x.dtype)
    y = linear(p["down"], out)
    return (y, kept) if return_state else y


def slstm_block_decode(cfg, p: Params, x: torch.Tensor, state: Params
                       ) -> tuple[torch.Tensor, Params]:
    """One-token step; the state is updated in place."""
    xn = norm(p["norm"], x, cfg.norm).float()[:, 0]
    pre = {g: _linear_f32(p[f"w{g}"], xn) for g in _GATES}
    new = _slstm_step(cfg, p, state, pre)
    for g, t in new.items():
        state[g].copy_(t)
    out = linear(p["down"], state["h"][:, None].to(x.dtype))
    return out, state


# ===========================================================================
# RG-LRU recurrent block (Griffin / RecurrentGemma)
# ===========================================================================

def init_rec_block(cfg, gen: torch.Generator, dtype: torch.dtype,
                   device: torch.device, lead: tuple[int, ...] = ()
                   ) -> Params:
    d = cfg.d_model
    w = cfg.lru_width or d
    kw = dict(dtype=dtype, device=device, lead=lead)
    # Λ so that a = exp(-c·softplus(Λ)·r) lands in (0.9, 0.999) at r≈0.5
    lam = torch.log(torch.expm1(
        -torch.log(torch.linspace(0.9, 0.999, w, dtype=torch.float32,
                                  device=device)) * 2.0 / _LRU_C))
    conv = torch.randn((*lead, cfg.conv_width, w), generator=gen,
                       device=device, dtype=torch.float32)
    return {
        "norm": init_norm(d, cfg.norm, dtype, device, lead),
        "wx": init_linear(gen, d, w, bias=False, **kw),
        "wy": init_linear(gen, d, w, bias=False, **kw),
        "conv": placed(conv.mul_(cfg.conv_width ** -0.5).to(dtype)),
        "conv_b": placed(torch.zeros((*lead, w), dtype=dtype,
                                     device=device)),
        "wr": init_linear(gen, w, w, bias=True, **kw),
        "wi": init_linear(gen, w, w, bias=True, **kw),
        "lam": placed(lam.expand(*lead, w).clone()),
        "out": init_linear(gen, w, d, bias=False,
                           scale=w ** -0.5 / math.sqrt(2 * cfg.n_layers),
                           **kw),
    }


def _causal_conv(xt: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv along time.  xt (B, T, W); w (K, W); ``prev``
    the K-1 inputs before ``xt`` (zeros when None)."""
    kw, t = w.shape[0], xt.shape[1]
    if prev is None:
        pad = torch.zeros((xt.shape[0], kw - 1, xt.shape[2]),
                          dtype=xt.dtype, device=xt.device)
    else:
        pad = prev.to(xt.dtype)
    xp = torch.cat([pad, xt], dim=1)
    out = sum(xp[:, i:i + t] * w[i][None, None] for i in range(kw))
    return out + b[None, None]


def _lru_gates(p: Params, xc: torch.Tensor):
    r = torch.sigmoid(linear(p["wr"], xc).float())
    i = torch.sigmoid(linear(p["wi"], xc).float())
    a = torch.exp(-_LRU_C * _softplus(p["lam"])[None, None] * r)
    # input normalization: sqrt(1 - a^2), from the Griffin paper
    u = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * xc.float()
    return a, u


def rec_block(cfg, p: Params, x: torch.Tensor, *,
              return_state: bool = False, length: int | None = None):
    """Full-sequence recurrent block.  ``length`` (≤ T) is the prompt's
    real length when the sequence is padded on the right: the returned
    state is taken there (the padded steps carry ``h`` unchanged)."""
    xn = norm(p["norm"], x, cfg.norm)
    xb = linear(p["wx"], xn)                                   # (B, T, W)
    xc = _causal_conv(xb, p["conv"], p["conv_b"])
    a, u = _lru_gates(p, xc)
    a, u = a.to(x.dtype), u.to(x.dtype)
    t = x.shape[1]
    length = t if length is None else length
    if length < t:
        pad = torch.arange(t, device=x.device)[None, :, None] >= length
        a = a.masked_fill(pad, 1.0)
        u = u.masked_fill(pad, 0.0)
    h, h_t = ops.rg_lru(u, a)
    gate = _gelu(linear(p["wy"], xn).float())
    y = linear(p["out"], (h.float() * gate).to(x.dtype))
    if not return_state:
        return y
    k = cfg.conv_width - 1
    conv = xb[:, max(0, length - k):length].float()
    if conv.shape[1] < k:
        conv = F.pad(conv, (0, 0, k - conv.shape[1], 0))
    return y, {"h": h_t, "conv": conv}


def init_rec_state(cfg, batch: int, device: torch.device,
                   lead: tuple[int, ...] = ()) -> Params:
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((*lead, batch, w), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((*lead, batch, cfg.conv_width - 1, w),
                            dtype=torch.float32, device=device),
    }


def rec_block_decode(cfg, p: Params, x: torch.Tensor, state: Params
                     ) -> tuple[torch.Tensor, Params]:
    """One-token step (x (B, 1, D)).  The state is updated in place, where
    the reference returns new arrays; the returned state is the same
    tensors."""
    xn = norm(p["norm"], x, cfg.norm)
    xb = linear(p["wx"], xn)                                   # (B, 1, W)
    xc = _causal_conv(xb, p["conv"], p["conv_b"], prev=state["conv"])
    a, u = _lru_gates(p, xc)
    h = a[:, 0] * state["h"] + u[:, 0]
    conv_new = torch.cat([state["conv"][:, 1:], xb.float()], dim=1)
    gate = _gelu(linear(p["wy"], xn).float())
    out = (h[:, None] * gate).to(x.dtype)
    state["h"].copy_(h)
    state["conv"].copy_(conv_new)
    return linear(p["out"], out), state
