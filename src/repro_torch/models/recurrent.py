"""The RG-LRU recurrent block (Griffin / RecurrentGemma) of the port.

The counterpart of the RG-LRU half of the reference
``repro.models.recurrent``, with its casts kept exactly: prefill runs the
scan (the RG-LRU kernel for CUDA tensors) on ``u`` and ``a`` cast to the
input dtype; decode is a single fp32 step on constant-size state (``h``
and the causal conv's last ``conv_width - 1`` inputs, both kept in fp32).
The mLSTM and sLSTM blocks of ``xlstm-1.3b`` are not ported yet.

Serving pads prompts on the right up to a bucket; ``rec_block(...,
length=)`` takes the state at the prompt's real end: the padded steps
scan with ``a = 1`` and ``u = 0`` (exact in bf16), so they carry ``h``
through unchanged, and the conv state is the inputs that end at
``length - 1``.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .layers import init_linear, init_norm, linear, norm

Params = dict[str, Any]

_LRU_C = 8.0


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros_like(x))


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
        "conv": conv.mul_(cfg.conv_width ** -0.5).to(dtype),
        "conv_b": torch.zeros((*lead, w), dtype=dtype, device=device),
        "wr": init_linear(gen, w, w, bias=True, **kw),
        "wi": init_linear(gen, w, w, bias=True, **kw),
        "lam": lam.expand(*lead, w).clone(),
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
