"""Shared layers of the port: norms, RoPE, GQA attention (prefill and
cached decode, full or local window) and the MLP with FTL as an execution
mode.

Parameters are plain nested dicts of tensors, and every layer is a plain
function ``f(cfg, params, x, ...)``, as in the reference
``repro.models.layers``.  Initializers take an explicit
``torch.Generator`` and device, and draw from the same distributions at
the same scales as the reference.  An ``init_*`` given ``lead=(n,)``
returns parameters stacked along a leading layer axis.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.ftl import registry
from repro_torch.kernels import ops

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool,
                dtype: torch.dtype, device: torch.device,
                scale: float | None = None, lead: tuple[int, ...] = ()
                ) -> Params:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32)
    p = {"w": w.mul_(scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_norm(d: int, kind: str, dtype: torch.dtype, device: torch.device,
              lead: tuple[int, ...] = ()) -> Params:
    p = {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((*lead, d), dtype=dtype, device=device)
    return p


def norm(p: Params, x: torch.Tensor, kind: str, eps: float = 1e-6
         ) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (S,) or (B, S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    pos = positions.to(device=x.device, dtype=torch.float32)
    ang = (pos[None, :, None] if pos.dim() == 1 else pos[:, :, None]) \
        * freqs[None, None]
    cos = torch.cos(ang)[:, :, None, :]     # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(cfg, gen: torch.Generator, dtype: torch.dtype,
                   device: torch.device, lead: tuple[int, ...] = ()
                   ) -> Params:
    d, h, hk, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "wq": init_linear(gen, d, h * dh, bias=cfg.qkv_bias, **kw),
        "wk": init_linear(gen, d, hk * dh, bias=cfg.qkv_bias, **kw),
        "wv": init_linear(gen, d, hk * dh, bias=cfg.qkv_bias, **kw),
        "wo": init_linear(gen, h * dh, d, bias=cfg.mlp_bias,
                          scale=(h * dh) ** -0.5
                          / math.sqrt(2 * cfg.n_layers), **kw),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def _qkv(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor,
         use_rope: bool):
    h, hk = cfg.n_heads, cfg.n_kv_heads
    q = _split_heads(linear(p["wq"], x), h)
    k = _split_heads(linear(p["wk"], x), hk)
    v = _split_heads(linear(p["wv"], x), hk)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(p: Params, q, k, v, *, causal: bool, window: int | None):
    """Attention core (the flash kernel for CUDA tensors) + output
    projection; q (B, S, H, Dh), k/v (B, S, Hk, Dh)."""
    b, s, h, dh = q.shape
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal, window=window)
    return linear(p["wo"], o.transpose(1, 2).reshape(b, s, h * dh))


def attention_layer(cfg, p: Params, x: torch.Tensor, *,
                    positions: torch.Tensor, causal: bool = True,
                    window: int | None = None, use_rope: bool = True
                    ) -> torch.Tensor:
    """Full-sequence self-attention (prefill / eval)."""
    q, k, v = _qkv(cfg, p, x, positions, use_rope)
    return _attend(p, q, k, v, causal=causal, window=window)


def attention_prefill(cfg, p: Params, x: torch.Tensor, *,
                      positions: torch.Tensor, causal: bool = True,
                      window: int | None = None, use_rope: bool = True,
                      pad_to: int | None = None
                      ) -> tuple[torch.Tensor, Params]:
    """Full-sequence attention that also returns the decode cache.

    Cache layout (B, S, Hk, Dh); for local windows a ring buffer of the
    last ``window`` positions keyed by ``pos % window``.  ``pad_to``
    right-pads the cache's seq dim so decode steps can append in place."""
    q, k, v = _qkv(cfg, p, x, positions, use_rope)
    out = _attend(p, q, k, v, causal=causal, window=window)
    s = k.shape[1]
    if window is not None and s >= window:
        order = torch.argsort(positions[-window:] % window)
        cache = {"k": k[:, -window:][:, order], "v": v[:, -window:][:, order]}
    else:
        cache = {"k": k, "v": v}
        target = window if window is not None else pad_to
        if target is not None and target > s:
            cache = {n: F.pad(t, (0, 0, 0, 0, 0, target - s))
                     for n, t in cache.items()}
    return out, cache


def masked_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask: torch.Tensor
                            ) -> torch.Tensor:
    """q (B, H, 1, Dh), k/v (B, S, Hk, Dh), mask (S,) or (B, S) bool of
    valid cache slots → (B, H, 1, Dh).  Products in fp32."""
    b, hq, _, dh = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, hk, hq // hk, dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * dh ** -0.5
    mvalid = mask[None, None, None, :] if mask.dim() == 1 \
        else mask[:, None, None, :]
    s = torch.where(mvalid, s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhgs,bshd->bhgd", e.to(v.dtype).float(), v.float())
    o = o / e.sum(-1, keepdim=True)
    return o.reshape(b, hq, 1, dh).to(q.dtype)


def attention_decode(cfg, p: Params, x: torch.Tensor, cache: Params,
                     pos: torch.Tensor, *, window: int | None = None,
                     use_rope: bool = True) -> tuple[torch.Tensor, Params]:
    """One-token decode against a KV cache (full or ring-buffered local).

    ``pos`` is a scalar tensor (every row appends at one position) or a
    ``(B,)`` vector (continuous batching at mixed lengths: each row writes
    its new KV at its own position and masks its own prefix).  The new KV
    is written into ``cache`` in place, where the reference rebuilds the
    arrays; the returned cache is the same tensors."""
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device)
    vec = pos.dim() == 1
    q = _split_heads(linear(p["wq"], x), h)              # (B, 1, H, Dh)
    k_new = _split_heads(linear(p["wk"], x), hk)         # (B, 1, Hk, Dh)
    v_new = _split_heads(linear(p["wv"], x), hk)
    if use_rope:
        posv = pos[:, None] if vec else pos.reshape(1, 1)
        q = rope(q, posv, cfg.rope_theta)
        k_new = rope(k_new, posv, cfg.rope_theta)

    k, v = cache["k"], cache["v"]
    s_max = k.shape[1]
    ring = window is not None and s_max == window
    slot = pos % window if ring else pos
    if vec:
        rows = torch.arange(b, device=x.device)
        k[rows, slot] = k_new[:, 0]
        v[rows, slot] = v_new[:, 0]
    else:
        k[:, slot] = k_new[:, 0]
        v[:, slot] = v_new[:, 0]
    j = torch.arange(s_max, device=x.device)
    pcol = pos[:, None] if vec else pos
    if ring:
        # slot j holds the latest position p <= pos with p % W == j
        mask = (pcol - ((pcol - j) % window)) >= 0
    else:
        mask = j <= pcol
        if window is not None:
            mask &= j > pcol - window
    o = masked_decode_attention(q.transpose(1, 2), k, v, mask)
    o = o.transpose(1, 2).reshape(b, 1, h * dh)
    return linear(p["wo"], o), {"k": k, "v": v}


def init_kv_cache(cfg, batch: int, seq: int, dtype: torch.dtype,
                  device: torch.device, *, window: int | None = None,
                  lead: tuple[int, ...] = ()) -> Params:
    hk, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    s = min(seq, window) if window is not None else seq
    shape = (*lead, batch, s, hk, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLP — the FTL integration point
# ---------------------------------------------------------------------------

def init_mlp(cfg, gen: torch.Generator, dtype: torch.dtype,
             device: torch.device, d_ff: int | None = None,
             lead: tuple[int, ...] = ()) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {
        "w1": init_linear(gen, d, f, bias=cfg.mlp_bias, **kw),
        "w2": init_linear(gen, f, d, bias=cfg.mlp_bias,
                          scale=f ** -0.5 / math.sqrt(2 * cfg.n_layers),
                          **kw),
    }
    if cfg.mlp_gated:
        p["wg"] = init_linear(gen, d, f, bias=False, **kw)
    return p


def mlp_layer(cfg, p: Params, x: torch.Tensor, *,
              ftl_mode: str | None = None, plan=None) -> torch.Tensor:
    """MLP dispatched through the FTL executor registry.

    off   — layer-per-layer: the hidden tensor is materialized.  Baseline.
    fused — the fused-MLP kernel (its plain version for CPU tensors).
    scan  — the portable FTL schedule as a loop over token tiles.
    auto  — plan-driven: the fusion partitioner's schedule picks the
            executor.

    ``plan`` (a :class:`~repro_torch.core.ftl.registry.BlockPlan`) makes
    the plan's own MLP binding authoritative under 'auto'; the override
    modes keep their meaning either way."""
    mode = ftl_mode if ftl_mode is not None else cfg.ftl_mode
    wg = p.get("wg", {}).get("w")
    b1, b2 = p["w1"].get("b"), p["w2"].get("b")
    w1, w2 = p["w1"]["w"], p["w2"]["w"]
    dtype = registry.dtype_name(x.dtype)
    if plan is not None:
        from repro_torch.core.ftl import executor_block  # lazy: no cycle
        exe = executor_block.resolve_mlp(
            plan, mode, x.shape[-2], dtype, d_model=w1.shape[0],
            d_ff=w1.shape[1], gated=wg is not None, plat=x.device.type)
    else:
        exe = registry.mlp_executor(
            mode, m=x.shape[-2], d_model=w1.shape[0], d_ff=w1.shape[1],
            dtype=dtype, gated=wg is not None, act=cfg.mlp_act,
            device=x.device)
    return exe.run(x, w1, w2, wg, b1, b2, act=cfg.mlp_act)


# ---------------------------------------------------------------------------
# whole-block execution — BlockPlan as the execution authority
# ---------------------------------------------------------------------------

def block_layer(cfg, p: Params, x: torch.Tensor, *,
                positions: torch.Tensor, plan=None, causal: bool = True,
                window: int | None = None, use_rope: bool = True
                ) -> torch.Tensor:
    """One pre-norm attention+MLP block, plan-driven when ``plan`` is set
    (``registry.run_block``), else the layer-per-layer reference path."""
    if plan is not None:
        return registry.run_block(
            plan, p, x, positions=positions, causal=causal, window=window,
            use_rope=use_rope, ftl_mode=cfg.ftl_mode)
    h = norm(p["ln1"], x, cfg.norm)
    x = x + attention_layer(cfg, p["attn"], h, positions=positions,
                            causal=causal, window=window, use_rope=use_rope)
    if "mlp" in p:
        h = norm(p["ln2"], x, cfg.norm)
        x = x + mlp_layer(cfg, p["mlp"], h)
    return x
