"""Shared layers of the port: norms, RoPE, GQA attention (prefill and
cached decode: full, local window or cross-attention to a context) and
the MLP with FTL as an execution mode.

Parameters are plain nested dicts of tensors, and every layer is a plain
function ``f(cfg, params, x, ...)``, as in the reference
``repro.models.layers``.  Initializers take an explicit
``torch.Generator`` and device, and draw from the same distributions at
the same scales as the reference.  An ``init_*`` given ``lead=(n,)``
returns parameters stacked along a leading layer axis.

Under a mesh step whose ``model`` axis is larger than 1 the layers
compute Megatron-style on the weights' ``model`` shards, asking
``act_sharding.tp_split`` which dims the reference's rules split: wq,
wk, wv, w1 and wg are column-parallel (their input through
``collectives.copy_in``), wo and w2 row-parallel (``reduce_out``).  The
attention core runs on this rank's heads where ``heads_q`` splits, else
whole on every rank; a decode step attends to this rank's slots of a
cache split by sequence and merges the ranks' partial softmaxes.
Outside a mesh step every question answers None and the layers run as
the reference's.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.ftl import registry
from repro_torch.distributed import collectives as C
from repro_torch.distributed.act_sharding import (constrain, kv_seq_len,
                                                  placed, tp_split)
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
    p = {"w": placed(w.mul_(scale).to(dtype))}
    if bias:
        p["b"] = placed(torch.zeros((*lead, d_out), dtype=dtype,
                                    device=device))
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def row_bias_sum(y: torch.Tensor, b: torch.Tensor | None, name: str, tp
                 ) -> torch.Tensor:
    """A row-parallel product's partial ``y`` summed over ``model`` (tp
    None: ``y`` as it is), plus the bias ``b`` of the weight ``name``.
    Where the rules split that bias over ``model`` too, each rank adds
    its slice at its place before the sum, so no weight crosses
    ``model``."""
    if tp is not None and b is not None and tp_split(
            (name, "b"), (y.shape[-1],), 0) is not None:
        n = b.shape[-1]
        y = y + F.pad(b, (tp.rank * n, (tp.size - 1 - tp.rank) * n))
        b = None
    y = C.reduce_out(y, tp)
    return y if b is None else y + b


def row_linear(p: Params, x: torch.Tensor, name: str, tp) -> torch.Tensor:
    """``linear`` of a row-parallel weight ``name`` on this rank's slice
    ``x`` of its input, summed over ``model``."""
    return row_bias_sum(x @ p["w"], p.get("b"), name, tp)


def init_norm(d: int, kind: str, dtype: torch.dtype, device: torch.device,
              lead: tuple[int, ...] = ()) -> Params:
    p = {"scale": placed(torch.ones((*lead, d), dtype=dtype, device=device))}
    if kind == "layernorm":
        p["bias"] = placed(torch.zeros((*lead, d), dtype=dtype,
                                       device=device))
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
    """Q, K, V and output projections; a cross-attention layer's are the
    same shapes (its K and V project the context)."""
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


class _Split(NamedTuple):
    """How an attention layer splits over ``model`` (each None where it
    does not): the q heads and the KV heads (``heads_q`` /
    ``heads_kv``), wq's and wk's (wv's) columns, wo's rows."""
    q: Any = None
    kv: Any = None
    wq: Any = None
    wk: Any = None
    wo: Any = None


def _attn_split(cfg, b: int, s: int) -> _Split:
    """The reference's rules for one attention layer at batch ``b``,
    sequence ``s``: the KV heads split only where the q heads do (they
    divide then, as H is a multiple of Hk)."""
    d, h, hk, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    q = tp_split("heads_q", (b, h, s, dh), 1)
    return _Split(q, q and tp_split("heads_kv", (b, hk, s, dh), 1),
                  tp_split(("wq", "w"), (d, h * dh), 1),
                  tp_split(("wk", "w"), (d, hk * dh), 1),
                  tp_split(("wo", "w"), (h * dh, d), 0))


def _qkv(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor,
         use_rope: bool, kv_source: torch.Tensor | None = None,
         sp: _Split = _Split()):
    """q from ``x``; k and v from ``kv_source`` (a cross-attention
    context, never roped) or from ``x``.  Under a ``model`` split
    ``sp`` the projections are column-parallel: q holds this rank's
    heads where they split, else every head (gathered), and k and v
    this rank's KV heads where those split, else every one."""
    h, hk = cfg.n_heads, cfg.n_kv_heads
    src = x if kv_source is None else kv_source
    xq = C.copy_in(x, sp.wq)
    xs = xq if kv_source is None and (sp.wq is None) == (sp.wk is None) \
        else C.copy_in(src, sp.wk)
    q, k, v = linear(p["wq"], xq), linear(p["wk"], xs), linear(p["wv"], xs)
    if sp.q is None:
        q = C.gather_along(q, sp.wq)
    if sp.kv is None:
        # whole heads; where the q heads split, each rank reads some of
        # them and the backward sums the ranks' gradients
        k = C.gather_along(k, sp.wk, partial_grad=sp.q is not None)
        v = C.gather_along(v, sp.wk, partial_grad=sp.q is not None)
    q = _split_heads(q, h if sp.q is None else h // sp.q.size)
    k = _split_heads(k, hk if sp.kv is None else hk // sp.kv.size)
    v = _split_heads(v, hk if sp.kv is None else hk // sp.kv.size)
    if use_rope and kv_source is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _kv_heads(cfg, k: torch.Tensor, sp: _Split) -> torch.Tensor:
    """The KV heads (B, S, ·, Dh) this rank's q heads read: all of
    ``k``'s but where the q heads split and the KV heads do not, then
    the ones GQA's ``h // (H / Hk)`` maps this rank's q heads to (a
    range, or one KV head a q head where the range would not group
    them evenly)."""
    if sp.q is None or sp.kv is not None:
        return k
    h, hk = cfg.n_heads, cfg.n_kv_heads
    hl = h // sp.q.size
    idx = [(sp.q.rank * hl + j) // (h // hk) for j in range(hl)]
    first, n = idx[0], idx[-1] - idx[0] + 1
    if hl % n == 0 and idx == [first + i // (hl // n) for i in range(hl)]:
        return k.narrow(2, first, n)
    return k[:, :, torch.tensor(idx, device=k.device)]


def _out(p: Params, o: torch.Tensor, sp: _Split) -> torch.Tensor:
    """wo on the attention core's output (B, S, ·): row-parallel on this
    rank's heads' columns, or on its slice of every head's where the
    heads do not split."""
    if sp.q is None:
        o = C.split_along(o, sp.wo)
    return row_linear(p["wo"], o, "wo", sp.wo)


def _attend(cfg, p: Params, q, k, v, *, causal: bool, window: int | None,
            sp: _Split = _Split()):
    """Attention core (the flash kernel for CUDA tensors) + output
    projection; q (B, S, H, Dh), k/v (B, Sk, Hk, Dh), or this rank's
    heads under a ``model`` split ``sp``."""
    b, s, h, dh = q.shape
    k, v = _kv_heads(cfg, k, sp), _kv_heads(cfg, v, sp)
    o = ops.attention(constrain(q.transpose(1, 2), "heads_q"),
                      constrain(k.transpose(1, 2), "heads_kv"),
                      constrain(v.transpose(1, 2), "heads_kv"),
                      causal=causal, window=window)
    return _out(p, o.transpose(1, 2).reshape(b, s, h * dh), sp)


def attention_layer(cfg, p: Params, x: torch.Tensor, *,
                    positions: torch.Tensor, causal: bool = True,
                    window: int | None = None, use_rope: bool = True,
                    kv_source: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence attention (prefill / eval): self-attention, or
    cross-attention to ``kv_source`` (B, Sk, D), which is never causal
    and never roped."""
    sp = _attn_split(cfg, x.shape[0], x.shape[1])
    q, k, v = _qkv(cfg, p, x, positions, use_rope, kv_source, sp)
    return _attend(cfg, p, q, k, v, causal=causal and kv_source is None,
                   window=window, sp=sp)


def attention_prefill(cfg, p: Params, x: torch.Tensor, *,
                      positions: torch.Tensor, causal: bool = True,
                      window: int | None = None, use_rope: bool = True,
                      pad_to: int | None = None, length: int | None = None,
                      kv_source: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, Params]:
    """Full-sequence attention that also returns the decode cache.

    Cache layout (B, S, Hk, Dh); for local windows a ring buffer of the
    last ``window`` positions keyed by ``pos % window``.  ``pad_to``
    right-pads the cache's seq dim so decode steps can append in place.
    ``length`` (≤ S) is the prompt's real length when ``x`` is padded on
    the right: the ring holds the ``window`` positions before it (a full
    cache keeps the padding's KV, which decode overwrites and masks).
    With ``kv_source`` (cross-attention) the cache is the context's K
    and V, whole and unpadded: ``pad_to`` and ``length`` are the
    queries', and apply only to self-attention.  Under a ``model``
    split the cache holds every KV head (gathered where they split), as
    the decode step's cache split by sequence takes it."""
    sp = _attn_split(cfg, x.shape[0], x.shape[1])
    q, k, v = _qkv(cfg, p, x, positions, use_rope, kv_source, sp)
    out = _attend(cfg, p, q, k, v, causal=causal and kv_source is None,
                  window=window, sp=sp)
    k, v = C.gather_along(k, sp.kv, 2), C.gather_along(v, sp.kv, 2)
    if kv_source is not None:
        return out, {"k": k, "v": v}
    s = k.shape[1]
    n = s if length is None else length
    if window is not None and n >= window:
        last = torch.arange(n - window, n, device=k.device)
        ring = last[torch.argsort(positions[last] % window)]
        cache = {"k": k[:, ring], "v": v[:, ring]}
    else:
        cache = {"k": k[:, :n], "v": v[:, :n]} if window is not None \
            else {"k": k, "v": v}
        # a ring buffer must be exactly window-sized for decode
        target = window if window is not None else pad_to
        have = cache["k"].shape[1]
        if target is not None and target > have:
            cache = {nm: F.pad(t, (0, 0, 0, 0, 0, target - have))
                     for nm, t in cache.items()}
    return out, cache


def masked_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask: torch.Tensor, tp=None
                            ) -> torch.Tensor:
    """q (B, H, 1, Dh), k/v (B, S, Hk, Dh), mask (S,) or (B, S) bool of
    valid cache slots → (B, H, 1, Dh).  Products in fp32.  With ``tp``
    the cache is this rank's slots of one split by sequence over
    ``model``: the ranks' softmaxes are merged by their log-sum-exp (the
    max all-reduced, then the rescaled sums and outputs)."""
    b, hq, _, dh = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, hk, hq // hk, dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * dh ** -0.5
    mvalid = mask[None, None, None, :] if mask.dim() == 1 \
        else mask[:, None, None, :]
    s = torch.where(mvalid, s, torch.full_like(s, -1e30))
    m = C.all_reduce_(s.amax(-1, keepdim=True), tp, C.dist.ReduceOp.MAX)
    e = torch.exp(s - m)
    o = torch.einsum("bhgs,bshd->bhgd", e.to(v.dtype).float(), v.float())
    den = e.sum(-1, keepdim=True)
    if tp is not None:
        both = C.all_reduce_(torch.cat([o, den], -1), tp)
        o, den = both[..., :dh], both[..., dh:]
    o = o / den
    return o.reshape(b, hq, 1, dh).to(q.dtype)


def _write_slot(t: torch.Tensor, new: torch.Tensor, slot: torch.Tensor,
                vec: bool, off: int | None) -> None:
    """The new KV ``new`` (B, 1, Hk, Dh) into cache ``t`` at ``slot`` (a
    scalar or one a row), in place.  ``off``: ``t`` holds the slots from
    ``off`` on of a cache split by sequence, and only the rank that
    holds a slot writes it (shape-only: the others write back what is
    there)."""
    if off is not None:
        n = t.shape[1]
        own = (slot >= off) & (slot < off + n)
        slot = (slot - off).clamp(0, n - 1)
    if vec:
        rows = torch.arange(t.shape[0], device=t.device)
        if off is not None:
            new = torch.where(own[:, None, None], new[:, 0], t[rows, slot])
            t[rows, slot] = new
        else:
            t[rows, slot] = new[:, 0]
    else:
        # a one-element index, not a 0-d one: indexing by a 0-d tensor
        # reads its value on the host
        at = slot.reshape(1).long()
        if off is not None:
            new = torch.where(own, new, t.index_select(1, at))
        t.index_copy_(1, at, new)


def attention_decode(cfg, p: Params, x: torch.Tensor, cache: Params,
                     pos: torch.Tensor, *, window: int | None = None,
                     cross: bool = False, use_rope: bool = True
                     ) -> tuple[torch.Tensor, Params]:
    """One-token decode against a KV cache (full or ring-buffered local).

    ``pos`` is a scalar tensor (every row appends at one position) or a
    ``(B,)`` vector (continuous batching at mixed lengths: each row writes
    its new KV at its own position and masks its own prefix).  The new KV
    is written into ``cache`` in place, where the reference rebuilds the
    arrays; the returned cache is the same tensors.  ``cross``: the cache
    is a context's K and V from the prefill, read whole and never
    written, with no rope (``pos`` is not read).

    Under a mesh decode step whose ``model`` axis splits the cache by
    sequence (``cache_pspecs``), ``cache`` is this rank's slots: q, k
    and v are gathered to every head, the rank that holds the new slot
    writes it, the mask is taken at the global slot index, and the
    ranks' partial softmaxes are merged; wo is row-parallel."""
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b = x.shape[0]
    sp = _attn_split(cfg, b, 1)
    q = C.gather_along(linear(p["wq"], x), sp.wq)
    q = _split_heads(q, h)                               # (B, 1, H, Dh)
    k = cache["k"]
    n = k.shape[1]
    seq = tp_split("kv_cache", (b, kv_seq_len(n), hk, dh), 1)
    off = None if seq is None else seq.rank * n
    if cross:
        mask = torch.ones(n, dtype=torch.bool, device=x.device)
        o = masked_decode_attention(q.transpose(1, 2), k, cache["v"], mask,
                                    seq)
        return _out(p, o.transpose(1, 2).reshape(b, 1, h * dh),
                    sp._replace(q=None)), cache
    pos = torch.as_tensor(pos, device=x.device)
    vec = pos.dim() == 1
    k_new = _split_heads(C.gather_along(linear(p["wk"], x), sp.wk), hk)
    v_new = _split_heads(C.gather_along(linear(p["wv"], x), sp.wk), hk)
    if use_rope:
        posv = pos[:, None] if vec else pos.reshape(1, 1)
        q = rope(q, posv, cfg.rope_theta)
        k_new = rope(k_new, posv, cfg.rope_theta)

    v = cache["v"]
    s_max = kv_seq_len(n)
    ring = window is not None and s_max == window
    slot = pos % window if ring else pos
    _write_slot(k, k_new, slot, vec, off)
    _write_slot(v, v_new, slot, vec, off)
    j = torch.arange(n, device=x.device) + (off or 0)
    pcol = pos[:, None] if vec else pos
    if ring:
        # slot j holds the latest position p <= pos with p % W == j
        mask = (pcol - ((pcol - j) % window)) >= 0
    else:
        mask = j <= pcol
        if window is not None:
            mask &= j > pcol - window
    o = masked_decode_attention(q.transpose(1, 2), constrain(k, "kv_cache"),
                                constrain(v, "kv_cache"), mask, seq)
    o = o.transpose(1, 2).reshape(b, 1, h * dh)
    return _out(p, o, sp._replace(q=None)), {"k": k, "v": v}


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
              ftl_mode: str | None = None, plan=None,
              d_ff: int | None = None) -> torch.Tensor:
    """MLP dispatched through the FTL executor registry.

    off   — layer-per-layer: the hidden tensor is materialized.  Baseline.
    fused — the fused-MLP kernel (its plain version for CPU tensors).
    scan  — the portable FTL schedule as a loop over token tiles.
    auto  — plan-driven: the fusion partitioner's schedule picks the
            executor.

    ``plan`` (a :class:`~repro_torch.core.ftl.registry.BlockPlan`) makes
    the plan's own MLP binding authoritative under 'auto'; the override
    modes keep their meaning either way.  ``d_ff`` is the hidden width
    of ``p`` (None: ``cfg.d_ff``).  Where the rules split it over
    ``model`` (``ffn_hidden``), w1 and wg are column-parallel and w2
    row-parallel: the executor is resolved and run at this rank's
    ``d_ff / model`` and the outputs summed; a plan, made for whole-layer
    shapes, raises there."""
    mode = ftl_mode if ftl_mode is not None else cfg.ftl_mode
    wg = p.get("wg", {}).get("w")
    b1, b2 = p["w1"].get("b"), p["w2"].get("b")
    w1, w2 = p["w1"]["w"], p["w2"]["w"]
    tp = tp_split(("w1", "w"), (cfg.d_model, d_ff or cfg.d_ff), 1)
    if tp is not None:
        if plan is not None:
            raise ValueError(
                f"a BlockPlan is made for whole-layer shapes; this MLP runs "
                f"its d_ff split {tp.size} ways over 'model' (pass no plan "
                f"under a model axis larger than 1)")
        x = C.copy_in(x, tp)
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
    if tp is None:
        return exe.run(x, w1, w2, wg, b1, b2, act=cfg.mlp_act)
    return row_bias_sum(exe.run(x, w1, w2, wg, b1, None, act=cfg.mlp_act),
                        b2, "w2", tp)


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
    x = constrain(x + attention_layer(cfg, p["attn"], h, positions=positions,
                                      causal=causal, window=window,
                                      use_rope=use_rope), "residual")
    if "mlp" in p:
        h = norm(p["ln2"], x, cfg.norm)
        x = constrain(x + mlp_layer(cfg, p["mlp"], h), "residual")
    return x
