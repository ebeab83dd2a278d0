"""Model assembly of the port: the decoder-only families.

  dense — embed → [attn + MLP] × L → norm → lm_head

Layers are grouped into *pattern periods* as in the reference
``repro.models.model``: the params of each position-in-period are stacked
across periods (leaves ``(n_periods, ...)``), and where the reference
consumes the stack with ``lax.scan`` the port walks it with a Python loop
over the same stacked tensors.  Layers that do not fill a whole period are
applied after the loop.  Mixer kinds other than ``attn``/``local``
(recurrent, cross-attention), MoE FFNs and encoder–decoder configs are not
ported yet and raise.

The serving plan machinery (``PREFILL_BUCKETS``, :func:`bucket_m`,
:func:`serve_plan`) is the reference's, keyed additionally by the device
platform the plan's executors are bound for.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from repro_torch.core import hw
from repro_torch.core.ftl import registry as ftl_registry
from repro_torch.core.ftl.solver import InfeasibleError
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.layers import (
    attention_decode,
    attention_layer,
    attention_prefill,
    block_layer,
    init_attention,
    init_kv_cache,
    init_linear,
    init_mlp,
    init_norm,
    linear,
    mlp_layer,
    norm,
)

Params = dict[str, Any]

_KV_KINDS = {"attn", "local"}


def _check_supported(cfg) -> None:
    if cfg.is_encoder_decoder or cfg.is_moe or \
            set(period_kinds(cfg)) - _KV_KINDS:
        raise NotImplementedError(
            f"{cfg.name!r} ({cfg.family}) needs layers the port does not "
            f"have yet: it serves decoder-only attention stacks")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts (``rest``: trees of
    the same structure, passed alongside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


# ===========================================================================
# per-layer init and apply
# ===========================================================================

def _init_layer(cfg, gen: torch.Generator, kind: str, device: torch.device,
                lead: tuple[int, ...] = ()) -> Params:
    """One attention layer (+ MLP), stacked along ``lead``."""
    if kind not in _KV_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    dt = torch_dtype(cfg.dtype)
    p: Params = {"ln1": init_norm(cfg.d_model, cfg.norm, dt, device, lead),
                 "attn": init_attention(cfg, gen, dt, device, lead)}
    if cfg.d_ff:
        p["ln2"] = init_norm(cfg.d_model, cfg.norm, dt, device, lead)
        p["mlp"] = init_mlp(cfg, gen, dt, device, lead=lead)
    return p


def _window(cfg, kind: str) -> int | None:
    return cfg.local_window if kind == "local" else None


def _apply_ffn(cfg, p: Params, x: torch.Tensor, plan=None) -> torch.Tensor:
    """The MLP's residual delta; ``plan`` routes it through its BlockPlan
    binding (serving's phase-split plans), None re-resolves."""
    if "mlp" not in p:
        return torch.zeros_like(x)
    return mlp_layer(cfg, p["mlp"], norm(p["ln2"], x, cfg.norm), plan=plan)


def _apply_layer(cfg, p: Params, kind: str, x: torch.Tensor, *,
                 positions: torch.Tensor, plan=None) -> torch.Tensor:
    """Pre-norm residual layer (full sequence)."""
    if plan is not None and "mlp" in p:
        # BlockPlan-driven: projections, attention core and MLP dispatch
        # through their bound executors (registry.run_block)
        return block_layer(cfg, p, x, positions=positions, plan=plan,
                           window=_window(cfg, kind))
    h = norm(p["ln1"], x, cfg.norm)
    x = x + attention_layer(cfg, p["attn"], h, positions=positions,
                            window=_window(cfg, kind))
    return x + _apply_ffn(cfg, p, x)


# ===========================================================================
# period/stack machinery
# ===========================================================================

def period_kinds(cfg) -> list[str]:
    """Mixer kinds of the positions inside one pattern period."""
    if cfg.family == "hybrid":
        return list(cfg.block_pattern)
    if cfg.family == "vlm" and cfg.cross_attn_every:
        k = cfg.cross_attn_every
        return ["attn"] * (k - 1) + ["cross"]
    if cfg.family == "ssm":
        if cfg.slstm_every:
            k = cfg.slstm_every
            return ["mlstm"] * (k - 1) + ["slstm"]
        return ["mlstm"]
    return ["attn"]


def _layer_split(cfg) -> tuple[list[str], int, list[str]]:
    """(period kinds, n_full_periods, remainder kinds)."""
    kinds = period_kinds(cfg)
    per = len(kinds)
    return kinds, cfg.n_layers // per, kinds[:cfg.n_layers % per]


def _init_stack(cfg, gen: torch.Generator, kinds: list[str], n: int,
                device: torch.device) -> Params:
    """Stacked params: one entry per position-in-period, leaves (n, ...)."""
    return {f"pos{i}": _init_layer(cfg, gen, kind, device, lead=(n,))
            for i, kind in enumerate(kinds)}


def _periods(stack: Params):
    """The stacked tree's period slices (views), in order."""
    n = tree_leaves(stack)[0].shape[0]
    for i in range(n):
        yield tree_map(lambda a, i=i: a[i], stack)


@functools.lru_cache(maxsize=256)
def _block_plan_cached(cfg, m: int, dtype: str, target, plat: str):
    if cfg.is_moe or cfg.ftl_mode == "off":
        return None
    try:
        return ftl_registry.plan_block(cfg, m=m, dtype=dtype, target=target,
                                       device=plat)
    except (ValueError, InfeasibleError):
        return None


def _block_plan(cfg, m: int, dtype: str, target=None, device=None):
    """Cached whole-block FTL plan for the forward pass, or None when
    there is nothing to plan (``ftl_mode='off'``, MoE)."""
    target = target if target is not None else hw.default_target()
    return _block_plan_cached(cfg, m, dtype, target,
                              ftl_registry.platform(device))


# ---------------------------------------------------------------------------
# serving plan cache: bucketed prefill shapes + phase-split plans
# ---------------------------------------------------------------------------

# Prompts are padded up to the next rung, so the number of distinct
# prefill plans is bounded by the ladder length.
PREFILL_BUCKETS: tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512, 1024,
                                    2048, 4096)


def bucket_m(m: int, buckets: tuple[int, ...] = PREFILL_BUCKETS) -> int:
    """Smallest bucket ≥ ``m``; raises when ``m`` exceeds the ladder."""
    if m <= 0:
        raise ValueError(f"bucket_m needs m >= 1, got {m}")
    for b in buckets:
        if b >= m:
            return b
    raise ValueError(
        f"m={m} exceeds the largest prefill bucket {max(buckets)}")


@functools.lru_cache(maxsize=512)
def _serve_plan_cached(cfg, m: int, dtype: str, target, phase: str,
                       plat: str):
    try:
        return ftl_registry.plan_block(cfg, m=m, dtype=dtype, target=target,
                                       phase=phase, device=plat)
    except (ValueError, InfeasibleError):
        return None


ftl_registry.register_plan_cache("model._block_plan_cached",
                                 _block_plan_cached)
ftl_registry.register_plan_cache("model._serve_plan_cached",
                                 _serve_plan_cached)


def serve_plan(cfg, *, m: int, dtype: str | None = None, target=None,
               phase: str = "prefill",
               buckets: tuple[int, ...] = PREFILL_BUCKETS, device=None):
    """(bucketed m, BlockPlan-or-None) for one serving regime on
    ``device``'s platform.  Prefill shapes bucket through the ladder;
    decode always plans at ``m=1``.  Does not gate on ``cfg.ftl_mode``:
    the executors honour the mode at dispatch."""
    target = target if target is not None else hw.default_target()
    dtype = dtype if dtype is not None else cfg.dtype
    mb = 1 if phase == "decode" else bucket_m(m, buckets)
    return mb, _serve_plan_cached(cfg, mb, dtype, target, phase,
                                  ftl_registry.platform(device))


# ===========================================================================
# embeddings
# ===========================================================================

def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["tok"][tokens]


def _unembed(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"]["tok"].T
    return linear(params["lm_head"], x)


# ===========================================================================
# public API — decoder-only families
# ===========================================================================

def init_params(cfg, generator: torch.Generator | int = 0, *,
                device: torch.device | str | None = None) -> Params:
    """Full parameter tree on ``device`` (None: the CUDA card, and raises
    when there is none).  ``generator`` is a ``torch.Generator`` on that
    device, or an int seed for one."""
    _check_supported(cfg)
    device = resolve_device(device)
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(generator))
    dt = torch_dtype(cfg.dtype)
    kinds, n_full, rem_kinds = _layer_split(cfg)
    tok = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                      device=device, dtype=torch.float32)
    params: Params = {
        "embed": {"tok": tok.mul_(cfg.d_model ** -0.5).to(dt)},
        "layers": _init_stack(cfg, gen, kinds, n_full, device),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dt, device),
    }
    del tok
    if rem_kinds:
        params["rem"] = {f"rem{i}": _init_layer(cfg, gen, k, device)
                         for i, k in enumerate(rem_kinds)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size,
                                        bias=False, dtype=dt, device=device)
    return params


def _layers(cfg, params: Params):
    """(kind, layer params) of every layer, in order."""
    kinds, _, rem_kinds = _layer_split(cfg)
    for pp in _periods(params["layers"]):
        for i, kind in enumerate(kinds):
            yield kind, pp[f"pos{i}"]
    for i, kind in enumerate(rem_kinds):
        yield kind, params["rem"][f"rem{i}"]


def forward(cfg, params: Params, batch: dict[str, torch.Tensor]
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval forward: ``batch['tokens']`` (B, S) → (logits, aux)."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)
    x = _embed(params, tokens)
    plan = _block_plan(cfg, s, cfg.dtype, device=tokens.device)
    for kind, p in _layers(cfg, params):
        x = _apply_layer(cfg, p, kind, x, positions=positions, plan=plan)
    x = norm(params["final_norm"], x, cfg.norm)
    return _unembed(cfg, params, x), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def _layer_prefill(cfg, p: Params, kind: str, x: torch.Tensor, *,
                   positions: torch.Tensor, max_seq: int | None = None,
                   plan=None) -> tuple[torch.Tensor, Params]:
    h = norm(p["ln1"], x, cfg.norm)
    o, cache = attention_prefill(cfg, p["attn"], h, positions=positions,
                                 causal=True, window=_window(cfg, kind),
                                 pad_to=max_seq)
    x = x + o
    return x + _apply_ffn(cfg, p, x, plan=plan), cache


def _layer_decode(cfg, p: Params, kind: str, x: torch.Tensor,
                  cache: Params, pos: torch.Tensor, plan=None
                  ) -> tuple[torch.Tensor, Params]:
    h = norm(p["ln1"], x, cfg.norm)
    o, cache = attention_decode(cfg, p["attn"], h, cache, pos,
                                window=_window(cfg, kind))
    x = x + o
    return x + _apply_ffn(cfg, p, x, plan=plan), cache


def init_cache(cfg, batch: int, seq: int, *,
               device: torch.device | str | None = None) -> Params:
    """Zero decode state for a ``seq``-long context, in init_params'
    stack structure (stacked leaves ``(n_periods, batch, seq, Hk, Dh)``)."""
    _check_supported(cfg)
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    kinds, n_full, rem_kinds = _layer_split(cfg)
    cache: Params = {"layers": {
        f"pos{i}": init_kv_cache(cfg, batch, seq, dt, device,
                                 window=_window(cfg, k), lead=(n_full,))
        for i, k in enumerate(kinds)}}
    if rem_kinds:
        cache["rem"] = {
            f"rem{i}": init_kv_cache(cfg, batch, seq, dt, device,
                                     window=_window(cfg, k))
            for i, k in enumerate(rem_kinds)}
    return cache


def prefill(cfg, params: Params, batch: dict[str, torch.Tensor],
            max_seq: int | None = None, *, plan=None,
            last_pos: int | torch.Tensor | None = None
            ) -> tuple[torch.Tensor, Params]:
    """Process the full prompt; returns (logits at one token, decode
    cache).

    ``max_seq`` right-pads the KV caches so decode steps append in place;
    ``plan`` threads a (bucketed) prefill BlockPlan into every layer's MLP
    dispatch; ``last_pos`` returns the logits at that token index instead
    of the final one (bucketed prompts are right-padded)."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    kinds, _, rem_kinds = _layer_split(cfg)
    x = _embed(params, tokens)
    per_period: list[Params] = []
    for pp in _periods(params["layers"]):
        caches = {}
        for i, kind in enumerate(kinds):
            x, caches[f"pos{i}"] = _layer_prefill(
                cfg, pp[f"pos{i}"], kind, x, positions=positions,
                max_seq=max_seq, plan=plan)
        per_period.append(caches)
    cache: Params = {"layers": tree_map(lambda *ts: torch.stack(ts),
                                        *per_period)}
    if rem_kinds:
        cache["rem"] = {}
        for i, kind in enumerate(rem_kinds):
            x, cache["rem"][f"rem{i}"] = _layer_prefill(
                cfg, params["rem"][f"rem{i}"], kind, x,
                positions=positions, max_seq=max_seq, plan=plan)
    x = norm(params["final_norm"], _last_tokens(x, last_pos), cfg.norm)
    return _unembed(cfg, params, x), cache


def _last_tokens(x: torch.Tensor, last_pos) -> torch.Tensor:
    """(B, S, D) → (B, 1, D) at ``last_pos`` (None → the final position)."""
    if last_pos is None:
        return x[:, -1:]
    i = int(last_pos)
    return x[:, i:i + 1]


def decode_step(cfg, params: Params, token: torch.Tensor, cache: Params,
                pos: torch.Tensor, *, plan=None
                ) -> tuple[torch.Tensor, Params]:
    """One decode step: ``token`` (B, 1) + cache @ ``pos`` → (logits,
    cache).  ``pos`` is a scalar or a ``(B,)`` vector (each row appends
    and masks at its own position); ``plan`` threads the m=1 decode
    BlockPlan into every layer's MLP dispatch.  The cache is updated in
    place and returned."""
    _check_supported(cfg)
    kinds, _, rem_kinds = _layer_split(cfg)
    x = _embed(params, token)
    for pp, cc in zip(_periods(params["layers"]),
                      _periods(cache["layers"])):
        for i, kind in enumerate(kinds):
            x, _ = _layer_decode(cfg, pp[f"pos{i}"], kind, x,
                                 cc[f"pos{i}"], pos, plan=plan)
    for i, kind in enumerate(rem_kinds):
        x, _ = _layer_decode(cfg, params["rem"][f"rem{i}"], kind, x,
                             cache["rem"][f"rem{i}"], pos, plan=plan)
    x = norm(params["final_norm"], x, cfg.norm)
    return _unembed(cfg, params, x), cache
