"""Model assembly of the port: the decoder-only families.

  dense  — embed → [attn + MLP] × L → norm → lm_head
  ssm    — xLSTM: mLSTM blocks with every ``slstm_every``-th an sLSTM; no
           separate MLP (the projections live inside the block)
  hybrid — recurrentgemma: (rec, rec, local-attn) pattern + MLP each layer
  moe    — the dense stack with each MLP replaced by a capacity-routed MoE
           (+ its load-balance aux loss, summed over the layers in fp32)

Layers are grouped into *pattern periods* as in the reference
``repro.models.model``: the params of each position-in-period are stacked
across periods (leaves ``(n_periods, ...)``), and where the reference
consumes the stack with ``lax.scan`` the port walks it with a Python loop
over the same stacked tensors.  Layers that do not fill a whole period
(recurrentgemma: 38 = 12×3 + 2) are applied after the loop, from
``params["rem"]`` / ``cache["rem"]``; a stack shorter than one period
(``xlstm-1.3b.reduced()``: 4 layers, period 8) has zero whole periods
and only those.  Cross-attention and encoder–decoder configs are not
ported yet and raise.  A pure-SSM stack has no plannable block:
its plans are None, as in the reference.

The serving plan machinery (``PREFILL_BUCKETS``, :func:`bucket_m`,
:func:`serve_plan`) is the reference's, keyed additionally by the device
platform the plan's executors are bound for.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import hw
from repro_torch.core.ftl import registry as ftl_registry
from repro_torch.core.ftl.solver import InfeasibleError
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import recurrent
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
from repro_torch.models.moe import init_moe, moe_layer

Params = dict[str, Any]


class _Mixer(NamedTuple):
    """A recurrent block's functions, all with one signature per role."""
    init: Callable        # (cfg, gen, dtype, device, lead) -> params
    block: Callable       # (cfg, p, x, *, return_state, length)
    decode: Callable      # (cfg, p, x, state) -> (y, state), in place
    init_state: Callable  # (cfg, batch, device, lead) -> state


MIXERS = {
    "mlstm": _Mixer(recurrent.init_mlstm_block, recurrent.mlstm_block,
                    recurrent.mlstm_block_decode,
                    recurrent.init_mlstm_state),
    "slstm": _Mixer(recurrent.init_slstm_block, recurrent.slstm_block,
                    recurrent.slstm_block_decode,
                    recurrent.init_slstm_state),
    "rec": _Mixer(recurrent.init_rec_block, recurrent.rec_block,
                  recurrent.rec_block_decode, recurrent.init_rec_state),
}
# kinds whose mixer handles its own input norm (recurrent blocks do)
_SELF_NORMED = set(MIXERS)
# kinds that keep a decode cache of KV type
_KV_KINDS = {"attn", "local"}


def _check_supported(cfg) -> None:
    if cfg.is_encoder_decoder or \
            set(period_kinds(cfg)) - _KV_KINDS - _SELF_NORMED:
        raise NotImplementedError(
            f"{cfg.name!r} ({cfg.family}) needs layers the port does not "
            f"have yet: it serves decoder-only attention (dense or MoE), "
            f"RG-LRU and xLSTM (mLSTM/sLSTM) stacks")


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
    """One attention or recurrent layer (+ MLP or MoE), stacked along
    ``lead``."""
    dt = torch_dtype(cfg.dtype)
    if kind in _KV_KINDS:
        p: Params = {"ln1": init_norm(cfg.d_model, cfg.norm, dt, device,
                                      lead),
                     "attn": init_attention(cfg, gen, dt, device, lead)}
    elif kind in _SELF_NORMED:
        p = {"mix": MIXERS[kind].init(cfg, gen, dt, device, lead)}
    else:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    if cfg.is_moe:
        p["ln2"] = init_norm(cfg.d_model, cfg.norm, dt, device, lead)
        p["moe"] = init_moe(cfg, gen, dt, device, lead=lead)
    elif cfg.d_ff:
        p["ln2"] = init_norm(cfg.d_model, cfg.norm, dt, device, lead)
        p["mlp"] = init_mlp(cfg, gen, dt, device, lead=lead)
    return p


def _window(cfg, kind: str) -> int | None:
    return cfg.local_window if kind == "local" else None


def _apply_ffn(cfg, p: Params, x: torch.Tensor, plan=None
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The MLP's or MoE's residual delta and the router's aux loss (an
    fp32 scalar; None without a router, so that a dense layer launches
    nothing for it); ``plan`` routes an MLP through its BlockPlan binding
    (serving's phase-split plans), None re-resolves.  A MoE takes no plan,
    as in the reference."""
    if "moe" in p:
        return moe_layer(cfg, p["moe"], norm(p["ln2"], x, cfg.norm))
    if "mlp" in p:
        return mlp_layer(cfg, p["mlp"], norm(p["ln2"], x, cfg.norm),
                         plan=plan), None
    return torch.zeros_like(x), None


def _apply_mixer(cfg, p: Params, kind: str, x: torch.Tensor, *,
                 positions: torch.Tensor) -> torch.Tensor:
    if kind in _SELF_NORMED:
        return MIXERS[kind].block(cfg, p["mix"], x)
    h = norm(p["ln1"], x, cfg.norm)
    return attention_layer(cfg, p["attn"], h, positions=positions,
                           window=_window(cfg, kind))


def _apply_layer(cfg, p: Params, kind: str, x: torch.Tensor, *,
                 positions: torch.Tensor, plan=None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Pre-norm residual layer (full sequence): (x, the router's aux loss
    or None, as :func:`_apply_ffn`)."""
    if plan is not None and kind in _KV_KINDS and "mlp" in p:
        # BlockPlan-driven: projections, attention core and MLP dispatch
        # through their bound executors (registry.run_block)
        return block_layer(cfg, p, x, positions=positions, plan=plan,
                           window=_window(cfg, kind)), None
    x = x + _apply_mixer(cfg, p, kind, x, positions=positions)
    d, aux = _apply_ffn(cfg, p, x)
    return x + d, aux


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
    """The stacked tree's period slices (views), in order.  Each leaf is
    unbound once, so that autograd stacks a leaf's gradient once a pass,
    as the transpose of the reference's ``lax.scan`` does (indexing
    ``a[i]`` would add a full-stack zero-filled gradient for every
    period)."""
    n = tree_leaves(stack)[0].shape[0]
    slices = tree_map(lambda a: a.unbind(0), stack)
    for i in range(n):
        yield tree_map(lambda t, i=i: t[i], slices)


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


def layer_stream(cfg, params: Params, tokens: torch.Tensor, plan=None):
    """The eval forward's residual stream, one layer at a time: yields
    ``(kind, layer params, x_in, x_out, aux)`` for every layer in order,
    from the embedded ``tokens`` (B, S); ``aux`` is the layer's router aux
    loss (fp32; None without a router).  ``forward`` is the last ``x_out``
    through the final norm and the unembedding, and the sum of ``aux``."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(params, tokens)
    # cfg.remat under autograd: each layer keeps only its input and runs
    # its forward again in the backward pass (the reference's
    # jax.checkpoint with nothing_saveable around each period)
    remat = cfg.remat and torch.is_grad_enabled()
    for kind, p in _layers(cfg, params):
        layer = functools.partial(_apply_layer, cfg, p, kind,
                                  positions=positions, plan=plan)
        y, aux = (checkpoint(layer, x, use_reentrant=False) if remat
                  else layer(x))
        yield kind, p, x, y, aux
        x = y


def forward(cfg, params: Params, batch: dict[str, torch.Tensor]
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval forward: ``batch['tokens']`` (B, S) → (logits, aux)."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    plan = _block_plan(cfg, tokens.shape[1], cfg.dtype, device=tokens.device)
    # the layers' aux summed in fp32 in layer order, as the reference's
    # scan carry sums it
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for _, _, _, x, a in layer_stream(cfg, params, tokens, plan):
        if a is not None:
            aux = aux + a
    x = norm(params["final_norm"], x, cfg.norm)
    return _unembed(cfg, params, x), aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def _layer_prefill(cfg, p: Params, kind: str, x: torch.Tensor, *,
                   positions: torch.Tensor, max_seq: int | None = None,
                   plan=None, length: int | None = None
                   ) -> tuple[torch.Tensor, Params]:
    """Returns (x, cache); the cache holds the state after ``length``
    tokens (None: all of them)."""
    if kind in _SELF_NORMED:
        o, cache = MIXERS[kind].block(cfg, p["mix"], x, return_state=True,
                                       length=length)
    else:
        h = norm(p["ln1"], x, cfg.norm)
        o, cache = attention_prefill(cfg, p["attn"], h, positions=positions,
                                     causal=True, window=_window(cfg, kind),
                                     pad_to=max_seq, length=length)
    x = x + o
    return x + _apply_ffn(cfg, p, x, plan=plan)[0], cache


def _layer_decode(cfg, p: Params, kind: str, x: torch.Tensor,
                  cache: Params, pos: torch.Tensor, plan=None
                  ) -> tuple[torch.Tensor, Params]:
    if kind in _SELF_NORMED:
        o, cache = MIXERS[kind].decode(cfg, p["mix"], x, cache)
    else:
        h = norm(p["ln1"], x, cfg.norm)
        o, cache = attention_decode(cfg, p["attn"], h, cache, pos,
                                    window=_window(cfg, kind))
    x = x + o
    return x + _apply_ffn(cfg, p, x, plan=plan)[0], cache


def _init_layer_cache(cfg, kind: str, batch: int, seq: int,
                      device: torch.device, lead: tuple[int, ...] = ()
                      ) -> Params:
    if kind in _SELF_NORMED:
        return MIXERS[kind].init_state(cfg, batch, device, lead)
    return init_kv_cache(cfg, batch, seq, torch_dtype(cfg.dtype), device,
                         window=_window(cfg, kind), lead=lead)


def init_cache(cfg, batch: int, seq: int, *,
               device: torch.device | str | None = None) -> Params:
    """Zero decode state for a ``seq``-long context, in init_params'
    stack structure (stacked leaves ``(n_periods, batch, ...)``: KV
    ``(…, seq, Hk, Dh)``; in fp32 the RG-LRU's ``h`` ``(…, W)`` and
    ``conv`` ``(…, conv_width - 1, W)``, the mLSTM's ``C`` ``(…, H, Dh,
    Dh)``, ``n`` ``(…, H, Dh)`` and ``m`` ``(…, H)``, the sLSTM's ``h``,
    ``c``, ``n``, ``m`` ``(…, D)``)."""
    _check_supported(cfg)
    device = resolve_device(device)
    kinds, n_full, rem_kinds = _layer_split(cfg)
    cache: Params = {"layers": {
        f"pos{i}": _init_layer_cache(cfg, k, batch, seq, device,
                                     lead=(n_full,))
        for i, k in enumerate(kinds)}}
    if rem_kinds:
        cache["rem"] = {
            f"rem{i}": _init_layer_cache(cfg, k, batch, seq, device)
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
    of the final one (bucketed prompts are right-padded), and the
    recurrent state and local-window ring are taken there too: the
    tokens after it are padding.  (The reference takes them at the
    bucket's end, pads included.)"""
    _check_supported(cfg)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    length = None if last_pos is None else int(last_pos) + 1
    kinds, _, rem_kinds = _layer_split(cfg)
    x = _embed(params, tokens)
    per_period: list[Params] = []
    for pp in _periods(params["layers"]):
        caches = {}
        for i, kind in enumerate(kinds):
            x, caches[f"pos{i}"] = _layer_prefill(
                cfg, pp[f"pos{i}"], kind, x, positions=positions,
                max_seq=max_seq, plan=plan, length=length)
        per_period.append(caches)
    if per_period:
        stacked = tree_map(lambda *ts: torch.stack(ts), *per_period)
    else:       # no whole period: the stack's leaves are (0, ...) long
        stacked = {f"pos{i}": _init_layer_cache(
            cfg, kind, tokens.shape[0], max_seq or tokens.shape[1],
            tokens.device, lead=(0,)) for i, kind in enumerate(kinds)}
    cache: Params = {"layers": stacked}
    if rem_kinds:
        cache["rem"] = {}
        for i, kind in enumerate(rem_kinds):
            x, cache["rem"][f"rem{i}"] = _layer_prefill(
                cfg, params["rem"][f"rem{i}"], kind, x,
                positions=positions, max_seq=max_seq, plan=plan,
                length=length)
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
