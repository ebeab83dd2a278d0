"""Model assembly of the port: every family of the reference.

  dense  — embed → [attn + MLP] × L → norm → lm_head
  ssm    — xLSTM: mLSTM blocks with every ``slstm_every``-th an sLSTM; no
           separate MLP (the projections live inside the block)
  hybrid — recurrentgemma: (rec, rec, local-attn) pattern + MLP each layer
  moe    — the dense stack with each MLP replaced by a capacity-routed MoE
           (+ its load-balance aux loss, summed over the layers in fp32)
  vlm    — every ``cross_attn_every``-th layer cross-attends to image
           embeddings (``batch["image_embeds"]``, from a stub frontend),
           gated by ``tanh(xgate)`` (llama-3.2-vision)
  audio  — whisper: an encoder (bidirectional attention over frame
           embeddings, ``batch["frames"]``, from a stub frontend) and a
           decoder (causal self-attention + cross-attention to the
           encoder's output), sinusoidal positions in both

Layers are grouped into *pattern periods* as in the reference
``repro.models.model``: the params of each position-in-period are stacked
across periods (leaves ``(n_periods, ...)``), and where the reference
consumes the stack with ``lax.scan`` the port walks it with a Python loop
over the same stacked tensors.  Layers that do not fill a whole period
(recurrentgemma: 38 = 12×3 + 2) are applied after the loop, from
``params["rem"]`` / ``cache["rem"]``; a stack shorter than one period
(``xlstm-1.3b.reduced()``: 4 layers, period 8) has zero whole periods
and only those.  The encoder–decoder keeps two stacks of one-layer
periods, ``enc_layers`` and ``layers``.  A pure-SSM stack has no
plannable block: its plans are None, as in the reference.

The serving plan machinery (``PREFILL_BUCKETS``, :func:`bucket_m`,
:func:`serve_plan`) is the reference's, keyed additionally by the device
platform the plan's executors are bound for.

The model stays mesh-agnostic through ``distributed.act_sharding``'s
hooks: ``constrain`` at the reference's activation sites, ``gathered``
where a layer's weights (or the embedding, the head, a norm) are used,
inside the function remat wraps, so that the backward gathers them again
instead of saving them, ``placed`` on every leaf the init draws, and
``tp_split`` where a layer computes a dim the rules may split over
``model``: the embedding and the logits split by vocab, attention and
the MLP Megatron-style (``models.layers``), the MoE experts by expert or
by ``moe_d_ff`` (``models.moe``).  Outside a mesh step each returns its
argument, or None.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import hw
from repro_torch.core.ftl import registry as ftl_registry
from repro_torch.core.ftl.solver import InfeasibleError
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.distributed import act_sharding
from repro_torch.distributed.act_sharding import (constrain, gathered, placed,
                                                  tp_split)
from repro_torch.distributed.collectives import copy_in, reduce_out
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
# self-attention kinds (the ones a BlockPlan can execute)
_SELF_ATTN = {"attn", "local"}
# kinds that keep a decode cache of KV type
_KV_KINDS = _SELF_ATTN | {"cross"}


def _check_supported(cfg) -> None:
    unknown = set(period_kinds(cfg)) - _KV_KINDS - _SELF_NORMED
    if unknown:
        raise NotImplementedError(
            f"{cfg.name!r} ({cfg.family}) has layer kinds "
            f"{sorted(unknown)} the port does not build; it builds "
            f"attention (attn, local window, cross), RG-LRU (rec) and "
            f"xLSTM (mlstm, slstm) layers")


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
        if kind == "cross":
            # llama-3.2's gate on each cross-attention layer, 0 at init
            p["xgate"] = placed(torch.zeros((*lead, 1), dtype=torch.float32,
                                            device=device))
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


def _xgate(p: Params, o: torch.Tensor) -> torch.Tensor:
    """A cross-attention layer's output through its gate, ``tanh(xgate)``
    (fp32) in ``o``'s dtype."""
    return torch.tanh(p["xgate"]).to(o.dtype) * o


def _apply_mixer(cfg, p: Params, kind: str, x: torch.Tensor, *,
                 positions: torch.Tensor, ctx: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """The mixer's residual delta; ``ctx`` is the context a ``cross``
    layer attends to (the image embeddings)."""
    if kind in _SELF_NORMED:
        return MIXERS[kind].block(cfg, p["mix"], x)
    h = norm(p["ln1"], x, cfg.norm)
    if kind == "cross":
        return _xgate(p, attention_layer(cfg, p["attn"], h,
                                         positions=positions, causal=False,
                                         kv_source=ctx, use_rope=False))
    return attention_layer(cfg, p["attn"], h, positions=positions,
                           window=_window(cfg, kind))


def _at(p: Params, at) -> Params:
    """A layer's weights as the compute uses them: ``at`` is (dict path,
    period index or None) of ``p`` in the parameter tree, and under a
    mesh step the leaves come back gathered; ``at`` None leaves ``p``
    as it is."""
    return p if at is None else gathered(p, *at[0], period=at[1])


def _apply_layer(cfg, p: Params, kind: str, x: torch.Tensor, *,
                 positions: torch.Tensor, ctx: torch.Tensor | None = None,
                 plan=None, at=None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Pre-norm residual layer (full sequence): (x, the router's aux loss
    or None, as :func:`_apply_ffn`); ``at`` as :func:`_at`."""
    p = _at(p, at)
    if plan is not None and kind in _SELF_ATTN and "mlp" in p:
        # BlockPlan-driven: projections, attention core and MLP dispatch
        # through their bound executors (registry.run_block)
        return block_layer(cfg, p, x, positions=positions, plan=plan,
                           window=_window(cfg, kind)), None
    x = x + _apply_mixer(cfg, p, kind, x, positions=positions, ctx=ctx)
    x = constrain(x, "residual")
    d, aux = _apply_ffn(cfg, p, x)
    return constrain(x + d, "residual"), aux


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
def _block_plan_cached(cfg, m: int, dtype: str, target, plat: str,
                       autotune=None):
    if cfg.is_moe or cfg.ftl_mode == "off":
        return None
    try:
        return ftl_registry.plan_block(cfg, m=m, dtype=dtype, target=target,
                                       autotune=autotune, device=plat)
    except (ValueError, InfeasibleError):
        return None


def _block_plan(cfg, m: int, dtype: str, target=None, device=None,
                autotune=None):
    """Cached whole-block FTL plan for the forward pass, or None when
    there is nothing to plan (``ftl_mode='off'``, MoE).  ``autotune`` (a
    :class:`repro_torch.tune.AutotuneConfig`) is part of the cache key: a
    DES-tuned plan and the analytic plan for the same shapes never
    alias."""
    target = target if target is not None else hw.default_target()
    return _block_plan_cached(cfg, m, dtype, target,
                              ftl_registry.platform(device), autotune)


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

def _embed(cfg, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embeddings.  Where the rules split the vocab over
    ``model`` each rank looks up its rows, the others' masked to zero,
    and the ranks' lookups are summed."""
    tok = gathered(params["embed"], "embed")["tok"]
    tp = tp_split(("embed", "tok"), (cfg.vocab_size, cfg.d_model), 0)
    if tp is None:
        return tok[tokens]
    n = tok.shape[0]
    local = tokens - tp.rank * n
    mine = (local >= 0) & (local < n)
    x = tok[local.clamp(0, n - 1)]
    return reduce_out(torch.where(mine[..., None], x, 0), tp)


def _sinusoid(seq: int, d: int, offset=0, *,
              device: torch.device | None = None) -> torch.Tensor:
    """Whisper-style sinusoidal positions ``offset + [0, seq)``, computed
    in fp32, never stored: (seq, d) for a scalar ``offset``, (B, seq, d)
    for a ``(B,)`` tensor of offsets (each row at its own)."""
    off = torch.as_tensor(offset, device=device)
    device = off.device
    pos = torch.arange(seq, device=device)
    pos = pos[:, None] + off if off.dim() == 0 else \
        pos[None, :, None] + off[:, None, None]
    div = torch.exp(torch.tensor(-math.log(10000.0), dtype=torch.float32,
                                 device=device)
                    * torch.arange(0, d, 2, device=device) / d)
    ang = pos * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _unembed(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    """The logits; where the rules split the vocab over ``model`` (the
    tied embedding's rows, the head's columns), this rank's slice of
    them (:func:`vocab_split`)."""
    tp = vocab_split(cfg)
    x = copy_in(x, tp)
    if cfg.tie_embeddings:
        logits = x @ gathered(params["embed"], "embed")["tok"].T
    else:
        logits = linear(gathered(params["lm_head"], "lm_head"), x)
    return constrain(logits, "logits")


def vocab_split(cfg):
    """The ``model`` split of the logits' vocab here (``sharding.TP``), or
    None where every rank's logits are whole: outside a mesh step, and
    where the vocab does not divide."""
    if cfg.tie_embeddings:
        return tp_split(("embed", "tok"), (cfg.vocab_size, cfg.d_model), 0)
    return tp_split(("lm_head", "w"), (cfg.d_model, cfg.vocab_size), 1)


def _final_norm(cfg, params: Params, x: torch.Tensor,
                key: str = "final_norm") -> torch.Tensor:
    return norm(gathered(params[key], key), x, cfg.norm)


# ===========================================================================
# public API
# ===========================================================================

def init_params(cfg, generator: torch.Generator | int = 0, *,
                device: torch.device | str | None = None) -> Params:
    """Full parameter tree on ``device`` (None: the CUDA card, and raises
    when there is none).  ``generator`` is a ``torch.Generator`` on that
    device, or an int seed for one; on the ``meta`` device the tree has
    shapes and dtypes only, and the seed is not read."""
    _check_supported(cfg)
    device = resolve_device(device)
    gen = generator
    if device.type == "meta":
        gen = None
    elif not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(generator))
    if cfg.is_encoder_decoder:
        return _init_params_encdec(cfg, gen, device)
    dt = torch_dtype(cfg.dtype)
    kinds, n_full, rem_kinds = _layer_split(cfg)
    params: Params = {
        "embed": _init_embed(cfg, gen, device),
        "layers": _init_stack(cfg, gen, kinds, n_full, device),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dt, device),
    }
    if rem_kinds:
        params["rem"] = {f"rem{i}": _init_layer(cfg, gen, k, device)
                         for i, k in enumerate(rem_kinds)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size,
                                        bias=False, dtype=dt, device=device)
    return params


def param_shapes(cfg) -> Params:
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    allocation (the reference's ``param_shapes``)."""
    return init_params(cfg, device="meta")


def count_params(cfg) -> int:
    return sum(math.prod(t.shape) for t in tree_leaves(param_shapes(cfg)))


def _init_embed(cfg, gen: torch.Generator, device: torch.device) -> Params:
    tok = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                      device=device, dtype=torch.float32)
    return {"tok": placed(tok.mul_(cfg.d_model ** -0.5).to(
        torch_dtype(cfg.dtype)))}


def _layers(cfg, params: Params):
    """(kind, layer params, where) of every layer, in order; ``where`` is
    the layer's (dict path, period index or None), as :func:`_at` takes
    it."""
    kinds, _, rem_kinds = _layer_split(cfg)
    for j, pp in enumerate(_periods(params["layers"])):
        for i, kind in enumerate(kinds):
            yield kind, pp[f"pos{i}"], (("layers", f"pos{i}"), j)
    for i, kind in enumerate(rem_kinds):
        yield kind, params["rem"][f"rem{i}"], (("rem", f"rem{i}"), None)


def _remat(cfg, fn: Callable, *args):
    """``fn(*args)``; under autograd with ``cfg.remat``, keeping only the
    inputs and running ``fn`` again in the backward pass (the reference's
    ``jax.checkpoint`` with ``nothing_saveable`` around each period).
    The recomputation runs under this forward's sharding hooks: the
    backward runs outside their context, on the device's thread."""
    if cfg.remat and torch.is_grad_enabled():
        hooks = act_sharding.current_hooks()
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              hooks()))
    return fn(*args)


def layer_stream(cfg, params: Params, tokens: torch.Tensor, plan=None, *,
                 ctx: torch.Tensor | None = None):
    """The eval forward's residual stream, one layer at a time: yields
    ``(kind, layer params, x_in, x_out, aux)`` for every layer in order,
    from the embedded ``tokens`` (B, S); ``aux`` is the layer's router aux
    loss (fp32; None without a router); ``ctx`` is the image embeddings
    the ``cross`` layers attend to.  ``forward`` is the last ``x_out``
    through the final norm and the unembedding, and the sum of ``aux``
    (decoder-only stacks)."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = constrain(_embed(cfg, params, tokens), "residual")
    for kind, p, at in _layers(cfg, params):
        layer = functools.partial(_apply_layer, cfg, p, kind,
                                  positions=positions, ctx=ctx, plan=plan,
                                  at=at)
        y, aux = _remat(cfg, layer, x)
        yield kind, p, x, y, aux
        x = y


def forward(cfg, params: Params, batch: dict[str, torch.Tensor]
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval forward: ``batch['tokens']`` (B, S) → (logits, aux).  Extra
    inputs: ``image_embeds`` (vlm), ``frames`` (audio)."""
    _check_supported(cfg)
    # the planning target is detected here, outside remat: detecting a
    # card initialises CUDA, which a checkpointed forward refuses
    target = hw.default_target()
    if cfg.is_encoder_decoder:
        return _forward_encdec(cfg, params, batch)
    tokens = batch["tokens"]
    # a whole-block plan is made for whole-layer shapes: under a model
    # axis larger than 1 each layer resolves its executors at its shard's
    plan = None if act_sharding.tp_size() > 1 else _block_plan(
        cfg, tokens.shape[1], cfg.dtype, target, device=tokens.device)
    # the layers' aux summed in fp32 in layer order, as the reference's
    # scan carry sums it
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for _, _, _, x, a in layer_stream(cfg, params, tokens, plan,
                                      ctx=batch.get("image_embeds")):
        if a is not None:
            aux = aux + a
    return _unembed(cfg, params, _final_norm(cfg, params, x)), aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def _layer_prefill(cfg, p: Params, kind: str, x: torch.Tensor, *,
                   positions: torch.Tensor, ctx: torch.Tensor | None = None,
                   max_seq: int | None = None, plan=None,
                   length: int | None = None) -> tuple[torch.Tensor, Params]:
    """Returns (x, cache); the cache holds the state after ``length``
    tokens (None: all of them); a ``cross`` layer's holds the context's
    K and V."""
    if kind in _SELF_NORMED:
        o, cache = MIXERS[kind].block(cfg, p["mix"], x, return_state=True,
                                       length=length)
    elif kind == "cross":
        h = norm(p["ln1"], x, cfg.norm)
        o, cache = attention_prefill(cfg, p["attn"], h, positions=positions,
                                     causal=False, kv_source=ctx,
                                     use_rope=False)
        o = _xgate(p, o)
    else:
        h = norm(p["ln1"], x, cfg.norm)
        o, cache = attention_prefill(cfg, p["attn"], h, positions=positions,
                                     causal=True, window=_window(cfg, kind),
                                     pad_to=max_seq, length=length)
    x = x + o
    return constrain(x + _apply_ffn(cfg, p, x, plan=plan)[0],
                     "residual"), cache


def _layer_decode(cfg, p: Params, kind: str, x: torch.Tensor,
                  cache: Params, pos: torch.Tensor, plan=None
                  ) -> tuple[torch.Tensor, Params]:
    if kind in _SELF_NORMED:
        o, cache = MIXERS[kind].decode(cfg, p["mix"], x, cache)
    else:
        h = norm(p["ln1"], x, cfg.norm)
        o, cache = attention_decode(cfg, p["attn"], h, cache, pos,
                                    window=_window(cfg, kind),
                                    cross=kind == "cross")
        if kind == "cross":
            o = _xgate(p, o)
    x = x + o
    return constrain(x + _apply_ffn(cfg, p, x, plan=plan)[0],
                     "residual"), cache


def _init_layer_cache(cfg, kind: str, batch: int, seq: int,
                      device: torch.device, lead: tuple[int, ...] = ()
                      ) -> Params:
    if kind in _SELF_NORMED:
        return MIXERS[kind].init_state(cfg, batch, device, lead)
    if kind == "cross":         # the context's whole K and V, no window
        seq = cfg.n_image_tokens
    return init_kv_cache(cfg, batch, seq, torch_dtype(cfg.dtype), device,
                         window=_window(cfg, kind), lead=lead)


def init_cache(cfg, batch: int, seq: int, *,
               device: torch.device | str | None = None) -> Params:
    """Zero decode state for a ``seq``-long context, in init_params'
    stack structure (stacked leaves ``(n_periods, batch, ...)``: KV
    ``(…, seq, Hk, Dh)``, a ``cross`` layer's ``(…, n_image_tokens, Hk,
    Dh)``; in fp32 the RG-LRU's ``h`` ``(…, W)`` and ``conv`` ``(…,
    conv_width - 1, W)``, the mLSTM's ``C`` ``(…, H, Dh, Dh)``, ``n``
    ``(…, H, Dh)`` and ``m`` ``(…, H)``, the sLSTM's ``h``, ``c``, ``n``,
    ``m`` ``(…, D)``).  An encoder–decoder's: ``layers/pos0/{self,
    cross}``, ``self`` ``seq`` long and ``cross`` ``encoder_seq``."""
    _check_supported(cfg)
    device = resolve_device(device)
    if cfg.is_encoder_decoder:
        return _init_cache_encdec(cfg, batch, seq, device)
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


def whole_cache_shapes(cfg, cache: Params, n: int) -> Params:
    """``meta`` stand-ins of the whole cache that ``cache`` holds a
    rank's part of: each leaf's batch dim (1 in the stacked ``layers``,
    else 0) ``n`` times longer; a recurrent layer's state at its init's
    widths, whole over ``model`` (a mesh step's mixer returns it on its
    shard), and every other leaf (KV, whose length the prompt and the
    window set) at its own."""
    kinds, _, rem_kinds = _layer_split(cfg)
    kind_of = {**{f"pos{i}": k for i, k in enumerate(kinds)},
               **{f"rem{i}": k for i, k in enumerate(rem_kinds)}}

    def layer(top: str, key: str, c: Params) -> Params:
        bdim = 1 if top == "layers" else 0
        if kind_of.get(key) in _SELF_NORMED:
            t = tree_leaves(c)[0]
            return MIXERS[kind_of[key]].init_state(
                cfg, t.shape[bdim] * n, torch.device("meta"),
                tuple(t.shape[:bdim]))

        def rows(t):
            shape = list(t.shape)
            shape[bdim] *= n
            return torch.empty(shape, dtype=t.dtype, device="meta")

        return tree_map(rows, c)

    return {top: {key: layer(top, key, c) for key, c in sub.items()}
            for top, sub in cache.items()}


def prefill(cfg, params: Params, batch: dict[str, torch.Tensor],
            max_seq: int | None = None, *, plan=None,
            last_pos: int | torch.Tensor | None = None
            ) -> tuple[torch.Tensor, Params]:
    """Process the full prompt; returns (logits at one token, decode
    cache).

    ``max_seq`` right-pads the KV caches so decode steps append in place;
    ``plan`` threads a (bucketed) prefill BlockPlan into every layer's MLP
    dispatch (an encoder–decoder takes none, as in the reference);
    ``last_pos`` returns the logits at that token index instead of the
    final one (bucketed prompts are right-padded), and the recurrent
    state and local-window ring are taken there too: the tokens after it
    are padding.  (The reference takes them at the bucket's end, pads
    included.)  Extra inputs as :func:`forward`'s."""
    _check_supported(cfg)
    if cfg.is_encoder_decoder:
        return _prefill_encdec(cfg, params, batch, max_seq,
                               last_pos=last_pos)
    tokens = batch["tokens"]
    ctx = batch.get("image_embeds")
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    length = None if last_pos is None else int(last_pos) + 1
    kinds, _, rem_kinds = _layer_split(cfg)
    x = constrain(_embed(cfg, params, tokens), "residual")
    per_period: list[Params] = []
    for j, pp in enumerate(_periods(params["layers"])):
        caches = {}
        for i, kind in enumerate(kinds):
            x, caches[f"pos{i}"] = _layer_prefill(
                cfg, _at(pp[f"pos{i}"], (("layers", f"pos{i}"), j)), kind,
                x, positions=positions, ctx=ctx, max_seq=max_seq, plan=plan,
                length=length)
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
                cfg, _at(params["rem"][f"rem{i}"], (("rem", f"rem{i}"), None)),
                kind, x, positions=positions, ctx=ctx, max_seq=max_seq,
                plan=plan, length=length)
    x = _final_norm(cfg, params, _last_tokens(x, last_pos))
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
    and masks at its own position; an encoder–decoder's rows also take
    their sinusoids there, where the reference's are scalar-only);
    ``plan`` threads the m=1 decode BlockPlan into every layer's MLP
    dispatch (an encoder–decoder takes none).  The cache is updated in
    place and returned."""
    _check_supported(cfg)
    if cfg.is_encoder_decoder:
        return _decode_encdec(cfg, params, token, cache, pos)
    kinds, _, rem_kinds = _layer_split(cfg)
    x = constrain(_embed(cfg, params, token), "residual")
    for j, (pp, cc) in enumerate(zip(_periods(params["layers"]),
                                     _periods(cache["layers"]))):
        for i, kind in enumerate(kinds):
            x, _ = _layer_decode(
                cfg, _at(pp[f"pos{i}"], (("layers", f"pos{i}"), j)), kind, x,
                cc[f"pos{i}"], pos, plan=plan)
    for i, kind in enumerate(rem_kinds):
        x, _ = _layer_decode(
            cfg, _at(params["rem"][f"rem{i}"], (("rem", f"rem{i}"), None)),
            kind, x, cache["rem"][f"rem{i}"], pos, plan=plan)
    x = _final_norm(cfg, params, x)
    return _unembed(cfg, params, x), cache


# ===========================================================================
# encoder–decoder (whisper)
# ===========================================================================
#
# The conv frontend is a stub, as in the reference: the inputs are
# precomputed frame embeddings (B, encoder_seq, d_model).  Both stacks take
# sinusoidal positions.  Each stack is one-layer periods (``pos0``), walked
# period by period where the reference scans it.

def _init_dec_layer(cfg, gen: torch.Generator, device: torch.device,
                    lead: tuple[int, ...]) -> Params:
    """Decoder layer: ln1 + self-attention (+ ln2 + MLP), lnx + the
    cross-attention to the encoder's output."""
    p = _init_layer(cfg, gen, "attn", device, lead)
    dt = torch_dtype(cfg.dtype)
    p["lnx"] = init_norm(cfg.d_model, cfg.norm, dt, device, lead)
    p["xattn"] = init_attention(cfg, gen, dt, device, lead)
    return p


def _init_params_encdec(cfg, gen: torch.Generator, device: torch.device
                        ) -> Params:
    dt = torch_dtype(cfg.dtype)
    return {
        "embed": _init_embed(cfg, gen, device),
        "enc_layers": {"pos0": _init_layer(
            cfg, gen, "attn", device, lead=(cfg.n_encoder_layers,))},
        "enc_norm": init_norm(cfg.d_model, cfg.norm, dt, device),
        "layers": {"pos0": _init_dec_layer(cfg, gen, device,
                                           lead=(cfg.n_layers,))},
        "final_norm": init_norm(cfg.d_model, cfg.norm, dt, device),
        "lm_head": init_linear(gen, cfg.d_model, cfg.vocab_size, bias=False,
                               dtype=dt, device=device),
    }


def _enc_layer(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor,
               at=None) -> torch.Tensor:
    p = _at(p, at)
    h = norm(p["ln1"], x, cfg.norm)
    x = x + attention_layer(cfg, p["attn"], h, positions=positions,
                            causal=False, use_rope=False)
    return constrain(x + _apply_ffn(cfg, p, x)[0], "residual")


def _encode(cfg, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, D), stub embeddings → the encoder's output (B, F,
    D)."""
    s = frames.shape[1]
    positions = torch.arange(s, device=frames.device)
    x = frames + _sinusoid(s, cfg.d_model, device=frames.device
                           ).to(frames.dtype)[None]
    x = constrain(x, "residual")
    for j, pp in enumerate(_periods(params["enc_layers"])):
        x = _remat(cfg, functools.partial(
            _enc_layer, cfg, pp["pos0"], positions=positions,
            at=(("enc_layers", "pos0"), j)), x)
    return _final_norm(cfg, params, x, "enc_norm")


def _dec_self(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor
              ) -> torch.Tensor:
    """A decoder layer's self-attention delta (causal, no rope)."""
    return attention_layer(cfg, p["attn"], norm(p["ln1"], x, cfg.norm),
                           positions=positions, causal=True, use_rope=False)


def _dec_cross(cfg, p: Params, x: torch.Tensor, enc_out: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """A decoder layer's cross-attention delta on ``enc_out``."""
    return attention_layer(cfg, p["xattn"], norm(p["lnx"], x, cfg.norm),
                           positions=positions, causal=False,
                           kv_source=enc_out, use_rope=False)


def _dec_layer_full(cfg, p: Params, x: torch.Tensor, enc_out: torch.Tensor,
                    positions: torch.Tensor, at=None) -> torch.Tensor:
    p = _at(p, at)
    x = x + _dec_self(cfg, p, x, positions)
    x = x + _dec_cross(cfg, p, x, enc_out, positions)
    return constrain(x + _apply_ffn(cfg, p, x)[0], "residual")


def _dec_embed(cfg, params: Params, tokens: torch.Tensor, offset=0
               ) -> torch.Tensor:
    """Token embeddings + sinusoids from ``offset`` (a scalar, or one a
    row)."""
    x = _embed(cfg, params, tokens)
    pe = _sinusoid(tokens.shape[1], cfg.d_model, offset, device=x.device)
    return x + pe.to(x.dtype)


def _forward_encdec(cfg, params: Params, batch: dict[str, torch.Tensor]
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    enc_out = _encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = constrain(_dec_embed(cfg, params, tokens), "residual")
    for j, pp in enumerate(_periods(params["layers"])):
        x = _remat(cfg, functools.partial(
            _dec_layer_full, cfg, pp["pos0"], positions=positions,
            at=(("layers", "pos0"), j)), x, enc_out)
    x = _final_norm(cfg, params, x)
    return _unembed(cfg, params, x), torch.zeros(
        (), dtype=torch.float32, device=tokens.device)


def _init_cache_encdec(cfg, batch: int, seq: int, device: torch.device
                       ) -> Params:
    lead = (cfg.n_layers,)
    return {"layers": {"pos0": {
        "self": init_kv_cache(cfg, batch, seq, torch_dtype(cfg.dtype),
                              device, lead=lead),
        "cross": init_kv_cache(cfg, batch, cfg.encoder_seq,
                               torch_dtype(cfg.dtype), device, lead=lead)}}}


def _prefill_encdec(cfg, params: Params, batch: dict[str, torch.Tensor],
                    max_seq: int | None = None, *,
                    last_pos: int | torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, Params]:
    enc_out = _encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = constrain(_dec_embed(cfg, params, tokens), "residual")
    caches = []
    for j, pp in enumerate(_periods(params["layers"])):
        p = _at(pp["pos0"], (("layers", "pos0"), j))
        o, self_c = attention_prefill(
            cfg, p["attn"], norm(p["ln1"], x, cfg.norm), positions=positions,
            causal=True, use_rope=False, pad_to=max_seq)
        x = x + o
        o, cross_c = attention_prefill(
            cfg, p["xattn"], norm(p["lnx"], x, cfg.norm),
            positions=positions, kv_source=enc_out, use_rope=False)
        x = x + o
        x = constrain(x + _apply_ffn(cfg, p, x)[0], "residual")
        caches.append({"self": self_c, "cross": cross_c})
    cache = {"layers": {"pos0": tree_map(lambda *ts: torch.stack(ts),
                                         *caches)}}
    x = _final_norm(cfg, params, _last_tokens(x, last_pos))
    return _unembed(cfg, params, x), cache


def _decode_encdec(cfg, params: Params, token: torch.Tensor, cache: Params,
                   pos: torch.Tensor) -> tuple[torch.Tensor, Params]:
    pos = torch.as_tensor(pos, device=token.device)
    x = _dec_embed(cfg, params, token, pos)
    for j, (pp, cc) in enumerate(zip(_periods(params["layers"]),
                                     _periods(cache["layers"]))):
        p, c = _at(pp["pos0"], (("layers", "pos0"), j)), cc["pos0"]
        o, _ = attention_decode(cfg, p["attn"], norm(p["ln1"], x, cfg.norm),
                                c["self"], pos, use_rope=False)
        x = x + o
        o, _ = attention_decode(cfg, p["xattn"],
                                norm(p["lnx"], x, cfg.norm), c["cross"],
                                pos, cross=True)
        x = x + o
        x = x + _apply_ffn(cfg, p, x)[0]
    x = _final_norm(cfg, params, x)
    return _unembed(cfg, params, x), cache
