"""Plan-driven execution of a whole transformer block.

:func:`run_block` is the runtime counterpart of ``registry.plan_block``:
it walks the planned segments in chain order and dispatches each one to
its bound executor — the GEMM executors for the QKV/output projections,
flash attention for the attention core, and the fused/partial/scan MLP
executors for the MLP — stitching the pre-norm residual structure (norms
+ residual adds) between segments exactly like the hand-sequenced
``models/layers.py`` path.

Fallback contract, as in the reference: every binding is *requalified*
at run time against the activation's platform and shapes.  A plan made
for the card runs unchanged on CPU tensors because each disqualified
binding falls back, per segment, to the highest-priority executor that
does qualify.  This is a choice of executor by device and shape made
before anything runs — never a retry after a kernel fails.  On the card,
though, a prefill plan under ``'auto'`` is the kernels' plan: a stage
that would run a plain PyTorch executor on a CUDA tensor (a gated MLP
planned ``partial``, which the gate-less partial kernels cannot take, or
a binding whose kernel no longer qualifies) raises instead
(:func:`_stage_executor`); :func:`resolved_executors` reports it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch import obs

from . import registry

_C_REQUALIFIED = obs.counter(
    "ftl_requalified_total",
    "bindings rebound at run time (plan executor no longer qualified)",
    ("kind",))
_C_TORCH_FALLBACK = obs.counter(
    "ftl_torch_fallback_total",
    "runtime rebinds that landed on a plain PyTorch executor", ("kind",))


def _runtime_ctx(plan: registry.BlockPlan, kind: str, schedule: str, m: int,
                 dtype: str, plat: str) -> registry.ExecContext:
    cfg = plan.cfg
    return registry.ExecContext(
        kind=kind,
        platform=plat,
        schedule=schedule,
        m=m,
        d_model=cfg.d_model,
        d_ff=cfg.moe_d_ff if cfg.is_moe else cfg.d_ff,
        dtype=dtype,
        gated=cfg.mlp_gated,
        act=cfg.mlp_act,
        target=plan.target,
        head_dim=cfg.resolved_head_dim,
        # requalification keeps the plan's regime
        phase=plan.phase,
    )


def _sub_schedule(plan: registry.BlockPlan, kind: str) -> str:
    if kind == "attention":
        sched = plan.attention_schedule
    elif kind == "mlp":
        sched = plan.mlp_schedule
    else:
        sched = plan.schedule
    if sched == "none":
        # no ops of this kind in the plan: attention is always executable
        # fused (flash streams KV); the MLP falls back to the baseline
        return "fused" if kind == "attention" else "unfused"
    return sched


def _stage_executor(plan: registry.BlockPlan, kind: str,
                    ctx: registry.ExecContext, mode: str,
                    strict: bool = True) -> registry.Executor:
    """The plan's bound executor for ``kind``, or the runtime rebind.

    ``strict``: on the card, in a prefill plan under ``'auto'``, a stage
    that lands on a plain PyTorch executor raises (a report passes
    ``strict=False`` and names that executor)."""
    bound = None
    ex = None
    for b in plan.bindings:
        if b.kind == kind:
            bound = b.executor
            if registry.get(bound).qualifies(ctx):
                ex = registry.get(bound)
            break
    if ex is None:
        ex = registry.find(kind, ctx)
        if bound is not None and ex.name != bound:
            _C_REQUALIFIED.labels(kind=kind).inc()
            if ex.backend == "torch":
                _C_TORCH_FALLBACK.labels(kind=kind).inc()
    if (strict and mode == "auto" and ctx.platform == "cuda"
            and ctx.phase == "prefill" and ex.backend == "torch"):
        raise ValueError(
            f"the {plan.target.name} prefill plan has no CUDA executor for "
            f"its {kind} stage (schedule {ctx.schedule}, m={ctx.m}, "
            f"planned {bound}): {ex.name} is plain PyTorch"
            + ("; the partial-MLP kernels take no gate, run a gated MLP "
               "with ftl_mode='fused'" if kind == "mlp" and ctx.gated
               and ctx.schedule == "partial" else ""))
    return ex


def _bind_target(ex: registry.Executor, target) -> registry.Executor:
    """Pin the executor to the plan's own target."""
    return dataclasses.replace(ex, run=functools.partial(ex.run,
                                                         target=target))


def _resolve_gemm(plan, mode, m, dtype, plat=None,
                  strict=True) -> registry.Executor:
    if mode == "off":
        return _bind_target(registry.get("torch_gemm"), plan.target)
    ctx = _runtime_ctx(plan, "gemm", plan.schedule, m, dtype,
                       plat or plan.platform)
    return _bind_target(_stage_executor(plan, "gemm", ctx, mode, strict),
                        plan.target)


def _resolve_attention(plan, mode, m, dtype, plat=None,
                       strict=True) -> registry.Executor:
    plat = plat or plan.platform
    if mode == "off":
        # the baseline attention path is the platform's default attention
        # kernel: exactly what a 'fused' qualification resolves to
        ctx = _runtime_ctx(plan, "attention", "fused", m, dtype, plat)
        return _bind_target(registry.find("attention", ctx), plan.target)
    ctx = _runtime_ctx(plan, "attention", _sub_schedule(plan, "attention"),
                       m, dtype, plat)
    return _bind_target(_stage_executor(plan, "attention", ctx, mode,
                                        strict), plan.target)


def _resolve_mlp(plan, mode, m, dtype, *, d_model=None, d_ff=None,
                 gated=None, plat=None, strict=True) -> registry.Executor:
    cfg = plan.cfg
    plat = plat or plan.platform
    if mode in ("off", "fused", "scan"):
        # explicit override modes keep their meaning; the plan stays
        # authoritative only for 'auto'
        return registry.mlp_executor(
            mode, m=m,
            d_model=cfg.d_model if d_model is None else d_model,
            d_ff=(cfg.moe_d_ff if cfg.is_moe else cfg.d_ff)
            if d_ff is None else d_ff,
            dtype=dtype,
            gated=cfg.mlp_gated if gated is None else gated,
            act=cfg.mlp_act, target=plan.target, device=plat)
    ctx = _runtime_ctx(plan, "mlp", _sub_schedule(plan, "mlp"), m, dtype,
                       plat)
    return _bind_target(_stage_executor(plan, "mlp", ctx, mode, strict),
                        plan.target)


# public names for the per-stage resolvers: the serving path
# (models.layers.mlp_layer with plan=) dispatches its MLP through the
# plan's binding exactly as run_block would
resolve_mlp = _resolve_mlp
resolve_attention = _resolve_attention
resolve_gemm = _resolve_gemm


def resolved_executors(plan: registry.BlockPlan, *, m: int | None = None,
                       dtype: str | None = None,
                       ftl_mode: str | None = None) -> dict[str, str]:
    """Executor names :func:`run_block` would dispatch to right now, on
    the plan's platform at shape ``m``/``dtype`` (default: the planned
    ones) under ``ftl_mode`` (default ``cfg.ftl_mode``), without executing
    anything."""
    m = m if m is not None else plan.m
    dtype = dtype or plan.dtype
    mode = ftl_mode if ftl_mode is not None else plan.cfg.ftl_mode
    return {
        "gemm": _resolve_gemm(plan, mode, m, dtype, strict=False).name,
        "attention": _resolve_attention(plan, mode, m, dtype,
                                        strict=False).name,
        "mlp": _resolve_mlp(plan, mode, m, dtype, strict=False).name,
    }


def _project(ex: registry.Executor, x, p: dict[str, Any]):
    """One planned projection GEMM (``linear`` routed through a binding)."""
    w = p["w"]
    if ex.backend == "cuda":
        # the GEMM kernel is 2-D; flatten leading dims around it
        *lead, k = x.shape
        y = ex.run(x.reshape(-1, k).contiguous(), w).reshape(*lead,
                                                              w.shape[1])
    else:
        y = ex.run(x, w)
    if "b" in p:
        y = y + p["b"]
    return y


def run_block(
    plan: registry.BlockPlan,
    params: dict[str, Any],
    x: torch.Tensor,  # (B, S, D)
    *,
    positions: torch.Tensor | None = None,  # (S,) — defaults to arange(S)
    causal: bool = True,
    window: int | None = None,
    use_rope: bool = True,
    ftl_mode: str | None = None,  # overrides plan.cfg.ftl_mode
) -> torch.Tensor:
    """Execute one pre-norm transformer block per its :class:`BlockPlan`.

    ``params`` is one layer's parameter dict (``ln1``/``attn``/``ln2``/
    ``mlp``).  ``cfg.ftl_mode`` (overridable per call) keeps its meaning:
    ``'off'`` pins the baseline executors, ``'fused'``/``'scan'`` force
    that MLP executor, ``'auto'`` makes the plan's bindings
    authoritative (on the card a prefill stage without a CUDA executor
    raises: :func:`_stage_executor`)."""
    from repro_torch.models import layers as L  # lazy: no cycle

    cfg = plan.cfg
    b, s, _ = x.shape
    dtype = registry.dtype_name(x.dtype)
    plat = x.device.type
    mode = ftl_mode if ftl_mode is not None else cfg.ftl_mode

    if "attn" in params:
        nh, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        if positions is None:
            positions = torch.arange(s, device=x.device)
        gemm_ex = _resolve_gemm(plan, mode, s, dtype, plat)
        attn_ex = _resolve_attention(plan, mode, s, dtype, plat)
        with obs.span(f"seg:attn:{attn_ex.name}", "exec"):
            ap = params["attn"]
            h = L.norm(params["ln1"], x, cfg.norm)
            q = L._split_heads(_project(gemm_ex, h, ap["wq"]), nh)
            k = L._split_heads(_project(gemm_ex, h, ap["wk"]), hk)
            v = L._split_heads(_project(gemm_ex, h, ap["wv"]), hk)
            if use_rope:
                q = L.rope(q, positions, cfg.rope_theta)
                k = L.rope(k, positions, cfg.rope_theta)
            o = attn_ex.run(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window)
            o = o.transpose(1, 2).reshape(b, s, nh * dh)
            x = x + _project(gemm_ex, o, ap["wo"])

    if "mlp" in params:
        mp = params["mlp"]
        w1, w2 = mp["w1"]["w"], mp["w2"]["w"]
        wg = mp.get("wg", {}).get("w")
        mlp_ex = _resolve_mlp(plan, mode, s, dtype, d_model=w1.shape[0],
                              d_ff=w1.shape[1], gated=wg is not None,
                              plat=plat)
        with obs.span(f"seg:mlp:{mlp_ex.name}", "exec"):
            h = L.norm(params["ln2"], x, cfg.norm)
            y = mlp_ex.run(h, w1, w2, wg, mp["w1"].get("b"),
                           mp["w2"].get("b"), act=cfg.mlp_act)
            x = x + y

    return x
