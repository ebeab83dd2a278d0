"""Executor registry: planned fusion groups → concrete implementations.

The planner (graph → partition) decides *what* to fuse; this module
decides *who runs it*.  Every executor advertises the pattern it
implements (``kind``), its backend, and a qualification predicate over an
:class:`ExecContext`; ``find`` returns the highest-priority qualifying
executor.  Consumers get two entry points:

* :func:`plan_block` — plan a whole transformer block for a config and
  bind every planned segment to an executor.
* :func:`mlp_executor` — resolve an MLP execution callable for a given
  ``ftl_mode``; ``'auto'`` is plan-driven.

The port's executors: ``cuda_gemm``, ``cuda_flash_attention``,
``cuda_fused_mlp`` and ``cuda_partial_mlp`` (``gemm_act`` then ``gemm``)
run the hand-written Hopper kernels and qualify on the
``'cuda'`` platform when the kernel's own shared-memory footprint fits
the plan target's fast level (the reference's 4 MiB VMEM-class floor would
rule out every Hopper kernel); the ``torch_*`` executors are the portable
PyTorch paths.  Decode-phase plans never bind the kernels, as in the
reference.  Kernel imports are lazy so planning imports no kernel code.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Callable, Mapping

import torch

from repro_torch import obs
from repro_torch.core import hw as hwlib

from . import executor_xla, graph, partition
from .partition import ChainPlan
from .solver import InfeasibleError, solve

_C_PLAN_BLOCK = obs.counter(
    "ftl_plan_block_total", "plan_block calls", ("phase",))


# ---------------------------------------------------------------------------
# registry core
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecContext:
    """Everything an executor needs to decide whether it qualifies."""

    kind: str                    # 'mlp' | 'attention' | 'gemm'
    platform: str                # 'cuda' | 'cpu'
    schedule: str                # 'fused' | 'partial' | 'unfused'
    m: int = 0
    d_model: int = 0
    d_ff: int = 0
    dtype: str = "bfloat16"
    gated: bool = False
    act: str = "gelu"
    target: hwlib.Target | None = None   # the plan's memory hierarchy
    head_dim: int = 0            # attention kernels' footprint probe
    # 'prefill' (full-sequence) vs 'decode' (m=1 against a cache); decode
    # shapes never bind the kernels (decode-shape qualification)
    phase: str = "prefill"


def dtype_name(dtype) -> str:
    """'bfloat16' for ``torch.bfloat16`` (the planner's dtype names)."""
    return str(dtype).removeprefix("torch.")


def _mlp_kernel_fits(c: ExecContext) -> bool:
    """The fused-MLP kernel takes bf16, K and N multiples of 8 and F a
    multiple of its 64-wide slice lattice, and needs some schedule whose
    shared-memory footprint (the hidden slice and a ring of at least two
    slots) fits the target's fast level."""
    from repro_torch.kernels import fused_mlp

    if c.dtype != "bfloat16":
        return False
    if c.target is None:
        return True
    cap = c.target.fast.capacity_bytes
    if not c.d_ff:
        return fused_mlp.min_smem_bytes(c.gated) <= cap
    return (c.d_model % 8 == 0 and c.d_ff % fused_mlp.F_ALIGN == 0
            and bool(fused_mlp.block_f_choices(
                c.d_ff, fused_mlp.BLOCK_M[0], c.gated, cap)))


def _attention_kernel_fits(c: ExecContext) -> bool:
    """Flash kernel: bf16, a head dim it is built for, and the largest
    block its schedule can pick (Q tile plus K/V ring) within the target's
    fast level."""
    from repro_torch.kernels import flash_attention

    if c.dtype != "bfloat16":
        return False
    if c.head_dim and c.head_dim not in flash_attention.HEAD_DIMS:
        return False
    if c.target is None:
        return True
    return flash_attention.smem_bytes(c.head_dim or 128) \
        <= c.target.fast.capacity_bytes


def _gemm_kernel_fits(c: ExecContext) -> bool:
    from repro_torch.kernels import gemm

    if c.dtype != "bfloat16":
        return False
    return c.target is None \
        or gemm.SMEM_BYTES <= c.target.fast.capacity_bytes


@dataclasses.dataclass(frozen=True)
class Executor:
    """A registered implementation of one planned-group pattern."""

    name: str
    kind: str
    backend: str                 # 'cuda' | 'torch'
    priority: int
    qualifies: Callable[[ExecContext], bool]
    run: Callable | None = None


_REGISTRY: dict[str, Executor] = {}


def register(ex: Executor, *, override: bool = False) -> Executor:
    if ex.name in _REGISTRY and not override:
        raise ValueError(f"executor {ex.name!r} already registered")
    _REGISTRY[ex.name] = ex
    return ex


def get(name: str) -> Executor:
    return _REGISTRY[name]


def executors(kind: str | None = None) -> list[Executor]:
    exs = [e for e in _REGISTRY.values() if kind is None or e.kind == kind]
    return sorted(exs, key=lambda e: -e.priority)


def find(kind: str, ctx: ExecContext) -> Executor:
    """Highest-priority executor of ``kind`` that qualifies for ``ctx``.

    Raises :class:`LookupError` spelling out the full qualification
    context and every executor that was considered."""
    considered = executors(kind)
    for ex in considered:
        if ex.qualifies(ctx):
            return ex
    fields = ", ".join(
        f"{f.name}={getattr(ctx, f.name)!r}"
        for f in dataclasses.fields(ctx)
    )
    tried = ", ".join(
        f"{e.name} (backend={e.backend}, priority={e.priority})"
        for e in considered
    ) or "<none registered for this kind>"
    raise LookupError(
        f"no executor of kind={kind!r} qualifies for "
        f"ExecContext({fields}); considered in priority order: {tried}"
    )


def platform(device: torch.device | str | None = None) -> str:
    """``'cuda'`` or ``'cpu'``: the type of ``device``; None means the
    process's default device for the port (a CUDA device when there is
    one)."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


# ---------------------------------------------------------------------------
# built-in executors
# ---------------------------------------------------------------------------

def _run_cuda_fused_mlp(x, w1, w2, wg, b1, b2, *, act, target=None):
    from repro_torch.kernels import ops
    return ops.fused_mlp(x, w1, w2, wg, b1, b2, act=act, backend="auto",
                         target=target)


def _run_cuda_partial_mlp(x, w1, w2, wg, b1, b2, *, act, target=None):
    """Partial schedule on the kernels: ``gemm_act`` for the up projection
    (bias and activation in its epilogue), the hidden tensor written once
    in ``x.dtype``, ``gemm`` for the down projection, ``b2`` added in
    ``x.dtype``.  Ungated MLPs only, as in the reference."""
    from repro_torch.kernels import ops
    if wg is not None:
        raise ValueError("the partial-MLP kernels take no gate")
    *lead, m, k = x.shape
    xf = x.reshape(-1, k).contiguous()
    h = ops.gemm_act(xf, w1, b1, act=act)
    y = ops.gemm(h, w2)
    if b2 is not None:
        y = y + b2
    return y.reshape(*lead, m, w2.shape[1])


@functools.lru_cache(maxsize=512)
def _scan_tile(m: int, d_model: int, d_ff: int, dtype: str, gated: bool,
               act: str, target: hwlib.Target) -> int:
    """Token tile of the loop executor from its own kernel policy: it
    tiles M only, so K/F/N stay whole and the solver picks the largest M
    tile that fits the target's fast level.  Falls back to a power-of-two
    divisor when even the smallest tile does not fit."""
    g = graph.mlp_graph(m=m, d_model=d_model, d_ff=d_ff, dtype=dtype,
                        gated=gated, act=act)
    try:
        plan = solve(g.group(0, g.n_ops), target=target,
                     whole_dims=frozenset({"K", "F", "N"}))
        return plan.tile("M")
    except InfeasibleError:
        for cand in (1024, 512, 256, 128):
            if m % cand == 0 and cand < m:
                return cand
        return m


def _tile_for(x, w1, wg, act, target) -> int:
    return _scan_tile(x.shape[-2], w1.shape[0], w1.shape[1],
                      dtype_name(x.dtype), wg is not None, act,
                      target if target is not None
                      else hwlib.default_target())


def _run_torch_scan_mlp(x, w1, w2, wg, b1, b2, *, act, target=None):
    return executor_xla.mlp_scan(x, w1, w2, wg, b1, b2, act=act,
                                 tile_m=_tile_for(x, w1, wg, act, target))


def _run_torch_partial_mlp(x, w1, w2, wg, b1, b2, *, act, target=None):
    return executor_xla.mlp_partial_scan(
        x, w1, w2, wg, b1, b2, act=act,
        tile_m=_tile_for(x, w1, wg, act, target))


def _run_torch_unfused_mlp(x, w1, w2, wg, b1, b2, *, act, target=None):
    from repro_torch.kernels import ref
    h = x @ w1
    if b1 is not None:
        h = h + b1
    h = ref.act_fn(act)(h.float()).to(x.dtype)
    if wg is not None:
        h = h * (x @ wg)
    y = h @ w2
    if b2 is not None:
        y = y + b2
    return y


def _run_cuda_attention(q, k, v, *, target=None, **kw):
    from repro_torch.kernels import ops
    return ops.attention(q, k, v, backend="auto", **kw)


def _run_ref_attention(q, k, v, *, target=None, **kw):
    from repro_torch.kernels import ops
    return ops.attention(q, k, v, backend="ref", **kw)


def _run_cuda_gemm(x, w, *, target=None):
    from repro_torch.kernels import ops
    return ops.gemm(x, w, backend="auto")


def _run_torch_gemm(x, w, *, target=None):
    return x @ w


register(Executor(
    name="cuda_fused_mlp", kind="mlp", backend="cuda", priority=100,
    qualifies=lambda c: (c.platform == "cuda" and c.schedule == "fused"
                         and c.phase != "decode" and _mlp_kernel_fits(c)),
    run=_run_cuda_fused_mlp))
# gemm_act runs gemm's tile loop (csrc/gemm_tile.cuh): one footprint
register(Executor(
    name="cuda_partial_mlp", kind="mlp", backend="cuda", priority=90,
    qualifies=lambda c: (c.platform == "cuda" and c.schedule == "partial"
                         and c.phase != "decode" and not c.gated
                         and _gemm_kernel_fits(c)),
    run=_run_cuda_partial_mlp))
register(Executor(
    name="torch_scan_mlp", kind="mlp", backend="torch", priority=50,
    qualifies=lambda c: c.schedule == "fused",
    run=_run_torch_scan_mlp))
register(Executor(
    name="torch_partial_scan_mlp", kind="mlp", backend="torch", priority=40,
    qualifies=lambda c: c.schedule == "partial",
    run=_run_torch_partial_mlp))
register(Executor(
    name="torch_unfused_mlp", kind="mlp", backend="torch", priority=10,
    qualifies=lambda c: True,
    run=_run_torch_unfused_mlp))
register(Executor(
    name="cuda_flash_attention", kind="attention", backend="cuda",
    priority=100,
    qualifies=lambda c: (c.platform == "cuda" and c.schedule != "unfused"
                         and c.phase != "decode"
                         and _attention_kernel_fits(c)),
    run=_run_cuda_attention))
register(Executor(
    name="torch_ref_attention", kind="attention", backend="torch",
    priority=10,
    qualifies=lambda c: True,
    run=_run_ref_attention))
register(Executor(
    name="cuda_gemm", kind="gemm", backend="cuda", priority=100,
    qualifies=lambda c: (c.platform == "cuda" and c.phase != "decode"
                         and _gemm_kernel_fits(c)),
    run=_run_cuda_gemm))
register(Executor(
    name="torch_gemm", kind="gemm", backend="torch", priority=10,
    qualifies=lambda c: True,
    run=_run_torch_gemm))


# ---------------------------------------------------------------------------
# block-level planning: the one API every consumer goes through
# ---------------------------------------------------------------------------

def _segment_kind(seg: partition.Segment) -> str:
    names = seg.op_names()
    if any(n.startswith("attn.") for n in names):
        return "attention"
    if any(n.startswith("mlp.") or n.startswith("gemm") for n in names):
        return "mlp" if any(n.startswith("mlp.") for n in names) else "gemm"
    return "gemm"


@dataclasses.dataclass(frozen=True)
class GroupBinding:
    segment: partition.Segment
    kind: str
    executor: str


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A planned transformer block with per-segment executor bindings.

    Carries the config, planning shape, platform and memory-hierarchy
    target it was made for so :func:`run_block` can execute it (and
    requalify bindings) without any side-channel state."""

    chain: ChainPlan
    bindings: tuple[GroupBinding, ...]
    platform: str
    cfg: object = None
    m: int = 0
    dtype: str = ""
    # serving regime the plan was made for: 'prefill' or 'decode'
    phase: str = "prefill"

    @property
    def target(self) -> hwlib.Target:
        return self.chain.target

    @property
    def graph(self) -> graph.OpGraph:
        return self.chain.graph

    @property
    def schedule(self) -> str:
        return self.chain.schedule

    @property
    def traffic_bytes(self) -> int:
        return self.chain.traffic_bytes

    @property
    def per_level_traffic(self) -> dict[str, int]:
        return self.chain.per_level_traffic

    def _sub_schedule(self, prefix: str) -> str:
        ops = [op.name for op in self.graph.ops
               if op.name.startswith(prefix)]
        segs = [s for s in self.chain.segments
                if any(n.startswith(prefix) for n in s.op_names())]
        if not ops or not segs:
            return "none"
        if len(segs) == 1:
            return "fused"
        if len(segs) == len(ops):
            return "unfused"
        return "partial"

    @property
    def mlp_schedule(self) -> str:
        return self._sub_schedule("mlp.")

    @property
    def attention_schedule(self) -> str:
        return self._sub_schedule("attn.")

    def summary(self) -> str:
        lines = [self.chain.summary(),
                 f"  executors ({self.platform}, planned for "
                 f"{self.target.name}):"]
        for b in self.bindings:
            lines.append(
                f"    [{b.segment.lo}:{b.segment.hi}] {b.kind:9s} -> "
                f"{b.executor}"
            )
        return "\n".join(lines)


def _freeze(d: Mapping[str, int] | None):
    return tuple(sorted(d.items())) if d else None


@functools.lru_cache(maxsize=128)
def _plan_block_cached(cfg, m: int, dtype: str | None,
                       target: hwlib.Target, sharded: tuple | None,
                       plat: str, residual: bool,
                       phase: str = "prefill") -> BlockPlan:
    g = graph.block_graph(cfg, m=m, dtype=dtype, residual=residual)
    chain = partition.plan_chain(g, target=target,
                                 sharded_sizes=dict(sharded) if sharded
                                 else None)
    shell = BlockPlan(chain=chain, bindings=(), platform=plat, cfg=cfg,
                      m=m, dtype=dtype or cfg.dtype, phase=phase)
    sub = {"mlp": shell.mlp_schedule, "attention": shell.attention_schedule}
    bindings = []
    for seg in chain.segments:
        kind = _segment_kind(seg)
        # qualification uses the sub-chain's own fusion state: a split
        # attention core must not bind to the flash kernel, etc.
        sched = sub.get(kind, chain.schedule)
        sched = chain.schedule if sched == "none" else sched
        ctx = ExecContext(
            kind=kind, platform=plat, schedule=sched,
            m=m, d_model=cfg.d_model,
            d_ff=cfg.moe_d_ff if cfg.is_moe else cfg.d_ff,
            dtype=dtype or cfg.dtype, gated=cfg.mlp_gated, act=cfg.mlp_act,
            target=target, head_dim=cfg.resolved_head_dim, phase=phase)
        bindings.append(GroupBinding(segment=seg, kind=kind,
                                     executor=find(kind, ctx).name))
    return BlockPlan(chain=chain, bindings=tuple(bindings), platform=plat,
                     cfg=cfg, m=m, dtype=dtype or cfg.dtype, phase=phase)


def plan_block(
    cfg,
    *,
    m: int,
    dtype: str | None = None,
    target: hwlib.Target | None = None,
    sharded_sizes: Mapping[str, int] | None = None,
    residual: bool = True,
    phase: str = "prefill",
    device: torch.device | str | None = None,
) -> BlockPlan:
    """Plan one transformer block of ``cfg`` at ``m`` tokens on ``target``
    (None → the default target) and bind every planned fusion group to the
    best qualifying executor for ``device``'s platform (None → a CUDA
    device when there is one).

    ``phase`` ('prefill' | 'decode') runs the same partition DP at the
    regime's own shape; decode plans never bind the kernels.  Phase is
    part of the plan-cache key."""
    if phase not in ("prefill", "decode"):
        raise ValueError(f"phase must be 'prefill' or 'decode', "
                         f"got {phase!r}")
    target = target if target is not None else hwlib.default_target()
    _C_PLAN_BLOCK.labels(phase=phase).inc()
    with obs.span(f"plan_block:{phase}", "planner"):
        return _plan_block_cached(cfg, m, dtype, target,
                                  _freeze(sharded_sizes), platform(device),
                                  residual, phase)


# ---------------------------------------------------------------------------
# MLP mode resolution for models/layers.py
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1024)
def _mlp_executor_cached(mode: str, m: int, d_model: int, d_ff: int,
                         dtype: str, gated: bool, act: str,
                         target: hwlib.Target, plat: str) -> Executor:
    if mode == "off":
        ex = get("torch_unfused_mlp")
    elif mode == "fused":
        # explicit request for the fused-MLP kernel (its plain version
        # for CPU tensors)
        ex = get("cuda_fused_mlp")
    elif mode == "scan":
        ex = get("torch_scan_mlp")
    elif mode == "auto":
        g = graph.mlp_graph(m=m, d_model=d_model, d_ff=d_ff, dtype=dtype,
                            gated=gated, act=act)
        try:
            schedule = partition.plan_chain(g, target=target).schedule
        except InfeasibleError:
            schedule = "unfused"
        ctx = ExecContext(kind="mlp", platform=plat, schedule=schedule,
                          m=m, d_model=d_model, d_ff=d_ff, dtype=dtype,
                          gated=gated, act=act, target=target)
        ex = find("mlp", ctx)
    else:
        raise ValueError(f"unknown ftl_mode {mode!r}")
    # run under the target the schedule was resolved with, not whatever
    # the process default happens to be at run time
    return dataclasses.replace(
        ex, run=functools.partial(ex.run, target=target))


def mlp_executor(
    mode: str,
    *,
    m: int,
    d_model: int,
    d_ff: int,
    dtype: str,
    gated: bool,
    act: str,
    target: hwlib.Target | None = None,
    device: torch.device | str | None = None,
) -> Executor:
    """Resolve the MLP executor for ``ftl_mode`` at the given shapes on
    ``target`` (None → the default target) for ``device``'s platform."""
    target = target if target is not None else hwlib.default_target()
    return _mlp_executor_cached(mode, m, d_model, d_ff, dtype, gated, act,
                                target, platform(device))


# ---------------------------------------------------------------------------
# planner-cache registry: one ledger over every memoized planning entry
# ---------------------------------------------------------------------------

_PLAN_CACHES: dict[str, Callable] = {}
# stat keepers (ServeEngine and its plan cache) reset with the caches
_COUNTER_RESETS: "weakref.WeakSet" = weakref.WeakSet()


def register_counter_reset(obj):
    """Enroll an object exposing ``reset_counters()`` to be reset
    whenever :func:`clear_plan_caches` drops the caches.  Held weakly;
    returns ``obj``."""
    _COUNTER_RESETS.add(obj)
    return obj


def register_plan_cache(name: str, fn: Callable) -> Callable:
    """Enroll an ``lru_cache``-wrapped planner in the plan-cache ledger."""
    _PLAN_CACHES[name] = fn
    return fn


def plan_cache_stats() -> dict[str, dict[str, int]]:
    """Hit/miss/size counters of every registered planner cache."""
    return {
        name: {
            "hits": info.hits,
            "misses": info.misses,
            "size": info.currsize,
            "maxsize": info.maxsize,
        }
        for name, fn in sorted(_PLAN_CACHES.items())
        for info in (fn.cache_info(),)
    }


def clear_plan_caches() -> None:
    """Drop every registered planner cache and reset every registered
    stat keeper's counters."""
    for fn in _PLAN_CACHES.values():
        fn.cache_clear()
    for obj in list(_COUNTER_RESETS):
        obj.reset_counters()


for _fn in (_scan_tile, _plan_block_cached, _mlp_executor_cached):
    register_plan_cache(f"registry.{_fn.__name__}", _fn)
for _fn in (partition._plan_chain_cached, partition._plan_chain_top_k_cached):
    register_plan_cache(f"partition.{_fn.__name__}", _fn)
del _fn


def _collect_plan_caches(reg) -> None:
    """The plan-cache ledger re-read as gauges at scrape time."""
    g_hits = reg.gauge("ftl_plan_cache_hits",
                       "plan-cache hits (ledger snapshot)", ("cache",))
    g_miss = reg.gauge("ftl_plan_cache_misses",
                       "plan-cache misses (ledger snapshot)", ("cache",))
    g_size = reg.gauge("ftl_plan_cache_size",
                       "plan-cache entries (ledger snapshot)", ("cache",))
    for name, row in plan_cache_stats().items():
        g_hits.labels(cache=name).set(row["hits"])
        g_miss.labels(cache=name).set(row["misses"])
        g_size.labels(cache=name).set(row["size"])


obs.register_collector(_collect_plan_caches)


# ---------------------------------------------------------------------------
# block execution: walk the plan, dispatch every segment
# ---------------------------------------------------------------------------

def run_block(plan: BlockPlan, params, x, **kwargs):
    """Execute one transformer block through its :class:`BlockPlan`
    (see :mod:`repro_torch.core.ftl.executor_block`)."""
    from . import executor_block  # lazy: keeps planning importable alone
    return executor_block.run_block(plan, params, x, **kwargs)
