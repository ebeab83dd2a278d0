"""Fusion-partition optimization over an op chain (beyond-paper step 3½).

The paper fuses one manually chosen pair of layers; the seed generalized
that to a three-way MLP choice (fused / partial / unfused).  This module
subsumes both: given an :class:`~repro_torch.core.ftl.graph.OpGraph`, it
enumerates every *contiguous partition* of the chain (LoopTree-style), has
the branch-and-bound tile solver price each candidate segment on the
planning :class:`~repro_torch.core.hw.Target`, and runs a dynamic program over
cut points to pick the globally runtime-minimal schedule.

For an ``n``-op chain there are ``2^(n-1)`` partitions but only
``n·(n+1)/2`` distinct segments, so the DP solves each segment once and
composes:

    best[i] = min over j < i of  best[j] + cost(segment ops[j:i])

Segments that violate a barrier (head-split reshape, repeat change) or
whose tiling problem is infeasible on the target are skipped.  The cost
of a segment is its solved modeled *roofline runtime* —
``max(compute_time, transfer_time)``, compute from ``Target.flops``,
transfer per-level bytes/bw + transfers·dma_setup — times its
multiplicity (per-head segments run once per head), with (traffic, DMA
count, segment count) as the tie-break.  The tie-break is load-bearing:
fusing a compute-bound segment buys no runtime, so the DP only keeps a
fusion there when it also does not cost bytes.

``plan_fixed`` prices one specific partition — the hook the benchmarks
use to reproduce the paper's fused-vs-unfused table regardless of which
schedule the DP prefers.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Mapping

from repro_torch import obs
from repro_torch.core import hw as hwlib

from .graph import OpGraph
from .plan import TilePlan
from .solver import InfeasibleError, solve

# planner telemetry (repro.obs): spans around the DP entry points (they
# also time cache hits — a hit is a few-µs span, a miss a solver run)
# and candidate-segment counters inside the pricing loop.
_C_PRICED = obs.counter(
    "ftl_planner_segments_priced_total",
    "candidate segments priced by the tile solver", ("graph",))
_C_INFEASIBLE = obs.counter(
    "ftl_planner_segments_infeasible_total",
    "candidate segments rejected as infeasible", ("graph",))


@dataclasses.dataclass(frozen=True)
class Segment:
    """One planned contiguous piece of the chain."""

    lo: int
    hi: int
    repeat: int
    plan: TilePlan

    @property
    def traffic_bytes(self) -> int:
        return self.plan.traffic_bytes * self.repeat

    @property
    def dma_transfers(self) -> int:
        return self.plan.dma_transfers * self.repeat

    @property
    def vmem_bytes(self) -> int:
        return self.plan.vmem_bytes

    @property
    def transfer_time_s(self) -> float:
        return self.plan.transfer_time_s * self.repeat

    @property
    def compute_time_s(self) -> float:
        return self.plan.compute_time_s * self.repeat

    @property
    def modeled_runtime_s(self) -> float:
        """max(compute, transfer) per run, times the multiplicity."""
        return self.plan.modeled_runtime_s * self.repeat

    @property
    def compute_bound(self) -> bool:
        return self.plan.report.compute_bound

    @property
    def n_steps(self) -> int:
        """Tile steps of one run of this segment's schedule."""
        return self.plan.n_steps

    @property
    def per_engine_compute_s(self) -> dict[str, float]:
        """Engine-serialized compute seconds, multiplicity included."""
        return {e: t * self.repeat
                for e, t in self.plan.per_engine_compute_s.items()}

    @property
    def per_level_traffic(self) -> dict[str, int]:
        return {name: b * self.repeat
                for name, b in self.plan.per_level_traffic.items()}

    def op_names(self) -> tuple[str, ...]:
        return tuple(op.name for op in self.plan.group.ops)


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """A fully planned partition of an op chain."""

    graph: OpGraph
    segments: tuple[Segment, ...]
    target: hwlib.Target

    @property
    def vmem_budget(self) -> int:
        return self.target.fast_capacity

    @property
    def traffic_bytes(self) -> int:
        return sum(s.traffic_bytes for s in self.segments)

    @property
    def dma_transfers(self) -> int:
        return sum(s.dma_transfers for s in self.segments)

    @property
    def transfer_time_s(self) -> float:
        return sum(s.transfer_time_s for s in self.segments)

    @property
    def compute_time_s(self) -> float:
        return sum(s.compute_time_s for s in self.segments)

    @property
    def modeled_runtime_s(self) -> float:
        """The DP's objective: Σ_segment max(compute, transfer) — segments
        execute sequentially, each overlapping its own DMA."""
        return sum(s.modeled_runtime_s for s in self.segments)

    @property
    def compute_bound(self) -> bool:
        """True when compute dominates every segment of the plan."""
        return all(s.compute_bound for s in self.segments)

    @property
    def per_engine_compute_s(self) -> dict[str, float]:
        """Engine-serialized compute seconds, summed over segments."""
        out: dict[str, float] = {}
        for s in self.segments:
            for e, t in s.per_engine_compute_s.items():
                out[e] = out.get(e, 0.0) + t
        return out

    @property
    def per_level_traffic(self) -> dict[str, int]:
        """Modeled traffic per backing level, summed over segments."""
        out: dict[str, int] = {}
        for s in self.segments:
            for name, b in s.per_level_traffic.items():
                out[name] = out.get(name, 0) + b
        return out

    @property
    def vmem_bytes(self) -> int:
        """Peak fast-memory use: segments execute sequentially."""
        return max(s.vmem_bytes for s in self.segments)

    def cuts(self) -> tuple[int, ...]:
        return tuple(s.lo for s in self.segments[1:])

    @property
    def schedule(self) -> str:
        """Three-way label compatible with the seed's MLP auto-planner."""
        if len(self.segments) == 1:
            return "fused"
        if len(self.segments) == self.graph.n_ops:
            return "unfused"
        return "partial"

    def segment_of(self, op_name: str) -> Segment:
        for s in self.segments:
            if op_name in s.op_names():
                return s
        raise KeyError(op_name)

    def summary(self) -> str:
        MB = 1 << 20
        per_level = ", ".join(
            f"{name}={b / MB:.2f} MiB"
            for name, b in self.per_level_traffic.items()
        )
        lines = [
            f"FTL chain plan '{self.graph.name}' on target "
            f"'{self.target.name}': {self.schedule} "
            f"({len(self.segments)} segment(s), cuts at {self.cuts()})",
            f"  traffic : {self.traffic_bytes / MB:.2f} MiB over "
            f"{self.dma_transfers} DMA transfers ({per_level})",
            f"  time    : {1e3 * self.modeled_runtime_s:.3f} ms modeled "
            f"runtime (compute {1e3 * self.compute_time_s:.3f} ms, "
            f"transfer {1e3 * self.transfer_time_s:.3f} ms; "
            f"{'compute' if self.compute_bound else 'transfer'}-bound)",
            f"  {self.target.fast.name:7s} : "
            f"{self.vmem_bytes / MB:.2f} MiB peak / "
            f"{self.vmem_budget / MB:.2f} MiB budget",
        ]
        for s in self.segments:
            rep = f" x{s.repeat}" if s.repeat > 1 else ""
            lines.append(
                f"  [{s.lo}:{s.hi}]{rep} {'+'.join(s.op_names())}: "
                f"{s.traffic_bytes / MB:.2f} MiB"
            )
        return "\n".join(lines)


def _freeze(d: Mapping[str, int] | None) -> tuple | None:
    return tuple(sorted(d.items())) if d else None


def _solve_segment(
    graph: OpGraph,
    lo: int,
    hi: int,
    target: hwlib.Target,
    sharded: tuple | None,
) -> Segment | None:
    """Price one segment; None when infeasible on the target."""
    _C_PRICED.labels(graph=graph.name).inc()
    try:
        with obs.span(f"solve[{lo}:{hi}]", "planner"):
            plan = solve(
                graph.group(lo, hi),
                target=target,
                sharded_sizes=dict(sharded) if sharded else None,
            )
    except InfeasibleError:
        _C_INFEASIBLE.labels(graph=graph.name).inc()
        return None
    return Segment(lo=lo, hi=hi, repeat=graph.repeat(lo, hi), plan=plan)


@functools.lru_cache(maxsize=256)
def _plan_chain_cached(
    graph: OpGraph, target: hwlib.Target, sharded: tuple | None
) -> ChainPlan:
    n = graph.n_ops
    seg: dict[tuple[int, int], Segment | None] = {}
    for lo in range(n):
        for hi in range(lo + 1, n + 1):
            if graph.crosses_barrier(lo, hi):
                continue
            seg[(lo, hi)] = _solve_segment(graph, lo, hi, target, sharded)

    # DP over cut points; key = (runtime, traffic, dma, n_segments) so
    # the objective matches the solver's and ties resolve
    # deterministically — in particular an all-compute-bound chain ties
    # on runtime and the partition moving the fewest bytes wins.  The
    # runtime component is compared through hw.round_time so partitions
    # of mathematically equal runtime (Σ flops_i/F vs (Σ flops_i)/F)
    # actually reach the tie-breaks instead of being split by float ulps.
    def ckey(k: tuple) -> tuple:
        return (hwlib.round_time(k[0]),) + k[1:]

    best: list[tuple[tuple, tuple[Segment, ...]] | None]
    best = [None] * (n + 1)
    best[0] = ((0.0, 0, 0, 0), ())
    for hi in range(1, n + 1):
        for lo in range(hi):
            prev = best[lo]
            s = seg.get((lo, hi))
            if prev is None or s is None:
                continue
            (pt, ptr, pd, pn), psegs = prev
            key = (pt + s.modeled_runtime_s, ptr + s.traffic_bytes,
                   pd + s.dma_transfers, pn + 1)
            if best[hi] is None or ckey(key) < ckey(best[hi][0]):
                best[hi] = (key, psegs + (s,))
    if best[n] is None:
        raise InfeasibleError(
            f"graph {graph.name}: no partition fits the "
            f"{target.fast_capacity} B {target.fast.name} of target "
            f"{target.name}"
        )
    return ChainPlan(graph=graph, segments=best[n][1], target=target)


def plan_chain(
    graph: OpGraph,
    *,
    target: hwlib.Target | None = None,
    sharded_sizes: Mapping[str, int] | None = None,
) -> ChainPlan:
    """Globally runtime-minimal fusion partition of ``graph`` on
    ``target`` (None → the default target): minimizes
    Σ_segment max(compute_time, transfer_time) with (traffic, DMA count,
    segment count) tie-breaks."""
    target = target if target is not None else hwlib.default_target()
    with obs.span("plan_chain", "planner"):
        return _plan_chain_cached(graph, target, _freeze(sharded_sizes))


@functools.lru_cache(maxsize=64)
def _plan_chain_top_k_cached(
    graph: OpGraph, target: hwlib.Target, sharded: tuple | None, k: int
) -> tuple[ChainPlan, ...]:
    n = graph.n_ops
    seg: dict[tuple[int, int], Segment | None] = {}
    for lo in range(n):
        for hi in range(lo + 1, n + 1):
            if graph.crosses_barrier(lo, hi):
                continue
            seg[(lo, hi)] = _solve_segment(graph, lo, hi, target, sharded)

    def ckey(key: tuple) -> tuple:
        return (hwlib.round_time(key[0]),) + key[1:]

    # k-best DP: best[i] holds up to k (key, segments) entries for the
    # prefix ops[0:i], ordered by the same rounded-runtime key as
    # plan_chain.  Per-prefix truncation is exact for an additive
    # objective (the j-th best plan of a prefix extends an ≤ j-th best
    # plan of a shorter prefix).  Candidates are generated rank-major
    # (every prefix-entry-0 composition, lo-ascending, before any
    # entry-1 composition) and ranked with a *stable* sort, so entry 0
    # ties exactly like plan_chain's lo-ascending strict-< incumbent
    # rule — entry 0 of the result is always the plan plan_chain
    # returns.  Entries of one prefix have pairwise-distinct cut sets by
    # construction (distinct (lo, prefix-entry) pairs extend to distinct
    # cut sets).
    best: list[list[tuple[tuple, tuple[Segment, ...]]]]
    best = [[] for _ in range(n + 1)]
    best[0] = [((0.0, 0, 0, 0), ())]
    for hi in range(1, n + 1):
        cands: list[tuple[tuple, tuple[Segment, ...]]] = []
        for rank in range(k):
            for lo in range(hi):
                s = seg.get((lo, hi))
                if s is None or rank >= len(best[lo]):
                    continue
                (pt, ptr, pd, pn), psegs = best[lo][rank]
                key = (pt + s.modeled_runtime_s, ptr + s.traffic_bytes,
                       pd + s.dma_transfers, pn + 1)
                cands.append((key, psegs + (s,)))
        cands.sort(key=lambda e: ckey(e[0]))
        best[hi] = cands[:k]
    if not best[n]:
        raise InfeasibleError(
            f"graph {graph.name}: no partition fits the "
            f"{target.fast_capacity} B {target.fast.name} of target "
            f"{target.name}"
        )
    return tuple(
        ChainPlan(graph=graph, segments=segs, target=target)
        for _, segs in best[n]
    )


def plan_chain_top_k(
    graph: OpGraph,
    *,
    target: hwlib.Target | None = None,
    sharded_sizes: Mapping[str, int] | None = None,
    k: int = 1,
) -> tuple[ChainPlan, ...]:
    """The ``k`` best fusion partitions of ``graph`` on ``target``,
    best-first under :func:`plan_chain`'s exact objective — the
    autotuner's analytic shortlist.  Entry 0 is always the partition
    :func:`plan_chain` returns; fewer than ``k`` feasible partitions
    return them all."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    target = target if target is not None else hwlib.default_target()
    with obs.span("plan_chain_top_k", "planner"):
        return _plan_chain_top_k_cached(graph, target,
                                        _freeze(sharded_sizes), k)


def plan_fixed(
    graph: OpGraph,
    cuts: Iterable[int],
    *,
    target: hwlib.Target | None = None,
    sharded_sizes: Mapping[str, int] | None = None,
) -> ChainPlan:
    """Price one specific partition given by ``cuts`` (positions 1..n-1).

    Mandatory barriers are added automatically.  Raises
    :class:`InfeasibleError` if any segment has no feasible tiling.
    """
    target = target if target is not None else hwlib.default_target()
    n = graph.n_ops
    cut_set = set(cuts) | set(graph.barriers)
    if any(c < 1 or c >= n for c in cut_set):
        raise ValueError(f"cuts {sorted(cut_set)} out of range for {n} ops")
    bounds = [0] + sorted(cut_set) + [n]
    sharded = _freeze(sharded_sizes)
    segments = []
    for lo, hi in zip(bounds, bounds[1:]):
        s = _solve_segment(graph, lo, hi, target, sharded)
        if s is None:
            raise InfeasibleError(
                f"graph {graph.name}: segment [{lo}, {hi}) does not fit "
                f"the {target.fast_capacity} B {target.fast.name} of "
                f"target {target.name}"
            )
        segments.append(s)
    return ChainPlan(graph=graph, segments=tuple(segments), target=target)


def all_cuts(graph: OpGraph) -> tuple[int, ...]:
    """The layer-per-layer partition of ``graph``."""
    return tuple(range(1, graph.n_ops))
