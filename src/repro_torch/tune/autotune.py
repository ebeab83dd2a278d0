"""Simulator-in-the-loop autotuning (the LoopTree-style second stage).

The analytic planner (``repro_torch.core.ftl``) optimizes the closed-form
``max(compute, transfer)`` roofline; the discrete-event simulator
(``repro_torch.sim``) replays the implied schedule with the hazards the
closed form ignores — DMA-port contention, buffer-slot stalls, prefetch
distance, pipeline fill/drain.  Plans that tie analytically can differ
by real simulated runtime, and a deliberately *analytic-suboptimal*
move (a deeper staging pipeline bought with a smaller tile, a slower
engine that overlaps with the bottleneck one) can win the replay.

This module closes that loop with a two-stage search:

1. **Analytic shortlist** — the top-``k`` fusion partitions of the
   chain (``partition.plan_chain_top_k``) and, per segment, the
   top-``k`` tile assignments (``solver.solve_top_k``).  Both are exact
   k-best extensions of the existing branch-and-bound/DP, so seed 0 is
   always the analytic-best plan.
2. **DES-scored beam search** — from those seeds, a deterministic beam
   over four move families: switching a segment to another shortlisted
   tile assignment, nudging one dim's tile along an aligned ladder
   (including *non-divisor* sizes — the sharpened edge-tile lowering
   prices those exactly), re-depthing one memory level
   (``Target.with_level_buffer_depth``), and re-assigning one op kind
   to another capable engine.  Every candidate is lowered and replayed
   (``sim.simulate_chain``); infeasible footprints are discarded.

Because the seeds include the analytic-best chain and scoring is exact
replay, the tuned plan's simulated runtime is ≤ the analytic-best
plan's simulated runtime *by construction*.  The search is RNG-free:
candidate enumeration order is fixed, ties break by insertion order,
and repeated runs return the identical plan (pinned, with the chosen
plan equal to the reference's, in ``tests/test_torch_tune.py``).

A tuned ``buffer_depth`` is a figure of the model only: the port's
kernels pick their own ring stages from their shapes
(``kernels/*.py:schedule``), whatever depth the tuned target carries.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

from repro_torch import obs
from repro_torch.core import hw as hwlib
from repro_torch.core.ftl import cost as costlib
from repro_torch.core.ftl import partition as partlib
from repro_torch.core.ftl import registry
from repro_torch.core.ftl import solver as solverlib
from repro_torch.core.ftl.constraints import DimConstraint
from repro_torch.core.ftl.graph import OpGraph
from repro_torch.core.ftl.partition import ChainPlan
from repro_torch.sim.des import simulate_chain
from repro_torch.sim.schedule import lower_chain


@dataclasses.dataclass(frozen=True)
class AutotuneConfig:
    """Knobs of the DES-scored search (hashable — part of every plan
    cache key that holds a tuned plan).

    * ``top_k_partitions`` / ``top_k_tiles`` — analytic shortlist sizes
      (stage 1).  1 keeps only the argmin the planner already returns.
    * ``beam_width`` / ``max_rounds`` — beam search shape (stage 2).
      Width 4 × 3 rounds covers the presets well; deeper searches help
      only when many analytic ties exist.
    * ``max_sims`` — hard budget on DES replays (each is milliseconds
      on zoo blocks; the budget caps worst-case planning latency).
    * ``depth_candidates`` — per-level ``buffer_depth`` values the
      search may try (fast *and* backing levels).
    * ``tune_tiles`` / ``tune_depths`` / ``tune_engines`` — move-family
      switches.
    """

    top_k_partitions: int = 3
    top_k_tiles: int = 3
    beam_width: int = 4
    max_rounds: int = 3
    max_sims: int = 256
    depth_candidates: tuple[int, ...] = (1, 2, 3, 4)
    tune_tiles: bool = True
    tune_depths: bool = True
    tune_engines: bool = True

    def __post_init__(self):
        if min(self.top_k_partitions, self.top_k_tiles) < 1:
            raise ValueError("top_k_partitions/top_k_tiles must be >= 1")
        if self.beam_width < 1 or self.max_rounds < 0:
            raise ValueError("beam_width >= 1 and max_rounds >= 0 required")
        if self.max_sims < 1:
            raise ValueError("max_sims must be >= 1")
        if any(d < 1 for d in self.depth_candidates):
            raise ValueError("depth candidates must be >= 1")


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one autotune run: the chosen chain + its provenance."""

    chain: ChainPlan                   # DES-optimal plan
    sim_runtime_s: float               # its simulated runtime
    baseline_chain: ChainPlan          # the analytic-best plan (seed 0)
    baseline_sim_runtime_s: float      # its simulated runtime
    n_scored: int                      # DES replays spent
    n_feasible: int                    # candidates that fit fast memory
    config: AutotuneConfig

    @property
    def improved(self) -> bool:
        """Strictly better than the analytic-best plan under replay
        (compared through ``hw.round_time``, like every objective)."""
        return hwlib.round_time(self.sim_runtime_s) < \
            hwlib.round_time(self.baseline_sim_runtime_s)

    @property
    def improvement(self) -> float:
        """Fractional simulated-runtime win over the analytic plan."""
        if self.baseline_sim_runtime_s <= 0.0:
            return 0.0
        return 1.0 - self.sim_runtime_s / self.baseline_sim_runtime_s

    @property
    def analytic_runtime_s(self) -> float:
        return self.chain.modeled_runtime_s

    def summary(self) -> str:
        pct = 100.0 * self.improvement
        return (
            f"autotune '{self.chain.graph.name}' on "
            f"{self.baseline_chain.target.name}: "
            f"{1e3 * self.sim_runtime_s:.3f} ms simulated vs "
            f"{1e3 * self.baseline_sim_runtime_s:.3f} ms analytic-best "
            f"({pct:+.2f} %), {self.n_scored} replays "
            f"({self.n_feasible} feasible); chosen cuts "
            f"{self.chain.cuts()}, target '{self.chain.target.name}'"
        )


def tile_ladder(c: DimConstraint) -> tuple[int, ...]:
    """Extended tile domain for the nudge move: the solver's aligned
    divisors plus one aligned midpoint between each adjacent pair —
    deliberately *non-divisor* sizes the analytic lattice never tries,
    priced exactly by the edge-tile-aware lowering.  Pinned dims (whole
    contractions, single-candidate domains) get no moves."""
    if len(c.candidates) <= 1:
        return c.candidates
    a = max(c.alignment, 1)
    pts = set(c.candidates)
    for lo, hi in zip(c.candidates, c.candidates[1:]):
        mid = ((lo + hi) // 2 // a) * a
        if lo < mid < hi:
            pts.add(mid)
    return tuple(sorted(pts))


# A candidate is a fully hashable description of one plan variant:
#   (partition index into the top-k shortlist,
#    per-segment tiles       ((dim, tile), ...) per segment,
#    per-segment overrides   ((kind, engine), ...) per segment,
#    per-level depths        ((level, depth), ...) — non-base only)
Candidate = tuple[int, tuple, tuple, tuple]

# beam telemetry: candidates generated by the move families, DES replays
# actually spent, and candidates pruned as infeasible footprints
_C_CANDIDATES = obs.counter(
    "tune_candidates_total", "candidates generated by the move families")
_C_REPLAYS = obs.counter(
    "tune_replays_total", "DES replays spent scoring candidates")
_C_INFEASIBLE = obs.counter(
    "tune_infeasible_total", "candidates pruned (footprint no longer fits)")


def _freeze_tiles(tiles: Mapping[str, int]) -> tuple:
    return tuple(sorted(tiles.items()))


class _Search:
    def __init__(self, graph: OpGraph, target: hwlib.Target,
                 config: AutotuneConfig, sharded: tuple | None):
        self.graph = graph
        self.target = target
        self.config = config
        self.sharded = dict(sharded) if sharded else None
        self.parts = partlib.plan_chain_top_k(
            graph, target=target, sharded_sizes=self.sharded,
            k=config.top_k_partitions)
        # per (partition, segment): the analytic top-k tile shortlist
        self.seg_tiles: dict[tuple[int, int], list[dict[str, int]]] = {}
        if config.tune_tiles and config.top_k_tiles > 1:
            for pi, part in enumerate(self.parts):
                for si, seg in enumerate(part.segments):
                    plans = solverlib.solve_top_k(
                        seg.plan.group, target=target,
                        sharded_sizes=self.sharded,
                        k=config.top_k_tiles)
                    self.seg_tiles[(pi, si)] = [p.tiles for p in plans]
        self.scored: dict[Candidate, tuple[int, float, ChainPlan | None]] \
            = {}
        self.n_feasible = 0
        self.seq = 0

    # -- candidate construction -------------------------------------
    def seed(self, pi: int) -> Candidate:
        part = self.parts[pi]
        return (
            pi,
            tuple(_freeze_tiles(s.plan.tiles) for s in part.segments),
            tuple(() for _ in part.segments),
            (),
        )

    def _target_for(self, depths: tuple) -> hwlib.Target:
        t = self.target
        for level, d in depths:
            t = t.with_level_buffer_depth(level, d)
        return t

    def _build(self, cand: Candidate) -> ChainPlan | None:
        """Re-price a candidate analytically; None when any segment's
        footprint no longer fits the (possibly re-depthed) fast level."""
        pi, seg_tiles, seg_engines, depths = cand
        part = self.parts[pi]
        t = self._target_for(depths)
        segs = []
        for s, tiles, overrides in zip(part.segments, seg_tiles,
                                       seg_engines):
            rep = costlib.evaluate(
                s.plan.group, dict(tiles), s.plan.constraints,
                target=t, engine_overrides=dict(overrides) or None)
            if rep.vmem_bytes > t.fast_capacity:
                return None
            plan = dataclasses.replace(
                s.plan, tiles=dict(tiles), report=rep, target=t)
            segs.append(dataclasses.replace(s, plan=plan))
        return ChainPlan(graph=self.graph, segments=tuple(segs), target=t)

    def score(self, cand: Candidate) -> float | None:
        """Simulated runtime of a candidate (cached; None = infeasible).
        Counts one DES replay against ``max_sims`` per new feasible
        candidate."""
        if cand in self.scored:
            return self.scored[cand][1]
        self.seq += 1
        chain = self._build(cand)
        if chain is None:
            _C_INFEASIBLE.inc()
            self.scored[cand] = (self.seq, None, None)
            return None
        _C_REPLAYS.inc()
        runtime = simulate_chain(lower_chain(chain)).runtime_s
        self.scored[cand] = (self.seq, runtime, chain)
        self.n_feasible += 1
        return runtime

    @property
    def n_scored(self) -> int:
        return len(self.scored)

    # -- move families ----------------------------------------------
    def moves(self, cand: Candidate) -> list[Candidate]:
        out = self._moves(cand)
        _C_CANDIDATES.inc(len(out))
        return out

    def _moves(self, cand: Candidate) -> list[Candidate]:
        pi, seg_tiles, seg_engines, depths = cand
        part = self.parts[pi]
        cfg = self.config
        out: list[Candidate] = []

        def with_seg_tiles(si: int, tiles: tuple) -> Candidate:
            new = seg_tiles[:si] + (tiles,) + seg_tiles[si + 1:]
            return (pi, new, seg_engines, depths)

        if cfg.tune_tiles:
            # (a) switch a segment to another shortlisted tile plan
            for si in range(len(part.segments)):
                for alt in self.seg_tiles.get((pi, si), ()):
                    frozen = _freeze_tiles(alt)
                    if frozen != seg_tiles[si]:
                        out.append(with_seg_tiles(si, frozen))
            # (b) nudge one dim along its aligned ladder
            for si, s in enumerate(part.segments):
                cur = dict(seg_tiles[si])
                for d, c in s.plan.constraints.items():
                    ladder = tile_ladder(c)
                    if len(ladder) <= 1 or cur[d] not in ladder:
                        continue
                    i = ladder.index(cur[d])
                    for j in (i - 1, i + 1):
                        if 0 <= j < len(ladder):
                            out.append(with_seg_tiles(
                                si, _freeze_tiles({**cur, d: ladder[j]})))

        if cfg.tune_depths:
            cur_depths = dict(depths)
            base = {lv.name: lv.buffer_depth for lv in self.target.levels}
            shrunk = self._shrunk_tiles(seg_tiles, part)
            for lv in self.target.levels:
                have = cur_depths.get(lv.name, base[lv.name])
                for d in cfg.depth_candidates:
                    if d == have:
                        continue
                    nd = dict(cur_depths)
                    if d == base[lv.name]:
                        nd.pop(lv.name, None)
                    else:
                        nd[lv.name] = d
                    frozen_d = tuple(sorted(nd.items()))
                    out.append((pi, seg_tiles, seg_engines, frozen_d))
                    if d > have and shrunk is not None:
                        # repair variant: a deeper pipeline costs
                        # footprint — pair it with one ladder step down
                        # on every dim so the move stays reachable when
                        # the current tiles leave no headroom.
                        out.append((pi, shrunk, seg_engines, frozen_d))

        if cfg.tune_engines and self.target.engines:
            for si, s in enumerate(part.segments):
                cur = dict(seg_engines[si])
                kinds = []
                for op in s.plan.group.ops:
                    if op.kind not in kinds:
                        kinds.append(op.kind)
                for kind in kinds:
                    have = cur.get(kind, self.target.engine_rate(kind)[0])
                    for ename in self.target.engines_for_kind(kind):
                        if ename == have:
                            continue
                        ne = dict(cur)
                        if ename == self.target.engine_rate(kind)[0]:
                            ne.pop(kind, None)
                        else:
                            ne[kind] = ename
                        frozen_e = tuple(sorted(ne.items()))
                        new = seg_engines[:si] + (frozen_e,) + \
                            seg_engines[si + 1:]
                        out.append((pi, seg_tiles, new, depths))
        return out

    def _shrunk_tiles(self, seg_tiles: tuple, part: ChainPlan
                      ) -> tuple | None:
        shrunk = []
        changed = False
        for si, s in enumerate(part.segments):
            cur = dict(seg_tiles[si])
            for d, c in s.plan.constraints.items():
                ladder = tile_ladder(c)
                if cur[d] in ladder:
                    i = ladder.index(cur[d])
                    if i > 0:
                        cur[d] = ladder[i - 1]
                        changed = True
            shrunk.append(_freeze_tiles(cur))
        return tuple(shrunk) if changed else None

    # -- the beam ----------------------------------------------------
    def run(self) -> TuneResult:
        cfg = self.config
        seeds = [self.seed(pi) for pi in range(len(self.parts))]
        baseline = seeds[0]
        for c in seeds:
            self.score(c)
        baseline_runtime = self.scored[baseline][1]
        assert baseline_runtime is not None  # seed 0 is the solved plan

        def rank(cand: Candidate) -> tuple:
            seq, runtime, _ = self.scored[cand]
            return (hwlib.round_time(runtime), seq)

        frontier = sorted(
            (c for c in seeds if self.scored[c][1] is not None), key=rank
        )[:cfg.beam_width]
        for rnd in range(cfg.max_rounds):
            if self.n_scored >= cfg.max_sims:
                break
            fresh: list[Candidate] = []
            with obs.span(f"autotune_round:{rnd}", "tune"):
                for cand in frontier:
                    for nxt in self.moves(cand):
                        if nxt in self.scored:
                            continue
                        if self.n_scored >= cfg.max_sims:
                            break
                        if self.score(nxt) is not None:
                            fresh.append(nxt)
            if not fresh:
                break
            frontier = sorted(set(frontier) | set(fresh), key=rank)
            frontier = frontier[:cfg.beam_width]

        best = min(
            (c for c, (_, r, _ch) in self.scored.items() if r is not None),
            key=rank,
        )
        _, best_runtime, best_chain = self.scored[best]
        return TuneResult(
            chain=best_chain,
            sim_runtime_s=best_runtime,
            baseline_chain=self.scored[baseline][2],
            baseline_sim_runtime_s=baseline_runtime,
            n_scored=self.n_scored,
            n_feasible=self.n_feasible,
            config=cfg,
        )


@functools.lru_cache(maxsize=64)
def _autotune_cached(graph: OpGraph, target: hwlib.Target,
                     config: AutotuneConfig,
                     sharded: tuple | None) -> TuneResult:
    return _Search(graph, target, config, sharded).run()


registry.register_plan_cache("tune._autotune_cached", _autotune_cached)


def autotune_chain(
    graph: OpGraph,
    *,
    target: hwlib.Target | None = None,
    config: AutotuneConfig | None = None,
    sharded_sizes: Mapping[str, int] | None = None,
) -> TuneResult:
    """DES-optimal plan for ``graph`` on ``target`` (None → the default
    target): analytic top-k shortlist, then a deterministic beam search
    over tile sizes × per-level buffer depths × engine assignment,
    every candidate scored by full schedule replay.  The result's
    simulated runtime is ≤ the analytic-best plan's simulated runtime
    by construction (the analytic plan is seed 0 and ties keep it).

    Cached per (graph, target, config, sharding) — the same key shape
    every other planner cache uses, so a tuned chain is never confused
    with an untuned one.
    """
    target = target if target is not None else hwlib.default_target()
    config = config if config is not None else AutotuneConfig()
    with obs.span("autotune_chain", "tune"):
        return _autotune_cached(graph, target, config,
                                partlib._freeze(sharded_sizes))


__all__ = ["AutotuneConfig", "TuneResult", "autotune_chain", "tile_ladder"]
