"""FTL tile-size solver (paper step 4).

Exact branch-and-bound over the aligned-divisor lattice of every dim
variable in a (possibly fused) group, minimizing the *modeled roofline
runtime* of the cost model on the planning :class:`~repro_torch.core.hw.Target`
— ``max(compute_time, transfer_time)`` with (traffic, DMA count, grid
steps) as tie-breaks — subject to the fast level's capacity constraint
at its pipeline ``buffer_depth``.

Pruning relies on two monotonicities:
  * fast-memory footprint grows with tile sizes -> feasibility prune from
    below,
  * per-tensor traffic, DMA count AND compute time shrink (or stay) with
    tile sizes — the per-tensor level weights are tile-independent and
    the compute term depends on tiles only through the lane-utilization
    factor, which is monotone non-decreasing in the lane tile
    (``cost.lane_utilization``) — so the full cost key with the
    remaining dims at full size is a component-wise (hence
    lexicographic) lower bound over the subtree.  Bounding the whole key (not just the time term) keeps the
    prune biting in the compute-bound regime, where every assignment ties
    on runtime and the search would otherwise degenerate to exhaustive.

Groups have <= ~8 dims with <= 14 candidates each; with the two prunes the
search visits a few thousand nodes in practice (tested up to production
GEMM shapes, see tests/test_ftl_solver.py).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core import hw as hwlib

from .constraints import build_dim_constraints
from .cost import (
    CostReport,
    evaluate,
    min_traffic_bound,
    staging_depths,
    vmem_usage,
)
from .ir import FusionGroup
from .plan import TilePlan


class InfeasibleError(RuntimeError):
    """No tile assignment fits the target's fast memory."""


@dataclasses.dataclass
class _SearchState:
    # up to k incumbents, sorted ascending by (key, seq); seq is the
    # insertion counter, so ties keep the earlier-found assignment —
    # exactly the strict-< incumbent rule of the k=1 search.
    best: list[tuple[tuple, int, dict, CostReport]] = \
        dataclasses.field(default_factory=list)
    nodes: int = 0
    seq: int = 0


def solve_top_k(
    group: FusionGroup,
    *,
    target: hwlib.Target | None = None,
    sharded_sizes: Mapping[str, int] | None = None,
    whole_dims: frozenset[str] = frozenset(),
    k: int = 1,
) -> list[TilePlan]:
    """The ``k`` best tile assignments for ``group`` on ``target``,
    best-first (the autotuner's analytic shortlist).

    Same exact branch-and-bound as :func:`solve` — the optimality prune
    merely compares the optimistic subtree bound against the *worst*
    incumbent once ``k`` plans are held, so entry 0 is always the plan
    :func:`solve` returns and the list is the true top-k (no heuristic
    truncation).  Fewer than ``k`` feasible assignments return them all;
    zero raises :class:`InfeasibleError`.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    target = target if target is not None else hwlib.default_target()
    budget = target.fast_capacity
    group.validate()
    cons = build_dim_constraints(
        group, sharded_sizes=sharded_sizes, whole_dims=whole_dims
    )
    # Per-tensor staging depths are tile-independent (homes follow full
    # footprints only), so one map serves every probe and the prunes
    # stay exact.
    depths = staging_depths(group, cons, target)
    names = sorted(
        cons,
        # Put large dims first: their candidate choice constrains the fast
        # footprint most, so pruning bites early.
        key=lambda n: -cons[n].size,
    )
    state = _SearchState()

    def leaf(tiles: dict[str, int]) -> None:
        rep = evaluate(group, tiles, cons, target=target)
        if rep.vmem_bytes > budget:
            return
        key = (rep.modeled_runtime_s, rep.traffic_bytes, rep.dma_transfers,
               rep.n_steps)
        if len(state.best) == k and key >= state.best[-1][0]:
            return
        state.seq += 1
        state.best.append((key, state.seq, dict(tiles), rep))
        state.best.sort(key=lambda e: (e[0], e[1]))
        del state.best[k:]

    def dfs(i: int, tiles: dict[str, int]) -> None:
        state.nodes += 1
        if i == len(names):
            leaf(tiles)
            return
        name = names[i]
        cands = cons[name].candidates
        for c in cands:
            tiles[name] = c
            # --- feasibility prune: remaining dims at their MIN candidate.
            probe = dict(tiles)
            for j in range(i + 1, len(names)):
                probe[names[j]] = cons[names[j]].candidates[0]
            if vmem_usage(group, probe, cons, depths=depths) > budget:
                # candidates ascend; larger c only makes it worse.
                del tiles[name]
                break
            # --- optimality prune: remaining dims at FULL size (optimistic).
            if len(state.best) == k:
                opt = dict(tiles)
                for j in range(i + 1, len(names)):
                    opt[names[j]] = cons[names[j]].size
                rep = evaluate(group, opt, cons, target=target)
                # runtime, traffic and DMA count all shrink (or stay) as
                # tiles grow and steps >= 1, so the optimistic full-size
                # key bounds every leaf's key from below component-wise —
                # hence lexicographically.  A subtree whose bound cannot
                # strictly beat the worst held incumbent is dead (ties
                # keep the earlier incumbent anyway).
                opt_key = (rep.modeled_runtime_s, rep.traffic_bytes,
                           rep.dma_transfers, 1)
                if opt_key >= state.best[-1][0]:
                    continue
            dfs(i + 1, tiles)
        tiles.pop(name, None)

    dfs(0, {})
    if not state.best:
        raise InfeasibleError(
            f"group {group.name}: no tile assignment fits the {budget} B "
            f"{target.fast.name} of target {target.name} "
            f"(lower bound traffic {min_traffic_bound(group, cons)} B)"
        )
    return [
        TilePlan(
            group=group,
            tiles=tiles,
            constraints=cons,
            report=rep,
            target=target,
            nodes_explored=state.nodes,
        )
        for _, _, tiles, rep in state.best
    ]


def solve(
    group: FusionGroup,
    *,
    target: hwlib.Target | None = None,
    sharded_sizes: Mapping[str, int] | None = None,
    whole_dims: frozenset[str] = frozenset(),
) -> TilePlan:
    """Plan tiling for ``group`` on ``target`` (None → the default target);
    returns the optimal :class:`TilePlan`."""
    return solve_top_k(
        group, target=target, sharded_sizes=sharded_sizes,
        whole_dims=whole_dims, k=1,
    )[0]
