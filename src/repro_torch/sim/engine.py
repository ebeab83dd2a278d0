"""Engine-side lowering helpers: op chain → per-step compute events.

The :class:`repro_torch.core.hw.Engine` model itself lives in ``core/hw.py``
(the :class:`~repro_torch.core.hw.Target` carries it into every plan-cache
key); this module owns the *schedule-side* view: how one tile step's
arithmetic splits into a chain of per-engine compute events.

``cost.evaluate`` prices each op on the engine its kind maps to
(``Target.engine_rate``) and records the per-op seconds in
``CostReport.op_compute``.  The lowering distributes each op's seconds
uniformly over the grid's tile steps — total engine busy time is exactly
the analytic per-engine compute time, so the simulator's floor matches
the planner's — and merges adjacent same-engine ops into one event.  The
chain order is the op (data-dependency) order: within a step the cluster
GeLU waits for the NPU GEMM, but the NPU is then free for step ``s+1``
while the cluster grinds step ``s`` — the software pipeline that makes
the paper's fused NPU+cluster schedule overlap.
"""
from __future__ import annotations

from repro_torch.core.ftl.cost import CostReport, OpCompute


def engine_groups(
    report: CostReport,
) -> tuple[tuple[str, tuple[OpCompute, ...]], ...]:
    """The step chain's structure: adjacent same-engine ops merged into
    ``(engine, ops)`` groups, op (data-dependency) order preserved.  One
    grouping serves every tile step; only the per-step seconds vary (for
    edge tiles of non-divisor shapes)."""
    groups: list[tuple[str, tuple[OpCompute, ...]]] = []
    for oc in report.op_compute:
        if groups and groups[-1][0] == oc.engine:
            eng, ocs = groups[-1]
            groups[-1] = (eng, ocs + (oc,))
        else:
            groups.append((oc.engine, (oc,)))
    return tuple(groups)


def step_compute_chain(
    report: CostReport,
) -> tuple[tuple[str, float, tuple[str, ...]], ...]:
    """Per-tile-step compute chain of a solved assignment.

    Returns ``(engine, seconds_per_step, op_names)`` tuples in op order,
    adjacent same-engine ops merged.  ``Σ seconds · n_steps`` equals the
    analytic per-engine compute time (up to float rounding).  Uniform
    over steps — exact for divisor tiles; the schedule lowering
    (``repro_torch.sim.schedule``) weights each step by its actual edge-tile
    work via :func:`engine_groups` instead when the grid has remainder
    tiles.
    """
    steps = report.n_steps
    return tuple(
        (eng, sum(oc.seconds / steps for oc in ocs),
         tuple(oc.name for oc in ocs))
        for eng, ocs in engine_groups(report)
    )
