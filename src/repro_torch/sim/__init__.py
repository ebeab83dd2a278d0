"""Tile-level schedule IR + discrete-event DMA/engine simulator.

The port's copy of ``repro.sim``: on the same plan it gives the same
events and the same floats (``tests/test_torch_sim.py``).

The planner's objective (``max(compute_time, transfer_time)`` per
segment) is a closed-form *claim* about overlap: double-buffered DMA
hides behind compute.  This package makes that claim falsifiable — and
unlocks the paper's cluster+NPU overlap regime — by lowering a plan into
an explicit per-tile-step event timeline and replaying it:

* :mod:`repro_torch.sim.schedule` lowers a
  :class:`~repro_torch.core.ftl.plan.TilePlan` /
  :class:`~repro_torch.core.ftl.partition.ChainPlan` /
  :class:`~repro_torch.core.ftl.registry.BlockPlan` into a :class:`Schedule`:
  one ``DmaIn`` per tensor re-fetch (the cost model's revisit rule,
  event by event), a per-engine ``Compute`` chain per tile step, one
  ``DmaOut`` per completed output block, and per-step ``Comm`` chunks
  for a segment's collectives — buffer slots from the fast level's
  ``buffer_depth``, tensor homes from ``cost.evaluate``'s per-level
  assignment, engines from the op-kind → ``hw.Engine`` map.
* :mod:`repro_torch.sim.des` replays a schedule respecting buffer-slot
  hazards, DMA serialization per *port* (all memory tiers share the
  default port — the single fast-level DMA — while collective traffic
  runs on the interconnect's own port and genuinely overlaps), and
  per-engine concurrency, reporting simulated runtime, per-resource
  busy/stall time and overlap efficiency.
* :mod:`repro_torch.sim.report` compares simulated against analytic runtime
  and renders event timelines and Chrome traces.

The simulated runtime is always ≥ the analytic modeled runtime (both
charge identical total DMA and engine busy time; the DES adds only real
serialization) and converges to it when the pipeline is deep enough for
fill/drain to amortize — ``tests/test_torch_sim.py`` pins both directions.
"""
from repro_torch.core.hw import Engine  # noqa: F401  (re-export: sim's engine model)

from .des import ChainSimResult, SimResult, port_key, simulate, simulate_chain
from .engine import step_compute_chain
from .report import (
    chain_timeline,
    compare_plan,
    sim_rows,
    timeline,
    to_chrome_trace,
    write_chrome_trace,
)
from .schedule import (
    Comm,
    Compute,
    DmaIn,
    DmaOut,
    Schedule,
    lower_block,
    lower_chain,
    lower_plan,
)

__all__ = [
    "Engine",
    "Schedule", "DmaIn", "Compute", "DmaOut", "Comm", "port_key",
    "lower_plan", "lower_chain", "lower_block",
    "SimResult", "ChainSimResult", "simulate", "simulate_chain",
    "step_compute_chain",
    "compare_plan", "sim_rows", "timeline", "chain_timeline",
    "to_chrome_trace", "write_chrome_trace",
]
