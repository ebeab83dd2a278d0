"""Simulator-in-the-loop autotuning.

The analytic planner (``repro_torch.core.ftl``) returns the roofline-optimal
plan; the simulator (``repro_torch.sim``) knows which of the many near-ties
actually wins once DMA-port contention, buffer-slot hazards and
pipeline fill/drain are replayed.  This package closes the loop:

* :func:`autotune_chain` shortlists the top-k fusion partitions and
  per-segment tile assignments analytically, then beam-searches over
  tile sizes (including non-divisor edge tiles) × per-level buffer
  depths (``Target.with_level_buffer_depth``) × per-kind engine
  assignment, scoring every candidate by full discrete-event replay.
* The returned :class:`TuneResult` carries both the tuned and the
  analytic-best chain; since the analytic plan is always a seed, the
  tuned simulated runtime is ≤ the analytic one by construction
  (held by ``tests/test_torch_tune.py``).
* The search is deterministic (no RNG; fixed enumeration order,
  insertion-order tie-breaks): same inputs → same chosen plan.

``plan_block(..., autotune=AutotuneConfig(...))`` threads the tuner
through the registry/model path; the tuning config is part of the plan
cache key, so tuned and untuned plans never alias.
"""
from .autotune import AutotuneConfig, TuneResult, autotune_chain, tile_ladder

__all__ = ["AutotuneConfig", "TuneResult", "autotune_chain", "tile_ladder"]
