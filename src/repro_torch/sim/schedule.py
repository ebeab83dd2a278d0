"""Schedule IR: a plan lowered to explicit per-tile-step events.

A :class:`Schedule` is the execution timeline the planner's closed-form
cost model *implies*, made explicit (LoopTree-style): the solved grid is
walked step by step (outer→inner, exactly the cost model's order) and
every data movement and compute becomes one event:

* :class:`DmaIn` — a streamed INPUT/WEIGHT tile copied from its home
  backing level into a fast-memory buffer slot.  Emitted exactly when
  the cost model's revisit rule says the tile must be (re)fetched: the
  grid coordinates at positions outer than (or at) the tensor's
  innermost grid dim form a *fetch key*; a new key is a new fetch.  The
  per-tensor fetch count therefore reproduces
  ``CostReport.per_tensor_traffic`` / ``dma_transfers`` event by event.
* :class:`Compute` — one entry of the per-engine compute chain of a
  step (:func:`repro_torch.sim.engine.step_compute_chain`): ops priced on the
  engine their kind maps to, chained in data-dependency order within
  the step, pipelined across steps.
* :class:`DmaOut` — a completed output block written back to its home
  level (outputs accumulate in fast memory and are written once per
  block, at the last step that touches the block).
* :class:`Comm` — one step's chunk of a collective's wire traffic
  (``CostReport.collectives``), spread evenly over the steps and
  replayed on the interconnect level's *own* DMA port, so ici/noc
  streams overlap the hbm/L2 traffic in the replay exactly as the
  max-over-ports analytic model prices them.

Buffer slots come from each tensor's *staging depth* —
``max(fast.buffer_depth, home.buffer_depth)``, the backing-level-aware
charge of ``cost.staging_depths`` (equal to the fast level's depth on
every stock target): fetch ``k`` of a tensor occupies slot
``k mod depth``, so depth 1 serializes load and compute while depth ≥ 2
lets the DMA run ahead — the hazard the discrete-event simulator
(:mod:`repro_torch.sim.des`) enforces per tensor.

Edge tiles are exact: on a non-divisor dim the remainder step's DMA
bytes and compute seconds are scaled to the actual tile extent, so the
events sum to the cost model's totals (``bytes_full × revisit``,
full-size FLOPs) event by event instead of overcounting the edge.

Multiplicity (per-head attention segments) is not unrolled: a segment is
lowered once and its simulated runtime scales by ``Segment.repeat``,
mirroring the analytic model.
"""
from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.core import hw as hwlib
from repro_torch.core.ftl.ir import Role, dtype_bytes
from repro_torch.core.ftl.partition import ChainPlan
from repro_torch.core.ftl.plan import TilePlan

from .engine import engine_groups, step_compute_chain


@dataclasses.dataclass(frozen=True)
class DmaIn:
    """Fetch ``tensor``'s current tile from ``level`` into slot ``slot``."""

    step: int
    tensor: str
    level: str
    bytes: int
    fetch: int            # 0-based fetch index of this tensor
    slot: int             # fetch % the tensor's staging depth


@dataclasses.dataclass(frozen=True)
class Compute:
    """One engine's share of tile step ``step`` (chained in op order)."""

    step: int
    engine: str
    seconds: float
    ops: tuple[str, ...]
    seq: int              # position in the step's compute chain


@dataclasses.dataclass(frozen=True)
class DmaOut:
    """Write completed output block ``block`` of ``tensor`` to ``level``."""

    step: int
    tensor: str
    level: str
    bytes: int
    block: int            # 0-based completion index of this tensor
    slot: int             # block % the tensor's staging depth


@dataclasses.dataclass(frozen=True)
class Comm:
    """Tile step ``step``'s chunk of a collective's wire traffic.

    A segment's collectives (``CostReport.collectives``) move a fixed
    payload per segment run; the lowering spreads it evenly over the
    grid's tile steps (exact integer split — chunks sum to the analytic
    bytes/transfer totals) so the DES can interleave the link stream
    with the per-step memory DMA on its *own* port.  ``pre`` chunks feed
    step ``step``'s compute like a prefetch (the operand streamed in);
    post chunks start behind the in-segment compute that produced the
    operand (``after_op``), and when the reduced output is consumed
    later in the same segment (``blocking``) the rest of that step's
    chain waits for the wire — fusing across a collective costs real
    serialization per tile, hidden only by the cross-step pipeline.
    ``setups`` is this chunk's share of the ring messages (most chunks
    carry 0 — there are far fewer ring steps than tiles)."""

    step: int
    op: str               # CollectiveNode name (e.g. 'comm.proj.wo')
    comm: str             # all_gather | reduce_scatter | all_reduce
    level: str            # interconnect level (ici / noc)
    bytes: int
    setups: int
    pre: bool
    after_op: str = ""    # in-segment producer op ("" when streamed)
    blocking: bool = False  # output consumed later in the segment


Event = Union[DmaIn, Compute, DmaOut, Comm]


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A lowered segment: events in program order + analytic reference."""

    name: str
    target: hwlib.Target
    n_steps: int
    buffer_depth: int
    events: tuple[Event, ...]
    # analytic reference (from the CostReport that produced the plan)
    compute_time_s: float
    transfer_time_s: float
    modeled_runtime_s: float
    per_engine_compute_s: dict[str, float]
    per_level_traffic: dict[str, int]
    # per-tensor staging depth (max(fast.depth, home.depth) — see
    # cost.staging_depths); tensors not named fall back to buffer_depth.
    tensor_depths: dict[str, int] = dataclasses.field(default_factory=dict)

    def dma_events(self) -> list[Union[DmaIn, DmaOut]]:
        return [e for e in self.events
                if not isinstance(e, (Compute, Comm))]

    def compute_events(self) -> list[Compute]:
        return [e for e in self.events if isinstance(e, Compute)]

    def comm_events(self) -> list[Comm]:
        return [e for e in self.events if isinstance(e, Comm)]


def _unflatten(s: int, counts: list[int]) -> tuple[int, ...]:
    """Flat step index → grid coordinates, outer→inner."""
    coords = [0] * len(counts)
    for i in range(len(counts) - 1, -1, -1):
        s, coords[i] = divmod(s, counts[i])
    return tuple(coords)


def lower_plan(plan: TilePlan, name: str | None = None) -> Schedule:
    """Lower one solved :class:`TilePlan` into its :class:`Schedule`."""
    rep = plan.report
    target = plan.target
    depth = target.fast.buffer_depth
    dims = [d for d, _ in rep.grid]
    counts = [c for _, c in rep.grid]
    steps = rep.n_steps
    group = plan.group

    streamed = group.hbm_tensors()
    ins = [t for t in streamed if t.role in (Role.INPUT, Role.WEIGHT)]
    outs = [t for t in streamed if t.role is Role.OUTPUT]
    homes = rep.tensor_homes
    tdepth = {t.name: rep.tensor_depths.get(t.name, depth)
              for t in streamed}

    # Edge-tile geometry: on a non-divisor dim the last tile is the
    # remainder, so per-event bytes and per-step compute are weighted by
    # the *actual* tile extent at the step's coordinates — the events
    # then sum exactly to the cost model's totals (which already price
    # ``bytes_full × revisit`` / full-size FLOPs), where uniform
    # full-tile charges would overcount every remainder step.
    sizes = {d: plan.constraints[d].size for d in plan.constraints}
    gtile = [min(plan.tiles[d], sizes[d]) for d in dims]
    exact = all(sizes[d] % gtile[i] == 0 for i, d in enumerate(dims))
    pos_of = {d: i for i, d in enumerate(dims)}

    def _extent(i: int, c: int) -> int:
        return min(gtile[i], sizes[dims[i]] - c * gtile[i])

    def _tile_bytes(t, coords) -> int:
        n = dtype_bytes(t.dtype)
        for d in t.dims:
            i = pos_of.get(d)
            n *= _extent(i, coords[i]) if i is not None \
                else min(plan.tiles[d], sizes[d])
        return n

    # Fetch key of an in-tensor = grid positions ≤ its innermost grid
    # dim — a *prefix* of the (outer→inner) coordinate tuple, since every
    # grid dim of the tensor sits at or above its innermost one.  The
    # cost model's revisit product over exactly these positions is then
    # literally the number of key changes along the walk.
    def _prefix_len(t) -> int:
        inner = -1
        for i, d in enumerate(dims):
            if d in t.dims:
                inner = i
        return inner + 1

    in_prefix = {t.name: _prefix_len(t) for t in ins}
    out_pos = {t.name: [i for i, d in enumerate(dims) if d in t.dims]
               for t in outs}

    # Last step touching each output block (outputs accumulate in fast
    # memory; the write-back happens when the block is complete).
    last_touch: dict[str, dict[tuple[int, ...], int]] = {
        t.name: {} for t in outs}
    for s in range(steps):
        coords = _unflatten(s, counts)
        for t in outs:
            key = tuple(coords[i] for i in out_pos[t.name])
            last_touch[t.name][key] = s

    # Per-step compute chain.  Divisor grids use the uniform chain
    # (bit-identical to the pre-edge-tile lowering); remainder grids
    # weight each op's seconds by the fraction of its work the step's
    # actual tile extents cover — an op's work dims are its output dims
    # plus its contract dims (exactly OpNode.flops' factors), any other
    # grid dim splits the op's work evenly.
    uniform = step_compute_chain(rep) if exact else None
    groups = engine_groups(rep)
    work_dims = {op.name: set(op.output.dims) | set(op.contract_dims())
                 for op in group.ops}

    def _chain_at(coords) -> tuple[tuple[str, float, tuple[str, ...]], ...]:
        if uniform is not None:
            return uniform
        out = []
        for engine, ocs in groups:
            secs = 0.0
            for oc in ocs:
                w = 1.0
                for i, d in enumerate(dims):
                    if d in work_dims[oc.name]:
                        w *= _extent(i, coords[i]) / sizes[d]
                    else:
                        w *= 1.0 / counts[i]
                secs += oc.seconds * w
            out.append((engine, secs, tuple(oc.name for oc in ocs)))
        return tuple(out)

    # Collective wire chunks: each CollectiveCost's payload split evenly
    # over the tile steps (exact integer split), interleaved with the
    # step's memory DMA so the DES can overlap the two ports.
    def _chunks(total: int) -> list[int]:
        base, rem = divmod(total, steps)
        return [base + (1 if s < rem else 0) for s in range(steps)]

    comm_chunks = [
        (cc, _chunks(cc.bytes), _chunks(cc.transfers))
        for cc in rep.collectives
    ]

    events: list[Event] = []
    prev_key: dict[str, tuple[int, ...]] = {}
    fetch_n = {t.name: 0 for t in ins}
    block_n = {t.name: 0 for t in outs}
    for s in range(steps):
        coords = _unflatten(s, counts)
        for cc, bts, sps in comm_chunks:
            if cc.pre and (bts[s] or sps[s]):
                events.append(Comm(
                    step=s, op=cc.name, comm=cc.comm, level=cc.level,
                    bytes=bts[s], setups=sps[s], pre=True))
        for t in ins:
            key = coords[: in_prefix[t.name]]
            if prev_key.get(t.name) != key:
                prev_key[t.name] = key
                f = fetch_n[t.name]
                fetch_n[t.name] = f + 1
                events.append(DmaIn(
                    step=s, tensor=t.name, level=homes[t.name],
                    bytes=_tile_bytes(t, coords), fetch=f,
                    slot=f % tdepth[t.name]))
        for seq, (engine, secs, op_names) in enumerate(_chain_at(coords)):
            events.append(Compute(step=s, engine=engine, seconds=secs,
                                  ops=op_names, seq=seq))
        for t in outs:
            key = tuple(coords[i] for i in out_pos[t.name])
            if last_touch[t.name][key] == s:
                b = block_n[t.name]
                block_n[t.name] = b + 1
                events.append(DmaOut(
                    step=s, tensor=t.name, level=homes[t.name],
                    bytes=_tile_bytes(t, coords), block=b,
                    slot=b % tdepth[t.name]))
        for cc, bts, sps in comm_chunks:
            if not cc.pre and (bts[s] or sps[s]):
                events.append(Comm(
                    step=s, op=cc.name, comm=cc.comm, level=cc.level,
                    bytes=bts[s], setups=sps[s], pre=False,
                    after_op=cc.producer, blocking=cc.blocking))

    return Schedule(
        name=name or group.name,
        target=target,
        n_steps=steps,
        buffer_depth=depth,
        events=tuple(events),
        compute_time_s=rep.compute_time_s,
        transfer_time_s=rep.transfer_time_s,
        modeled_runtime_s=rep.modeled_runtime_s,
        per_engine_compute_s=dict(rep.per_engine_compute_s),
        per_level_traffic=dict(rep.per_level_traffic),
        tensor_depths=tdepth,
    )


def lower_chain(chain: ChainPlan) -> tuple[tuple[Schedule, int], ...]:
    """Lower every segment of a :class:`ChainPlan`; returns
    ``(schedule, repeat)`` pairs in execution order."""
    return tuple(
        (lower_plan(s.plan, name=f"{chain.graph.name}[{s.lo}:{s.hi}]"),
         s.repeat)
        for s in chain.segments
    )


def lower_block(block_plan) -> tuple[tuple[Schedule, int], ...]:
    """Lower a :class:`~repro_torch.core.ftl.registry.BlockPlan` (its chain)."""
    return lower_chain(block_plan.chain)
