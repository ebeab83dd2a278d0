"""FTL traffic / memory / roofline-runtime cost model.

Models what the paper's Fig. 3 measures on Siracusa: total bytes moved
between the software-managed fast memory (VMEM here, L1 there) and the
backing tiers (HBM here, L2/L3 there), the DMA-transfer count, the
modeled *transfer time* those moves cost, and — since the FTL paper
reports runtime (not bytes) as the win, and LoopTree shows compute-bound
segments must be priced with a joint latency model — the **modeled
runtime** that is the solver's objective:

    port(p)  = Σ_{level on p}  bytes(level) / bw(level)  +  transfers(level) · dma_setup(level)
    transfer = max_port  port(p)               (Target.transfer_time)
    compute  = per-engine roofline over the group's op kinds
    runtime  = max(compute, transfer)          (hw.modeled_runtime)

Levels sharing a DMA port serialize; distinct ports (hbm vs the ici/noc
interconnect) overlap, so a segment's collective stream hides under its
memory traffic — and vice versa — exactly as the DES replays it.  With
one port in play the max degenerates to the old Σ-over-levels model
bit-exactly, which keeps every single-chip plan identical.  Collectives
(:class:`~repro_torch.core.ftl.ir.CollectiveNode`) price their ring-formula
wire bytes against the target's interconnect level on that level's port
(:class:`CollectiveCost` entries on the report), independent of the tile
assignment.

The compute term is priced per op: each op's FLOPs run on the engine
``Target.engine_rate`` assigns its kind (the implicit single ``core``
engine at ``Target.flops`` when the target declares none — the legacy
single-rate model, bit-identical), divided by an **MXU lane-utilization
factor**: a GEMM whose output-lane (last-axis) tile is narrower than the
kernel's ``mxu_preferred`` feeds only that fraction of the systolic
array's columns, so its effective rate drops by ``min(1, tile/preferred)``
(:func:`lane_utilization`).  The factor is 1 for any lane tile ≥ the
preferred width and monotone non-decreasing in the tile size, so the
solver's optimistic full-size prune stays a valid lower bound and
aligned plans price exactly as before.  Engines overlap; work within one
engine serializes — ``Target.compute_time_by_kind`` semantics.

Compute time therefore depends on tile sizes only through utilization
(never increasing as tiles grow), so within one group the runtime
objective still reduces to: minimize transfer time while it dominates,
and break pure-compute-bound ties by (traffic, DMA count) — fusion that
buys no runtime must still not cost bytes.

Each streamed tensor is assigned a *home* backing level by the target
(smallest-first first-fit over level capacities — ``Target.assign_homes``),
so a large intermediate spills past a full L2 to L3 exactly like the
paper's overflow regime, and its traffic is priced at the deep level's
bandwidth.

Traffic model
-------------
Given a tile assignment and a *grid order* (outermost → innermost), a tensor
``T`` is re-fetched every time a grid dim **outside** ``dims(T)`` that is
**outer** than T's innermost grid dim advances (the Pallas pipeline — like
Deeploy's DMA scheduler — skips the copy while T's block index is
unchanged).  Hence::

    fetches(T) = Π_{g ∈ dims(T)∩grid} n(g) · Π_{g ∉ dims(T), g outer than
                 innermost grid dim of T} n(g)
    traffic(T) = bytes_tile(T) · fetches(T)
               = bytes_full(T) · revisit(T)

Contraction grid dims are forced innermost so outputs accumulate in VMEM and
are written exactly once (kernel-policy: ``contract_accumulate``).

Intermediates of a fused group contribute **zero** backing-store traffic —
that is the paper's entire point — but do occupy fast memory
(single-buffered: they are produced and consumed in-core).  Streamed
tensors are charged the fast level's ``buffer_depth`` (1 for a
cache-backed fast level, 2 for a DMA double-buffered pipeline, 3+ for
deeper prefetch) instead of a hard-coded ×2.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Sequence

from repro_torch.core import hw as hwlib

from .constraints import DimConstraint, accumulator_tensors
from .ir import CollectiveNode, FusionGroup, OpNode, Role, TensorSpec


@dataclasses.dataclass(frozen=True)
class OpCompute:
    """Compute pricing of one op of the group — the per-engine partition
    the schedule lowering (``repro.sim.schedule``) consumes."""

    name: str
    kind: str
    engine: str            # Target engine the kind is assigned to
    flops: int             # raw modeled FLOPs of the op
    utilization: float     # MXU lane-utilization factor in (0, 1]
    seconds: float         # flops / (engine rate · utilization)


@dataclasses.dataclass(frozen=True)
class CollectiveCost:
    """Wire pricing of one :class:`~repro_torch.core.ftl.ir.CollectiveNode` in
    the group — what the schedule lowering turns into per-step ``Comm``
    events on the interconnect's DMA port.

    ``pre`` marks a collective whose operand streams *into* the segment
    (its input tensor's bound role is INPUT): the link traffic can run
    ahead of the consuming compute like a prefetch.  A collective fed by
    an in-segment producer (``pre=False``, ``producer`` names the op)
    starts behind that producer's compute; if its output is also
    consumed inside the segment (``blocking``) the rest of the step's
    compute chain waits for the wire — the real serialization cost of
    fusing a collective mid-chain, which per-step chunking then hides
    across the tile pipeline."""

    name: str
    comm: str                # all_gather | reduce_scatter | all_reduce
    level: str               # interconnect level name (ici / noc)
    bytes: int               # wire bytes per chip (ring formula)
    transfers: int           # link messages per chip
    pre: bool
    producer: str = ""       # in-segment producer op ("" when streamed)
    blocking: bool = False   # output consumed later in the segment


@dataclasses.dataclass(frozen=True)
class CostReport:
    traffic_bytes: int           # fast<->backing total
    dma_transfers: int           # number of block copies
    vmem_bytes: int              # peak fast-memory footprint (pipelined)
    grid: tuple[tuple[str, int], ...]   # (dim, n_tiles) outer->inner
    per_tensor_traffic: dict[str, int]
    macs: int
    transfer_time_s: float = 0.0        # modeled DMA time
    compute_time_s: float = 0.0         # per-engine roofline (max/engine)
    flops: int = 0                      # modeled group FLOPs
    per_level_traffic: dict[str, int] = dataclasses.field(
        default_factory=dict)           # level name -> bytes
    per_level_transfers: dict[str, int] = dataclasses.field(
        default_factory=dict)           # level name -> DMA count
    tensor_homes: dict[str, str] = dataclasses.field(
        default_factory=dict)           # tensor name -> home level name
    tensor_depths: dict[str, int] = dataclasses.field(
        default_factory=dict)           # tensor name -> staging depth
    op_compute: tuple[OpCompute, ...] = ()
    per_engine_compute_s: dict[str, float] = dataclasses.field(
        default_factory=dict)           # engine name -> serialized seconds
    collectives: tuple[CollectiveCost, ...] = ()

    @property
    def modeled_runtime_s(self) -> float:
        """The solver's objective: compute and DMA overlap, the segment
        takes whichever dominates (``hw.modeled_runtime``)."""
        return hwlib.modeled_runtime(self.compute_time_s,
                                     self.transfer_time_s)

    @property
    def compute_bound(self) -> bool:
        return self.compute_time_s >= self.transfer_time_s

    @property
    def n_steps(self) -> int:
        """Tile steps of the schedule: the grid's total block count (1
        for a single-block plan) — what the schedule IR replays."""
        steps = 1
        for _, c in self.grid:
            steps *= c
        return steps

    @property
    def mxu_utilization(self) -> float:
        """FLOP-weighted lane utilization of the assignment (1.0 = every
        GEMM tile feeds full MXU columns)."""
        if not self.op_compute:
            return 1.0
        eff = sum(oc.flops / oc.utilization for oc in self.op_compute)
        return self.flops / eff if eff else 1.0

    @property
    def arithmetic_intensity(self) -> float:
        return (2.0 * self.macs) / max(1, self.traffic_bytes)


def n_tiles(size: int, tile: int) -> int:
    return -(-size // tile)


def vmem_usage(
    group: FusionGroup,
    tiles: Mapping[str, int],
    cons: Mapping[str, DimConstraint],
    *,
    buffer_depth: int = 2,
    depths: Mapping[str, int] | None = None,
) -> int:
    """Peak fast-memory footprint of a tile assignment.

    Streamed tensors (inputs/weights/outputs) are charged
    ``buffer_depth`` tile buffers — the staging pipeline of the target's
    fast level (``Target.fast.buffer_depth``): 1 when a hardware cache
    does the prefetching, 2 for classic DMA double-buffering, 3+ for
    deeper pipelines.  ``depths`` overrides the charge per tensor name —
    the backing-level-aware ``max(fast.depth, home.depth)`` staging
    (:func:`staging_depths`); tensors it does not name fall back to
    ``buffer_depth``.  Fused-away intermediates and accumulators live
    single-buffered (produced and consumed in-core).
    """
    if buffer_depth < 1:
        raise ValueError(f"buffer_depth must be >= 1, got {buffer_depth}")
    depths = depths or {}
    total = 0
    for t in group.tensors.values():
        b = t.bytes_tile(tiles)
        if t.role in (Role.INPUT, Role.WEIGHT, Role.OUTPUT):
            total += b * depths.get(t.name, buffer_depth)
        elif t.role is Role.INTERMEDIATE:
            total += b
    for acc in accumulator_tensors(group, tiles, cons):
        total += acc.bytes_tile(tiles)
    return total


def staging_depths(
    group: FusionGroup,
    cons: Mapping[str, DimConstraint],
    target: hwlib.Target,
) -> dict[str, int]:
    """Per-streamed-tensor staging depth: ``max(fast.depth, home.depth)``
    (``Target.staging_depth``) at the tensor's home backing level.

    Home levels depend only on the *full* tensor footprints — never on
    the tile assignment — so the depths are one fixed map per
    (group, target): the solver computes them once, the feasibility
    prune stays monotone in tile sizes, and the schedule lowering
    (``repro.sim.schedule``) reuses the identical map for its buffer-slot
    hazards.
    """
    full_sizes = {d: cons[d].size for d in cons}
    footprints = {t.name: t.bytes_full(full_sizes)
                  for t in group.hbm_tensors()}
    homes = target.assign_homes(footprints)
    return {n: target.staging_depth(lv) for n, lv in homes.items()}


def lane_utilization(op: OpNode, tiles: Mapping[str, int]) -> float:
    """MXU lane-utilization of one op's tile assignment.

    A GEMM whose output lane (last-axis) tile is narrower than the
    kernel policy's ``mxu_preferred`` width occupies only
    ``tile/preferred`` of the systolic array's columns — a head-dim-64
    PV product on a 128-lane MXU runs at half rate no matter how the
    other dims tile.  ``min(1, tile/preferred)`` is monotone
    non-decreasing in the tile size (a ≥-preferred tile always prices at
    peak), which the solver's optimistic full-size prune relies on.
    Non-GEMM ops are not discounted: the VPU consumes whole vregs
    regardless and their compute term is second-order.
    """
    if op.kind != "gemm":
        return 1.0
    lane = op.output.dims[-1]
    tile = tiles.get(lane)
    if tile is None:
        return 1.0
    return min(1.0, tile / op.policy.mxu_preferred)


def compute_costs(
    group: FusionGroup,
    tiles: Mapping[str, int],
    full_sizes: Mapping[str, int],
    target: hwlib.Target,
    engine_overrides: Mapping[str, str] | None = None,
) -> tuple[tuple[OpCompute, ...], dict[str, float], float]:
    """Per-op / per-engine compute pricing of an assignment.

    Returns ``(op_compute, per_engine_seconds, compute_time_s)``.  Each
    op's FLOPs (at the constraint sizes) run on the engine its kind maps
    to, rate-discounted by :func:`lane_utilization`; engines overlap, so
    the group's compute time is the busiest engine's serialized time.
    Engine-less targets collapse to the legacy single-rate formula via
    effective FLOPs (``Σ flops/utilization``), bit-identical to
    ``Target.compute_time_s`` when every tile is lane-aligned.

    ``engine_overrides`` (op kind → engine name, entries drawn from
    ``Target.engines_for_kind``) pins kinds to specific engines instead
    of the default fastest-match rule — the autotuner's load-balancing
    knob: analytically never better than the default (the default picks
    the fastest engine per kind), but a deliberate slower-engine
    assignment can win simulated runtime by overlapping with the
    bottleneck engine.
    """
    overrides = engine_overrides or {}
    ops: list[OpCompute] = []
    per_engine: dict[str, float] = {}
    eff_total = 0.0
    for op in group.ops:
        f = op.flops(full_sizes)
        if f == 0:
            # collectives (flops_per_macs=0) are pure wire traffic: they
            # occupy no engine, so they never appear in the compute chain
            continue
        util = lane_utilization(op, tiles)
        if op.kind in overrides:
            engine = overrides[op.kind]
            rate = target.engine_rate_for(op.kind, engine)
        else:
            engine, rate = target.engine_rate(op.kind)
        secs = f / (rate * util)
        ops.append(OpCompute(name=op.name, kind=op.kind, engine=engine,
                             flops=f, utilization=util, seconds=secs))
        per_engine[engine] = per_engine.get(engine, 0.0) + secs
        eff_total += f if util == 1.0 else f / util
    if target.engines:
        compute_s = max(per_engine.values(), default=0.0)
    else:
        compute_s = hwlib.compute_time(eff_total, target.flops)
    return tuple(ops), per_engine, compute_s


def _revisit(
    tensor: TensorSpec,
    order: Sequence[str],
    counts: Mapping[str, int],
) -> int:
    """Revisit factor for ``tensor`` under grid ``order`` (outer→inner)."""
    tdims = set(tensor.dims)
    # innermost grid position occupied by one of T's dims
    inner_pos = -1
    for i, g in enumerate(order):
        if g in tdims:
            inner_pos = i
    rev = 1
    for i, g in enumerate(order):
        if g not in tdims and i < inner_pos:
            rev *= counts[g]
    return rev


def evaluate(
    group: FusionGroup,
    tiles: Mapping[str, int],
    cons: Mapping[str, DimConstraint],
    *,
    target: hwlib.Target | None = None,
    order: Sequence[str] | None = None,
    engine_overrides: Mapping[str, str] | None = None,
) -> CostReport:
    """Cost of an assignment on ``target`` (None → the default target).

    If ``order`` is None the best grid order is chosen by enumeration
    over the tiled dims (contract dims pinned inner), minimizing modeled
    runtime with (traffic, DMA count) as the tie-break — compute time is
    order-invariant, so in the compute-bound regime the order with the
    fewest bytes wins.  ``engine_overrides`` pins op kinds to specific
    engines (see :func:`compute_costs`).
    """
    target = target if target is not None else hwlib.default_target()
    counts = {d: n_tiles(cons[d].size, tiles[d]) for d in tiles}
    tiled = [d for d, c in counts.items() if c > 1]
    contract = [d for d in tiled if cons[d].is_contract]
    free = [d for d in tiled if not cons[d].is_contract]

    hbm = group.hbm_tensors()
    full_sizes = {d: cons[d].size for d in cons}
    footprints = {t.name: t.bytes_full(full_sizes) for t in hbm}
    homes = target.assign_homes(footprints)
    depths = {n: target.staging_depth(lv) for n, lv in homes.items()}
    # fixed per-tensor weights: home levels depend only on full tensor
    # sizes, so the modeled time stays monotone in tile sizes and the
    # solver's optimistic full-size prune remains a valid lower bound.
    w_bytes = {n: 1.0 / homes[n].bw_bytes_per_s for n in homes}
    w_dma = {n: homes[n].dma_setup_s for n in homes}
    w_port = {n: homes[n].dma_port for n in homes}

    # collectives: a fixed wire cost per segment run, priced against the
    # interconnect level's bandwidth/setup on its own DMA port.  Tile-
    # independent (the whole payload crosses the link however the grid
    # tiles), so per-port times stay monotone non-increasing in tile
    # sizes and the solver's prunes survive.
    colls = [op for op in group.ops
             if isinstance(op, CollectiveNode) and op.mesh_size > 1]
    comm_costs: tuple[CollectiveCost, ...] = ()
    comm_time_s = 0.0
    comm_port = None
    if colls:
        icl = target.interconnect
        if icl is None:
            raise ValueError(
                f"group {group.name} contains collectives but target "
                f"{target.name} has no interconnect level to price them on"
            )
        comm_port = icl.dma_port
        costs = []
        for op in colls:
            cb = op.comm_bytes(full_sizes)
            ct = op.comm_transfers(full_sizes)
            role = group.tensors[op.inputs[0].name].role
            producer = next(
                (o.name for o in group.ops
                 if o is not op and o.output.name == op.inputs[0].name),
                "")
            consumed = any(
                op.output.name in (t.name for t in o.inputs)
                for o in group.ops if o is not op)
            costs.append(CollectiveCost(
                name=op.name, comm=op.comm, level=icl.name,
                bytes=cb, transfers=ct, pre=role is Role.INPUT,
                producer=producer, blocking=consumed))
            comm_time_s += cb / icl.bw_bytes_per_s + ct * icl.dma_setup_s
        comm_costs = tuple(costs)

    def traffic_for(
        ordr: Sequence[str],
    ) -> tuple[float, int, int, dict[str, int], dict[str, int]]:
        per = {}
        fetches_per = {}
        tot = 0
        dma = 0
        port_time: dict[str, float] = {}
        if comm_port is not None:
            port_time[comm_port] = comm_time_s
        for t in hbm:
            if t.role is Role.OUTPUT:
                # accumulated in fast memory; written once per output block
                rev = 1
                fetches = 1
                for d in t.dims:
                    fetches *= counts.get(d, 1)
            else:
                rev = _revisit(t, ordr, counts)
                fetches = rev
                for d in t.dims:
                    fetches *= counts.get(d, 1)
            b = footprints[t.name] * rev
            per[t.name] = b
            fetches_per[t.name] = fetches
            tot += b
            dma += fetches
            p = w_port[t.name]
            port_time[p] = port_time.get(p, 0.0) \
                + b * w_bytes[t.name] + fetches * w_dma[t.name]
        # ports overlap: the ranking time is the busiest port's, matching
        # Target.transfer_time's max-over-ports model
        time_s = max(port_time.values(), default=0.0)
        return time_s, tot, dma, per, fetches_per

    # FLOPs at the *constraint* sizes, not group.total_flops(): under
    # sharded_sizes the solver prices the per-shard problem, and the
    # compute term must cover the same per-shard work the transfer term
    # does or sharded plans would look spuriously compute-bound.
    op_costs, per_engine, compute_s = compute_costs(
        group, tiles, full_sizes, target, engine_overrides)
    flops = sum(oc.flops for oc in op_costs)

    if order is None:
        best = None
        # contract dims innermost (any relative order); permute free dims.
        for perm in itertools.permutations(free) if free else [()]:
            for cperm in itertools.permutations(contract) if contract else [()]:
                ordr = list(perm) + list(cperm)
                time_s, tot, dma, per, fper = traffic_for(ordr)
                key = (hwlib.modeled_runtime(compute_s, time_s), tot, dma)
                if best is None or key < best[0]:
                    best = (key, time_s, ordr, per, fper)
        _, time_s, ordr, per, fper = best
    else:
        ordr = list(order)
        time_s, tot, dma, per, fper = traffic_for(ordr)

    lvl_bytes: dict[str, int] = {}
    lvl_dma: dict[str, int] = {}
    for n, b in per.items():
        lname = homes[n].name
        lvl_bytes[lname] = lvl_bytes.get(lname, 0) + b
        lvl_dma[lname] = lvl_dma.get(lname, 0) + fper[n]
    for cc in comm_costs:
        lvl_bytes[cc.level] = lvl_bytes.get(cc.level, 0) + cc.bytes
        lvl_dma[cc.level] = lvl_dma.get(cc.level, 0) + cc.transfers
    tot = sum(lvl_bytes.values())
    dma = sum(lvl_dma.values())

    return CostReport(
        traffic_bytes=tot,
        dma_transfers=dma,
        vmem_bytes=vmem_usage(
            group, tiles, cons,
            buffer_depth=target.fast.buffer_depth,
            depths=depths),
        grid=tuple((d, counts[d]) for d in ordr),
        per_tensor_traffic=per,
        macs=group.total_macs(),
        # Target.transfer_time / compute_time_s are the canonical
        # formulas; the per-tensor weights inside traffic_for are their
        # factored-out form used only to rank grid orders cheaply.
        transfer_time_s=target.transfer_time(lvl_bytes, lvl_dma),
        compute_time_s=compute_s,
        flops=flops,
        per_level_traffic=lvl_bytes,
        per_level_transfers=lvl_dma,
        tensor_homes={n: lv.name for n, lv in homes.items()},
        tensor_depths=depths,
        op_compute=op_costs,
        per_engine_compute_s=per_engine,
        collectives=comm_costs,
    )


def min_traffic_bound(group: FusionGroup, cons: Mapping[str, DimConstraint]) -> int:
    """Optimistic lower bound: every streamed tensor moved exactly once."""
    sizes = {d: c.size for d, c in cons.items()}
    return sum(t.bytes_full(sizes) for t in group.hbm_tensors())
