"""First-class memory-hierarchy targets for the FTL planning stack.

The paper's claim is about a *multi-level* software-managed hierarchy:
fusion on Siracusa trades L2/L3 (off-chip) transfers against L1 residency,
with DMA setup cost a second-order term.  Everything that prices a plan —
the tile solver, the fusion partitioner, the executor registry, the
roofline — therefore takes a :class:`Target` instead of a bare VMEM-budget
int, so the whole stack agrees about the machine and re-planning for a
different hierarchy is one argument, not a constant hunt.

A :class:`Target` is an ordered fast→backing list of :class:`MemoryLevel`s
plus a peak-FLOP/s figure:

* ``levels[0]`` is the software-managed fast memory the planner tiles for
  (VMEM on TPU, L1 TCDM on Siracusa).  Its ``capacity_bytes`` is the tile
  budget and its ``buffer_depth`` the pipeline multiplier every streamed
  tile is charged at (1 for a cache-backed level, 2 for DMA
  double-buffering); its bandwidth/DMA fields describe the core↔fast
  path and are not used by the boundary cost model.
* ``levels[1:]`` are the backing tiers, shallow→deep.  Each level's
  ``bw_bytes_per_s`` / ``dma_setup_s`` describe the DMA path between that
  level and the fast memory.  The cost model assigns every streamed
  tensor a *home level* (smallest-first first-fit, so a big intermediate
  spills past a full L2 exactly like the paper's Fig. 3 regime) and
  prices its traffic at that level's bandwidth.

A :class:`Target` may additionally carry :class:`Engine` entries — named
compute units with a per-op-kind FLOP/s rate map (the Siracusa NPU runs
GEMMs while the RV32 cluster runs GeLU).  Work of different engines
overlaps; work on one engine serializes, so a multi-engine target's
compute time is ``max`` over engines of each engine's serialized time.
An engine-less target keeps the single ``Target.flops`` rate for every
kind (all existing presets are unchanged).

Presets: :data:`TPU_V5E`, :data:`CPU_CACHE` (a cache-blocked x86 core),
:data:`RV32_L1_L2` (Siracusa-like RV32 cluster: L1 TCDM fast level with
L2/L3 backing — the paper's platform), :data:`RV32_NPU` (the same
hierarchy plus the N-EUREKA NPU as a separate GEMM engine) and
:data:`H100` (the PyTorch port's serving card: one thread block's shared
memory as the fast level, then L2, then HBM).

The process-wide default is :func:`default_target` (``set_default_target``
override, then the ``FTL_TARGET`` env var, then :func:`detect_target`'s
reading of ``torch.cuda``); planners resolve ``target=None`` through it
and carry the resolved target in their plan-cache keys, so switching
targets can never serve a stale plan.

This module is the PyTorch port's own copy of ``repro.core.hw``: every
preset the reference has prices exactly as it does there.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Mapping

KB = 1 << 10
MB = 1 << 20
GB = 1 << 30


@dataclasses.dataclass(frozen=True)
class MemoryLevel:
    """One tier of a software-managed memory hierarchy.

    For backing levels (``Target.levels[1:]``), ``bw_bytes_per_s`` and
    ``dma_setup_s`` describe the DMA path between this level and the fast
    level — the boundary the planner's traffic crosses.

    ``buffer_depth`` is the number of in-flight tile buffers a streamed
    tensor occupies when this level is the planner's *fast* memory: 1 for
    a hardware-cache-backed level (the cache prefetches; no software
    staging copies), 2 for classic DMA double-buffering (VMEM, L1 TCDM),
    3 for deeper prefetch pipelines.  The cost model charges it per
    streamed tensor instead of a hard-coded ×2, so the solver trades
    pipeline depth against tile size per hierarchy.

    On a *backing* level the field is a staging requirement for tensors
    homed there: a streamed tensor is charged
    ``max(fast.buffer_depth, home.buffer_depth)`` buffers
    (``Target.staging_depth``), so deepening a slow tier buys its
    tensors a longer prefetch runway at a footprint cost.  Presets
    declare backing depth 1 (no extra requirement), which makes the max
    degenerate to the fast depth — the pre-per-level behaviour.

    ``dma_port`` names the physical DMA engine/link that moves this
    level's traffic.  Levels sharing a port serialize against each
    other; traffic on distinct ports overlaps (``Target.transfer_time``
    is a max over ports).  Every on-package tier keeps the default
    ``"dma"`` port — a single port in play degenerates the max to the
    old Σ-over-levels model bit-exactly — while interconnect tiers
    (``ici``, ``noc``) declare their own port, which is what lets a
    collective stream overlap the same segment's HBM traffic.
    """

    name: str
    capacity_bytes: int
    bw_bytes_per_s: float
    dma_setup_s: float = 0.0
    buffer_depth: int = 2
    dma_port: str = "dma"

    @property
    def is_interconnect(self) -> bool:
        """Interconnect-class tier (chip-to-chip link, not a memory): the
        ``1 << 50`` capacity sentinel presets use for ici/noc levels.
        Such a level prices collective traffic but is never a spill home
        — remote HBM has no business backing a local streamed tensor."""
        return self.capacity_bytes >= 1 << 48

    def __post_init__(self):
        if self.capacity_bytes <= 0:
            raise ValueError(f"level {self.name}: capacity must be positive")
        if self.bw_bytes_per_s <= 0:
            raise ValueError(f"level {self.name}: bandwidth must be positive")
        if self.buffer_depth < 1:
            raise ValueError(
                f"level {self.name}: buffer_depth must be >= 1, got "
                f"{self.buffer_depth}"
            )


@dataclasses.dataclass(frozen=True)
class Engine:
    """One compute unit of a :class:`Target` with per-op-kind rates.

    ``rates`` maps an op kind (``'gemm'``, ``'elementwise'``, ...) to the
    FLOP/s this engine sustains for that kind; the pseudo-kind ``'*'`` is
    a catch-all rate for any kind not named by *any* engine (a scalar
    cluster runs whatever the accelerator cannot).  Work assigned to one
    engine serializes; distinct engines run concurrently — that is the
    paper's cluster+NPU overlap, and what the discrete-event simulator
    (``repro.sim``) replays per tile step.

    Frozen and tuple-backed so an engine-carrying Target stays hashable
    (plan-cache keys).
    """

    name: str
    rates: tuple[tuple[str, float], ...]

    def __post_init__(self):
        for kind, rate in self.rates:
            if rate <= 0:
                raise ValueError(
                    f"engine {self.name}: rate for {kind!r} must be "
                    f"positive, got {rate}"
                )


@dataclasses.dataclass(frozen=True)
class Target:
    """A machine the planner prices plans for: memory levels + peak FLOPs
    (+ optionally named per-op-kind :class:`Engine`\\s).

    Hashable (all-frozen), so it participates directly in every plan
    cache key.
    """

    name: str
    levels: tuple[MemoryLevel, ...]
    flops: float
    engines: tuple[Engine, ...] = ()

    def __post_init__(self):
        if len(self.levels) < 2:
            raise ValueError(
                f"target {self.name}: need a fast level and at least one "
                f"backing level, got {len(self.levels)}"
            )
        for shallow, deep in zip(self.levels, self.levels[1:]):
            if deep.capacity_bytes < shallow.capacity_bytes:
                raise ValueError(
                    f"target {self.name}: level {deep.name} "
                    f"({deep.capacity_bytes} B) smaller than the level "
                    f"above it ({shallow.name}, {shallow.capacity_bytes} B)"
                )
        names = [e.name for e in self.engines]
        if len(set(names)) != len(names):
            raise ValueError(
                f"target {self.name}: duplicate engine names {names}"
            )

    # ------------------------------------------------------------------
    @property
    def fast(self) -> MemoryLevel:
        """The software-managed fast level the solver tiles for."""
        return self.levels[0]

    @property
    def backing(self) -> tuple[MemoryLevel, ...]:
        return self.levels[1:]

    @property
    def fast_capacity(self) -> int:
        """The tile budget (bytes) — what `vmem_budget` used to be."""
        return self.fast.capacity_bytes

    @property
    def interconnect(self) -> MemoryLevel | None:
        """The chip-to-chip interconnect tier (ici/noc), if this target
        has one — the level collective traffic is priced against."""
        for lv in self.backing:
            if lv.is_interconnect:
                return lv
        return None

    # ------------------------------------------------------------------
    def with_fast_capacity(self, capacity_bytes: int) -> "Target":
        """This target with the fast level resized — the budget-sweep hook
        tests and benchmarks use instead of raw ints.

        A backing level the new fast level outgrows is *dropped* (its
        traffic reprices at the next deeper tier), never silently
        inflated: a scratchpad larger than L2 cannot be backed by that
        L2, and inflating it would misprice spill traffic at the shallow
        tier's bandwidth.  The deepest level is always kept.
        """
        fast = dataclasses.replace(
            self.fast, capacity_bytes=int(capacity_bytes)
        )
        kept = tuple(lv for lv in self.backing[:-1]
                     if lv.capacity_bytes >= capacity_bytes)
        deep = self.backing[-1]
        if deep.capacity_bytes < capacity_bytes:
            deep = dataclasses.replace(
                deep, capacity_bytes=int(capacity_bytes)
            )
        return dataclasses.replace(
            self, name=f"{self.name}@{capacity_bytes}B",
            levels=(fast,) + kept + (deep,)
        )

    def with_buffer_depth(self, depth: int) -> "Target":
        """This target with the fast level's pipeline depth replaced —
        the hook tests/benchmarks use to sweep staging depth.  A changed
        depth produces a distinct (differently named, differently
        hashed) target, so plan caches keyed on the target can never
        serve a plan made for a different depth; the current depth
        returns ``self`` (no duplicate cache entries for the identical
        machine), and re-sweeping replaces a previous ``@depthN`` suffix
        instead of stacking another."""
        depth = int(depth)
        if depth == self.fast.buffer_depth:
            return self
        fast = dataclasses.replace(self.fast, buffer_depth=depth)
        base = self.name.split("@depth")[0]
        return dataclasses.replace(
            self, name=f"{base}@depth{depth}",
            levels=(fast,) + self.backing
        )

    def with_level_buffer_depth(self, level: str, depth: int) -> "Target":
        """This target with the *named* level's pipeline depth replaced —
        the autotuner's per-level depth knob (``repro.tune``).  For the
        fast level the depth is the staging-pipeline multiplier; for a
        backing level it deepens the staging of tensors *homed* there
        (the cost model charges ``max(fast.depth, home.depth)`` buffers
        per streamed tensor).  Like :meth:`with_buffer_depth`, a changed
        depth yields a distinct (differently named, differently hashed)
        target; the current depth returns ``self``, and re-sweeping the
        same level replaces its previous ``@<level>dN`` suffix instead of
        stacking another."""
        depth = int(depth)
        by_name = {lv.name: lv for lv in self.levels}
        if level not in by_name:
            raise KeyError(
                f"target {self.name}: no level named {level!r}; levels: "
                f"{[lv.name for lv in self.levels]}"
            )
        if depth == by_name[level].buffer_depth:
            return self
        new_levels = tuple(
            dataclasses.replace(lv, buffer_depth=depth)
            if lv.name == level else lv
            for lv in self.levels
        )
        parts = [p for p in self.name.split("@")
                 if not (p.startswith(f"{level}d")
                         and p[len(level) + 1:].isdigit())]
        name = "@".join(parts) + f"@{level}d{depth}"
        return dataclasses.replace(self, name=name, levels=new_levels)

    def staging_depth(self, home: "MemoryLevel") -> int:
        """Buffers a streamed tensor homed at ``home`` is charged: the
        deeper of the fast level's pipeline and the home level's staging
        depth.  A deepened backing level (``with_level_buffer_depth``)
        buys its tensors a longer prefetch runway; it can never *reduce*
        the fast level's own pipeline, so with all-default depths this is
        exactly ``fast.buffer_depth`` (every preset ships backing depths
        ≤ the fast depth — bit-identical costs)."""
        return max(self.fast.buffer_depth, home.buffer_depth)

    # ------------------------------------------------------------------
    def assign_homes(
        self, footprints: Mapping[str, int]
    ) -> dict[str, MemoryLevel]:
        """Home backing level per tensor: smallest-first first-fit.

        Small tensors claim the shallow tiers; whatever no longer fits
        spills deeper (the deepest *memory* level always accepts).  This
        is the paper's L2-overflow mechanism: a big fused-away
        intermediate that *would* have streamed now never competes for
        L2 at all, while the unfused schedule's intermediate spills to
        L3.

        Interconnect-class levels (``MemoryLevel.is_interconnect``: the
        ``1 << 50`` ici/noc sentinels) are excluded from both the
        first-fit and the spill fallback — their "capacity" is remote
        memory reachable over the link, not a home for a locally
        streamed tensor, and their sentinel size would otherwise win
        every overflow.  Spills land on the deepest memory tier (hbm on
        ``tpu_v5e``, l3 on the rv32 presets) instead.
        """
        memory = [lv for lv in self.backing if not lv.is_interconnect]
        if not memory:                # all-interconnect hierarchy: degenerate
            memory = list(self.backing)
        free = {lv.name: lv.capacity_bytes for lv in memory}
        homes: dict[str, MemoryLevel] = {}
        for tname in sorted(footprints, key=lambda n: (footprints[n], n)):
            placed = None
            for lv in memory[:-1]:
                if footprints[tname] <= free[lv.name]:
                    free[lv.name] -= footprints[tname]
                    placed = lv
                    break
            homes[tname] = placed if placed is not None else memory[-1]
        return homes

    def transfer_time_by_port(
        self,
        bytes_by_level: Mapping[str, int],
        transfers_by_level: Mapping[str, int],
    ) -> dict[str, float]:
        """Serialized DMA time per port:
        ``Σ_{level on port} bytes/bw + transfers·dma_setup``."""
        by_name = {lv.name: lv for lv in self.backing}
        per_port: dict[str, float] = {}
        for name, b in bytes_by_level.items():
            lv = by_name[name]
            per_port[lv.dma_port] = per_port.get(lv.dma_port, 0.0) \
                + b / lv.bw_bytes_per_s
        for name, n in transfers_by_level.items():
            lv = by_name[name]
            per_port[lv.dma_port] = per_port.get(lv.dma_port, 0.0) \
                + n * lv.dma_setup_s
        return per_port

    def transfer_time(
        self,
        bytes_by_level: Mapping[str, int],
        transfers_by_level: Mapping[str, int],
    ) -> float:
        """Modeled DMA time: levels sharing a ``dma_port`` serialize
        (Σ bytes/bw + transfers·dma_setup within the port); distinct
        ports overlap, so the total is the ``max`` over ports.  With a
        single port in play this is bit-identical to the old
        Σ-over-levels model; it diverges only when interconnect traffic
        (collectives on ici/noc) runs alongside memory traffic."""
        per_port = self.transfer_time_by_port(
            bytes_by_level, transfers_by_level)
        return max(per_port.values(), default=0.0)

    def transfer_time_serialized(
        self,
        bytes_by_level: Mapping[str, int],
        transfers_by_level: Mapping[str, int],
    ) -> float:
        """The pre-multi-port model — Σ over *all* levels regardless of
        port, as if one DMA engine moved everything.  Kept as the
        no-overlap baseline bench_mesh gates the simulated overlap
        against."""
        per_port = self.transfer_time_by_port(
            bytes_by_level, transfers_by_level)
        return sum(per_port.values())

    def compute_time_s(self, flops: float) -> float:
        """Modeled compute time of ``flops`` at this target's peak rate
        (:func:`compute_time` — shared with the roofline's HW view, so
        the planner and the roofline can never disagree about how long
        an op's arithmetic takes on the same machine)."""
        return compute_time(flops, self.flops)

    # ------------------------------------------------------------------
    # per-engine compute
    # ------------------------------------------------------------------
    def engine_rate(self, kind: str) -> tuple[str, float]:
        """(engine name, FLOP/s) that runs ops of ``kind``.

        Engine-less targets run everything on an implicit ``'core'``
        engine at ``Target.flops``.  With engines, an exact-kind rate
        wins over a catch-all ``'*'`` rate; among several matches the
        fastest engine takes the work (a GEMM never runs on the scalar
        cluster while an NPU is present).
        """
        if not self.engines:
            return ("core", self.flops)
        exact = [(e.name, r) for e in self.engines
                 for k, r in e.rates if k == kind]
        if exact:
            return max(exact, key=lambda nr: nr[1])
        wild = [(e.name, r) for e in self.engines
                for k, r in e.rates if k == "*"]
        if wild:
            return max(wild, key=lambda nr: nr[1])
        raise ValueError(
            f"target {self.name}: no engine runs op kind {kind!r} and "
            f"none advertises a '*' catch-all rate"
        )

    def engines_for_kind(self, kind: str) -> tuple[str, ...]:
        """Names of every engine that *can* run ops of ``kind`` (an exact
        rate or a ``'*'`` catch-all) — the autotuner's assignment domain.
        Engine-less targets expose the implicit ``'core'`` engine."""
        if not self.engines:
            return ("core",)
        return tuple(
            e.name for e in self.engines
            if any(k in (kind, "*") for k, _ in e.rates)
        )

    def engine_rate_for(self, kind: str, engine: str) -> float:
        """FLOP/s of ``engine`` running ops of ``kind`` (exact-kind rate
        wins over its ``'*'`` catch-all).  Raises if the engine cannot
        run the kind — the autotuner only proposes assignments drawn from
        :meth:`engines_for_kind`."""
        if not self.engines:
            if engine != "core":
                raise ValueError(
                    f"target {self.name}: no engine named {engine!r} "
                    f"(engine-less targets expose only 'core')"
                )
            return self.flops
        for e in self.engines:
            if e.name != engine:
                continue
            rates = dict(e.rates)
            if kind in rates:
                return rates[kind]
            if "*" in rates:
                return rates["*"]
            raise ValueError(
                f"target {self.name}: engine {engine!r} has no rate for "
                f"op kind {kind!r}"
            )
        raise ValueError(
            f"target {self.name}: no engine named {engine!r}; engines: "
            f"{[e.name for e in self.engines]}"
        )

    def engine_times(self, flops_by_kind: Mapping[str, float]
                     ) -> dict[str, float]:
        """Serialized busy time per engine for the given work mix."""
        times: dict[str, float] = {e.name: 0.0 for e in self.engines} \
            or {"core": 0.0}
        for kind, flops in flops_by_kind.items():
            name, rate = self.engine_rate(kind)
            times[name] += flops / rate
        return times

    def compute_time_by_kind(self, flops_by_kind: Mapping[str, float]
                             ) -> float:
        """Compute time of a work mix: engines overlap, each serializes.

        Engine-less targets reduce to the single-rate
        ``compute_time(Σ flops, Target.flops)`` (bit-identical to the
        legacy formula so existing plan pins survive); with engines the
        mix is split by kind and the slowest engine's serialized time is
        the floor — fusing a cluster-side epilogue under an NPU GEMM
        then genuinely hides it, the paper's −60.1 % regime.
        """
        if not self.engines:
            return compute_time(float(sum(flops_by_kind.values())),
                                self.flops)
        return max(self.engine_times(flops_by_kind).values(), default=0.0)

    # ------------------------------------------------------------------
    @staticmethod
    def calibrated(measurements, base: "Target | None" = None) -> "Target":
        """A preset-shaped target with constants *fitted from measured
        wall-clock runs* (``repro_torch.calib``): same level names,
        capacities, ports and engine structure as ``base`` (default: the
        process default target), but effective per-level bandwidth / DMA
        setup and per-engine FLOP/s solved by non-negative least squares
        over the shared roofline model.  ``measurements`` is a sequence of
        :class:`repro_torch.calib.Measurement` (see
        ``repro_torch.calib.microbench_sweep``).  For the fit diagnostics —
        per-measurement residuals, the drift-gate statistics — call
        :func:`repro_torch.calib.calibrate` directly; this returns only the
        target."""
        from repro_torch.calib import calibrate

        return calibrate(measurements, base=base).target

    # ------------------------------------------------------------------
    def describe(self) -> str:
        parts = [
            f"{lv.name} {_fmt_bytes(lv.capacity_bytes)}"
            + (f" @{lv.bw_bytes_per_s / 1e9:g} GB/s" if i else "")
            for i, lv in enumerate(self.levels)
        ]
        return f"{self.name}: " + " <- ".join(parts) + \
            f", {self.flops / 1e12:g} TFLOP/s"


def compute_time(flops: float, peak_flops: float) -> float:
    """The repo's one compute-time formula: ``flops / peak rate``.
    ``Target.compute_time_s`` (the FTL planner) and
    ``repro.roofline.analysis.HW.compute_time_s`` both delegate here, so
    a change to the compute model lands on both consumers at once."""
    return flops / peak_flops


def modeled_runtime(compute_s: float, transfer_s: float) -> float:
    """The repo's one overlap rule: double-buffered DMA hides behind
    compute (and vice versa), so a segment's modeled runtime is
    ``max(compute_time, transfer_time)``.  The FTL solver/partition-DP
    objective, the roofline bound and the benchmark runtime models all
    call this instead of restating the max()."""
    return max(compute_s, transfer_s)


def round_time(t: float) -> float:
    """Canonicalize a modeled time for *objective comparisons*: round to
    12 significant digits.

    Partition runtimes that are mathematically equal can differ by a
    float ulp (an all-compute-bound chain prices ``Σ_i flops_i / F``
    against ``(Σ_i flops_i) / F``); comparing raw floats would then break
    such ties by rounding noise instead of falling through to the
    deterministic traffic/DMA tie-breaks.  12 significant digits is far
    below any modeling fidelity and far above accumulated double
    rounding error for the ≤ dozens of segments a chain has."""
    if t == 0.0:
        return 0.0
    return float(f"{t:.12g}")


def _fmt_bytes(n: int) -> str:
    if n >= 1 << 48:
        return "unbounded"
    for unit, tag in ((1 << 30, "GiB"), (1 << 20, "MiB"), (1 << 10, "KiB")):
        if n >= unit:
            return f"{n / unit:.3g} {tag}"
    return f"{n} B"


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------

# TPU v5e class (task-specified constants).  The fast level is the 96 MiB
# the planner may claim — the physical 128 MiB VMEM minus the headroom the
# Pallas pipeline machinery / semaphores need.  VMEM is DMA-fed: the
# Pallas pipeline double-buffers every streamed tile.  ICI-reachable
# remote HBM plays the deep-tier role for the roofline's collective term.
TPU_V5E = Target(
    name="tpu_v5e",
    levels=(
        MemoryLevel("vmem", 96 * MB, 2.0e13, buffer_depth=2),
        MemoryLevel("hbm", int(16e9), 819e9, dma_setup_s=1e-6,
                    buffer_depth=1),
        MemoryLevel("ici", 1 << 50, 50e9, dma_setup_s=5e-6,
                    buffer_depth=1, dma_port="ici"),
    ),
    flops=197e12,
)

# Cache-blocked x86 core: the "software-managed" fast level is the slice
# of private L2 a blocked kernel keeps hot; hardware prefetch makes the
# per-transfer setup effectively zero and the cache itself stages the
# incoming lines — no software double-buffer copies (buffer_depth=1).
CPU_CACHE = Target(
    name="cpu_cache",
    levels=(
        MemoryLevel("l2", 1 * MB, 150e9, buffer_depth=1),
        MemoryLevel("llc", 32 * MB, 80e9, buffer_depth=1),
        MemoryLevel("dram", 64 * GB, 25e9, buffer_depth=1),
    ),
    flops=1e12,
)

# Siracusa-like RV32 cluster (the paper's platform): 256 KiB L1 TCDM fed
# by DMA from 2 MiB on-chip L2 (double-buffered, the paper's pipeline),
# off-chip L3 behind a HyperBus-class link.  Constants match
# benchmarks/hw_profiles.py (order-of-magnitude estimates from the
# Siracusa/PULP literature).
RV32_L1_L2 = Target(
    name="rv32_l1_l2",
    levels=(
        MemoryLevel("l1", 256 * KB, 8e9, buffer_depth=2),
        MemoryLevel("l2", 2 * MB, 2.0e9, dma_setup_s=2e-6, buffer_depth=1),
        MemoryLevel("l3", 512 * MB, 0.35e9, dma_setup_s=2e-6,
                    buffer_depth=1),
    ),
    flops=6e9,
)

# Siracusa with the N-EUREKA NPU enabled (the paper's cluster+NPU
# −60.1 % regime): same L1/L2/L3 hierarchy, but GEMMs run on the NPU
# (~64 GMAC/s int8 → 128 GFLOP/s) while everything else — GeLU,
# softmax, residual adds — stays on the 8-core scalar cluster
# (~0.3 G elem/s).  The two engines overlap, so a fused elementwise
# epilogue hides under the NPU's next tile instead of serializing.
# Constants absorbed from benchmarks/hw_profiles.py's SIRACUSA_NPU
# (macs_per_s / ew_per_s), which now derives its planning target from
# this shared model.
RV32_NPU = Target(
    name="rv32_npu",
    levels=RV32_L1_L2.levels,
    flops=128e9,
    engines=(
        Engine("npu", (("gemm", 128e9),)),
        Engine("cluster", (("*", 0.3e9),)),
    ),
)

# Multi-cluster Siracusa-like SoC: several RV32+NPU clusters on one die
# joined by an on-chip NoC (chip-to-chip extension of the same link class
# for >1-die meshes).  The per-cluster hierarchy and engines are exactly
# RV32_NPU — with no collectives in a graph the plans are identical —
# but the NoC level (interconnect sentinel capacity, its own DMA port)
# lets the planner price all-reduce/all-gather streams for a
# tensor-parallel block and overlap them with the L2/L3 DMA traffic.
# ~8 GB/s NoC with a per-message setup in the µs class (PULP cluster-
# to-cluster DMA literature, order of magnitude).
RV32_MESH = Target(
    name="rv32_mesh",
    levels=RV32_NPU.levels + (
        MemoryLevel("noc", 1 << 50, 8e9, dma_setup_s=2e-6,
                    buffer_depth=1, dma_port="noc"),
    ),
    flops=RV32_NPU.flops,
    engines=RV32_NPU.engines,
)

# NVIDIA H100 SXM (80 GB HBM3, 700 W power limit; NVIDIA's data sheet).
# The fast level is the shared memory one thread block may claim
# (232,448 B of the SM's 256 KB), staged two deep by cp.async; behind it
# the 50 MB L2 and the 80 GB HBM at 3.35 TB/s.  ``flops`` is the dense
# bf16 tensor-core peak.  The L2 rate is an order-of-magnitude figure: the
# planner consumes relative plan decisions, and a card held below 700 W
# runs below every rate here.
H100 = Target(
    name="h100",
    levels=(
        MemoryLevel("smem", 232_448, 3.3e13, buffer_depth=2),
        MemoryLevel("l2", 50 * 1000 * 1000, 1.0e13, dma_setup_s=5e-7,
                    buffer_depth=1),
        MemoryLevel("hbm", 80 * 1000 * 1000 * 1000, 3.35e12,
                    dma_setup_s=1e-6, buffer_depth=1),
    ),
    flops=989e12,
)

PRESETS: dict[str, Target] = {
    t.name: t for t in (TPU_V5E, CPU_CACHE, RV32_L1_L2, RV32_NPU,
                        RV32_MESH, H100)
}


def get_target(name: str) -> Target:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown target {name!r}; presets: {sorted(PRESETS)}"
        ) from None


def presets() -> Iterable[Target]:
    return tuple(PRESETS.values())


# ---------------------------------------------------------------------------
# target auto-detection
# ---------------------------------------------------------------------------

def detect_target(props=None) -> Target:
    """Derive a planning target from the CUDA device this process sees.

    ``props`` is injectable for tests: an object shaped like
    ``torch.cuda.get_device_properties(0)`` (``name`` is read).  None
    reads ``torch.cuda``: a host with no CUDA device gets the
    cache-blocked :data:`CPU_CACHE` preset, an H100 gets :data:`H100`.
    Any other card raises: the port's kernels are built for the H100
    (``sm_90a``) only; name a preset with ``FTL_TARGET`` to plan for it
    anyway.
    """
    if props is None:
        import torch

        if not torch.cuda.is_available():
            return CPU_CACHE
        props = torch.cuda.get_device_properties(0)
    if "H100" in props.name:
        return H100
    raise RuntimeError(
        f"no planning target for {props.name!r}: the port's kernels are "
        f"built for the H100 (sm_90a) only; set FTL_TARGET to a preset "
        f"({sorted(PRESETS)}) to plan for this card anyway")


# ---------------------------------------------------------------------------
# process-wide default
# ---------------------------------------------------------------------------

_DEFAULT: list[Target | None] = [None]
# Resolution memo, keyed by the FTL_TARGET env value in effect when the
# resolution was made (None = device detection).  Keying on the env state
# is what makes flipping FTL_TARGET mid-process take effect immediately
# instead of being shadowed by a first-answer memo; set_default_target
# clears it outright so an override can never be answered stale either.
_RESOLVED: dict[str | None, Target] = {}


def default_target() -> Target:
    """The target planners resolve ``target=None`` through.

    Order: :func:`set_default_target` override, then the ``FTL_TARGET``
    env var (a preset name), then :func:`detect_target` on the process's
    CUDA device.  The resolution is memoized *per env state*
    (``_RESOLVED``), so detection runs once per process but a changed
    ``FTL_TARGET`` or :func:`set_default_target` call is honored on the
    very next lookup — never silently ignored.
    """
    if _DEFAULT[0] is not None:
        return _DEFAULT[0]
    env = os.environ.get("FTL_TARGET") or None
    got = _RESOLVED.get(env)
    if got is None:
        got = get_target(env) if env else detect_target()
        _RESOLVED[env] = got
    return got


def set_default_target(target: Target | str | None) -> None:
    """Set (or with ``None`` clear) the process-wide default target.
    Clears the resolution memo so later lookups re-resolve against the
    current override/env state."""
    if isinstance(target, str):
        target = get_target(target)
    _DEFAULT[0] = target
    _RESOLVED.clear()
