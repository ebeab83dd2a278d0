"""Measurement records + wall-clock harness for target calibration.

The port's copy of ``repro.calib.measure``.  Every planning decision is
priced by :class:`~repro_torch.core.hw.Target` constants that are
hand-typed presets; this module measures what the device actually does —
isolated GEMM / elementwise microbenchmarks, DMA-proxy copies at several
working-set sizes, and whole-block plan-vs-plain wall-clock — and records
each run as a :class:`Measurement`: the observed seconds next to the
*model features* the roofline prices it with (per-level bytes and
transfer counts, per-kind FLOPs).

A measurement is self-contained: :func:`modeled_measurement_s` re-prices
it on any :class:`Target` through the one shared formula
(``Target.compute_time_by_kind`` / ``Target.transfer_time`` composed by
``hw.modeled_runtime``), so the fitter (:mod:`repro_torch.calib.fit`) and
the drift gate never restate the cost model.

Feature attribution uses the *base* target's level structure
(``Target.assign_homes`` over the same footprints the cost model would
see).  Calibration never changes capacities or level names — only
bandwidth / DMA-setup / FLOP-rate constants — so features extracted
against the base stay valid for the calibrated target.  Bytes are counted
at the measured dtype's element size.

What runs: ``measure_gemms`` times the port's dispatching ``gemm``
(``kernels/gemm.py``), the hand-written kernel on a CUDA tensor (which
takes bfloat16 only, and raises on float32, the default ``dtype``, as it
should) and the plain version on a CPU tensor; ``measure_block`` times
``run_block`` of the plan (under ``'auto'``, or ``'fused'`` for a gated
MLP the card serves so) against the plain block and, on the card,
refuses a plan any of whose stages would run no CUDA executor.  The
elementwise and copy-through sweeps are plain PyTorch ops, as the
reference's are XLA ops: no kernel of the system computes them.

Timing discipline: one untimed first call, then ``warmup`` timed-path
iterations, then ``min`` over ``repeats``; every sample ends in a device
synchronize for a CUDA result, so it times the kernels, not their
launches.  On the card a microbenchmark's sample is
:data:`CUDA_CALLS_PER_SAMPLE` calls replayed from one captured CUDA
graph, the features' ``repeat``: a host launch and synchronize (tens of
µs) outlasts one GEMM at the served shapes or one pass over an
L2-resident buffer, so a one-call sample would time the host.  On the
CPU a sample is one call, as the reference's.  torch is imported inside
the timed functions only, so that ``repro_torch.obs`` (whose drift
monitor reads this module) stays importable without it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Mapping, Sequence

from repro_torch.core import hw as hwlib

# branch hints: which side of the roofline max() a microbenchmark was
# designed to isolate.  The fitter only fits hinted single-segment
# measurements; unhinted ones (whole blocks) are validation-only.
COMPUTE = "compute"
TRANSFER = "transfer"

DEFAULT_REPEATS = 5
DEFAULT_WARMUP = 1
# calls a microbenchmark's timed sample holds on the card (see above)
CUDA_CALLS_PER_SAMPLE = 64


def _freeze(d: Mapping) -> tuple:
    return tuple(sorted(d.items()))


@dataclasses.dataclass(frozen=True)
class SegmentFeatures:
    """Roofline features of one sequential segment of a measured run.

    Mirrors exactly what :meth:`Target.transfer_time` and
    :meth:`Target.compute_time_by_kind` consume, so re-pricing a
    measurement on a candidate target is a pure lookup — no re-planning,
    no shape knowledge."""

    flops_by_kind: tuple[tuple[str, float], ...] = ()
    bytes_by_level: tuple[tuple[str, int], ...] = ()
    transfers_by_level: tuple[tuple[str, int], ...] = ()
    repeat: int = 1

    def compute_s(self, target: hwlib.Target) -> float:
        return target.compute_time_by_kind(dict(self.flops_by_kind))

    def transfer_s(self, target: hwlib.Target) -> float:
        return target.transfer_time(dict(self.bytes_by_level),
                                    dict(self.transfers_by_level))

    def modeled_s(self, target: hwlib.Target) -> float:
        """``hw.modeled_runtime`` of this segment — the one shared
        overlap rule, times the segment's multiplicity."""
        return self.repeat * hwlib.modeled_runtime(
            self.compute_s(target), self.transfer_s(target))


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One wall-clock observation plus the features that model it.

    ``branch`` is the microbenchmark's design hint (:data:`COMPUTE` /
    :data:`TRANSFER`): which side of the roofline ``max`` the run was
    built to isolate, hence which linear subsystem of the fit its row
    belongs to.  ``None`` (whole-block measurements) means the
    measurement only validates the fit — mixed segments cannot be
    attributed to a single branch."""

    name: str
    kind: str                    # gemm | elementwise | dma | block
    measured_s: float
    segments: tuple[SegmentFeatures, ...]
    branch: str | None = None
    meta: tuple[tuple[str, float | int | str], ...] = ()

    def __post_init__(self):
        if self.measured_s <= 0:
            raise ValueError(
                f"measurement {self.name}: measured_s must be positive, "
                f"got {self.measured_s}")
        if self.branch not in (None, COMPUTE, TRANSFER):
            raise ValueError(
                f"measurement {self.name}: unknown branch {self.branch!r}")
        if not self.segments:
            raise ValueError(f"measurement {self.name}: no segments")


def modeled_measurement_s(target: hwlib.Target, m: Measurement) -> float:
    """Modeled seconds of ``m`` on ``target``: segments run sequentially,
    each overlapping its own DMA — ``Σ_seg max(compute, transfer)``,
    the same objective ``ChainPlan.modeled_runtime_s`` sums."""
    return sum(seg.modeled_s(target) for seg in m.segments)


# ---------------------------------------------------------------------------
# feature extraction
# ---------------------------------------------------------------------------

def measurement_from_chain(name: str, chain, measured_s: float, *,
                           kind: str = "block",
                           meta: tuple = ()) -> Measurement:
    """Wrap a live wall-clock observation of a planned chain (or
    ``BlockPlan``) as a validation :class:`Measurement` — the record
    the online drift monitor (:mod:`repro_torch.obs.drift`) feeds from."""
    return Measurement(name=name, kind=kind, measured_s=measured_s,
                       segments=features_from_chain(chain), meta=meta)


def features_from_chain(chain) -> tuple[SegmentFeatures, ...]:
    """Per-segment roofline features of a planned chain (``ChainPlan`` or
    a ``BlockPlan`` via ``.chain``) — what a whole-block wall-clock
    measurement is modeled with."""
    chain = getattr(chain, "chain", chain)
    feats = []
    for seg in chain.segments:
        rep = seg.repeat
        flops: dict[str, float] = {}
        for oc in seg.plan.report.op_compute:
            # effective FLOPs: rate-discount by lane utilization the same
            # way compute_costs prices the op
            flops[oc.kind] = flops.get(oc.kind, 0.0) \
                + oc.flops / oc.utilization
        feats.append(SegmentFeatures(
            flops_by_kind=_freeze(flops),
            bytes_by_level=_freeze(seg.plan.report.per_level_traffic),
            transfers_by_level=_freeze(seg.plan.report.per_level_transfers),
            repeat=rep,
        ))
    return tuple(feats)


def _streamed_features(
    base: hwlib.Target,
    footprints: Mapping[str, int],
    flops_by_kind: Mapping[str, float],
) -> SegmentFeatures:
    """Single-block features: every tensor moved exactly once between its
    home backing level and the fast memory (the min-traffic bound), homes
    assigned by the *base* structure exactly as the cost model would."""
    homes = base.assign_homes(dict(footprints))
    by_level: dict[str, int] = {}
    n_level: dict[str, int] = {}
    for name, b in footprints.items():
        lv = homes[name].name
        by_level[lv] = by_level.get(lv, 0) + int(b)
        n_level[lv] = n_level.get(lv, 0) + 1
    return SegmentFeatures(
        flops_by_kind=_freeze(dict(flops_by_kind)),
        bytes_by_level=_freeze(by_level),
        transfers_by_level=_freeze(n_level),
    )


# ---------------------------------------------------------------------------
# wall-clock harness
# ---------------------------------------------------------------------------

def wallclock_s(fn: Callable, *args, repeats: int = DEFAULT_REPEATS,
                warmup: int = DEFAULT_WARMUP) -> float:
    """``min`` wall-clock seconds of ``fn(*args)`` over ``repeats`` timed
    iterations, after one untimed first call plus ``warmup`` timed-path
    iterations (the kernel library's load and the allocator's first
    requests stay out of the samples).  Each sample waits for the device
    to finish the work that produced ``fn``'s CUDA tensors."""
    out = fn(*args)
    _block(out)
    for _ in range(warmup):
        _block(fn(*args))
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        _block(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _block(out):
    """Wait until ``out`` (a tensor, or a tuple or list of them) is
    computed: a CUDA tensor synchronizes its device; a CPU tensor is
    ready when the call returns."""
    import torch

    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _block(o)
    return out


def _setup(base, dtype, device):
    import torch

    from repro_torch.device import resolve_device

    dtype = torch.float32 if dtype is None else dtype
    base = base if base is not None else hwlib.default_target()
    return base, dtype, torch.tensor([], dtype=dtype).element_size(), \
        resolve_device(device)


def _randn(shape, seed: int, dtype, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)


def _sampled(fn: Callable, *args) -> tuple[Callable, int]:
    """``(sample, calls)``: a call that runs ``fn(*args)`` ``calls``
    times and returns the last result.  For CPU tensors it is one plain
    call; for CUDA tensors :data:`CUDA_CALLS_PER_SAMPLE` calls captured
    in one CUDA graph and replayed, after one call outside the graph
    (which builds the kernel and serves the allocator's first request)."""
    import torch

    if not args[0].is_cuda:
        return (lambda: fn(*args)), 1
    dev = args[0].device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CUDA_CALLS_PER_SAMPLE):
            out = fn(*args)

    def replay():
        graph.replay()
        return out

    return replay, CUDA_CALLS_PER_SAMPLE


# ---------------------------------------------------------------------------
# microbenchmarks
# ---------------------------------------------------------------------------

def measure_gemms(
    shapes: Iterable[tuple[int, int, int]],
    *,
    base: hwlib.Target | None = None,
    repeats: int = DEFAULT_REPEATS,
    warmup: int = DEFAULT_WARMUP,
    dtype=None,
    device=None,
) -> list[Measurement]:
    """Isolated GEMMs at several (m, k, n) through the port's ``gemm``
    (``dtype`` None: float32, as the reference; the kernel takes
    bfloat16): the compute-branch rows that pin the effective ``gemm``
    FLOP/s.  ``device`` None is the CUDA card, and raises without one.
    A sample is :func:`_sampled`'s calls, the features' ``repeat``."""
    from repro_torch.kernels import gemm as gemm_kernel

    base, dtype, esz, dev = _setup(base, dtype, device)
    out = []
    for m, k, n in shapes:
        x = _randn((m, k), m + k + n, dtype, dev)
        w = _randn((k, n), m + k + n + 1, dtype, dev)
        sample, calls = _sampled(gemm_kernel.gemm, x, w)
        secs = wallclock_s(sample, repeats=repeats, warmup=warmup)
        feats = _streamed_features(
            base,
            {"x": esz * m * k, "w": esz * k * n, "y": esz * m * n},
            {"gemm": 2.0 * m * k * n},
        )
        out.append(Measurement(
            name=f"gemm_m{m}_k{k}_n{n}", kind="gemm", measured_s=secs,
            segments=(dataclasses.replace(feats, repeat=calls),),
            branch=COMPUTE,
            meta=(("m", m), ("k", k), ("n", n)),
        ))
    return out


def measure_elementwise(
    sizes: Iterable[int],
    *,
    act: str = "gelu",
    base: hwlib.Target | None = None,
    repeats: int = DEFAULT_REPEATS,
    warmup: int = DEFAULT_WARMUP,
    dtype=None,
    device=None,
) -> list[Measurement]:
    """Isolated activation sweeps: the rows that pin the effective
    ``elementwise`` rate (the planner prices an elementwise op at one
    FLOP per output element, so the fitted rate absorbs the real
    per-element cost of the activation)."""
    from repro_torch.kernels import ref

    base, dtype, esz, dev = _setup(base, dtype, device)
    fn = ref.act_fn(act)
    out = []
    for n in sizes:
        x = _randn((n,), n % (1 << 30), dtype, dev)
        sample, calls = _sampled(fn, x)
        secs = wallclock_s(sample, repeats=repeats, warmup=warmup)
        feats = _streamed_features(
            base, {"x": esz * n, "y": esz * n}, {"elementwise": float(n)})
        out.append(Measurement(
            name=f"{act}_n{n}", kind="elementwise", measured_s=secs,
            segments=(dataclasses.replace(feats, repeat=calls),),
            branch=COMPUTE, meta=(("n", n),),
        ))
    return out


def _add_one(x):
    return x.add_(1.0)


def measure_dma_proxy(
    sizes_bytes: Iterable[int],
    *,
    base: hwlib.Target | None = None,
    repeats: int = DEFAULT_REPEATS,
    warmup: int = DEFAULT_WARMUP,
    dtype=None,
    device=None,
) -> list[Measurement]:
    """Copy-through sweeps at several working-set sizes: the
    transfer-branch rows that pin effective per-level bandwidth and DMA
    setup.  Each call reads and writes its buffer once (``x += 1``);
    sizes straddling the base target's level capacities land on
    different home levels via the same first-fit the cost model uses,
    which is what makes per-level constants identifiable from one device.
    The setup term also absorbs the gap between launches.  A sample is
    :func:`_sampled`'s calls, the features' ``repeat``."""
    base, dtype, esz, dev = _setup(base, dtype, device)
    out = []
    for b in sizes_bytes:
        n = max(1, int(b) // esz)
        x = _randn((n,), n % (1 << 30), dtype, dev)
        sample, calls = _sampled(_add_one, x)
        secs = wallclock_s(sample, repeats=repeats, warmup=warmup)
        feats = _streamed_features(
            base, {"src": esz * n, "dst": esz * n},
            {"elementwise": float(n)})
        out.append(Measurement(
            name=f"dma_{esz * n}B", kind="dma", measured_s=secs,
            segments=(dataclasses.replace(feats, repeat=calls),),
            branch=TRANSFER, meta=(("bytes", esz * n),),
        ))
    return out


def microbench_sweep(
    *,
    base: hwlib.Target | None = None,
    gemm_shapes: Sequence[tuple[int, int, int]] = (
        (256, 256, 256), (512, 512, 512), (1024, 512, 1024),
    ),
    elementwise_sizes: Sequence[int] = (1 << 20, 1 << 22, 1 << 23),
    dma_sizes: Sequence[int] = (1 << 21, 1 << 23, 1 << 25, 1 << 26),
    repeats: int = DEFAULT_REPEATS,
    warmup: int = DEFAULT_WARMUP,
    dtype=None,
    device=None,
) -> list[Measurement]:
    """The standard isolated-microbenchmark sweep the fitter consumes:
    GEMMs + activations (compute branch) and copy-throughs at sizes
    straddling the backing-level capacities (transfer branch).  The
    default sizes are the reference's; on a target with larger levels
    pass ``dma_sizes`` that straddle its capacities."""
    base = base if base is not None else hwlib.default_target()
    kw = dict(base=base, repeats=repeats, warmup=warmup, dtype=dtype,
              device=device)
    ms = measure_gemms(gemm_shapes, **kw)
    ms += measure_elementwise(elementwise_sizes, **kw)
    ms += measure_dma_proxy(dma_sizes, **kw)
    return ms


# ---------------------------------------------------------------------------
# whole-block validation measurements (plan against the plain block)
# ---------------------------------------------------------------------------

def measure_block(
    arch: str,
    m: int,
    *,
    base: hwlib.Target | None = None,
    repeats: int = DEFAULT_REPEATS,
    warmup: int = DEFAULT_WARMUP,
    dtype=None,
    device=None,
    reduced: bool = True,
    ftl_mode: str = "auto",
) -> list[Measurement]:
    """Whole-transformer-block wall-clock, plain (all-unfused features,
    ``ftl_mode='off'``) and plan-driven (``run_block`` of the plan under
    ``ftl_mode``, planned-chain features) — the held-out measurements the
    drift gate validates the fitted constants against.  ``reduced`` (the
    reference's size) takes the config's ``.reduced()``; ``reduced=False``
    measures the block at the config's own widths.  ``ftl_mode`` is the
    reference's ``'auto'``; ``'fused'`` runs a gated MLP on the fused-MLP
    kernel where the plan's schedule is ``partial`` (the partial kernels
    take no gate), the rest by the plan's bindings — the features stay
    the plan's.  On the card every stage must resolve to a CUDA executor,
    or this raises."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.ftl import executor_block, partition, registry
    from repro_torch.models import layers
    from repro_torch.models import model as M

    base, dtype, _, dev = _setup(base, dtype, device)
    dname = registry.dtype_name(dtype)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, dtype=dname, remat=False)
    cfg_plan = dataclasses.replace(cfg, ftl_mode=ftl_mode)
    cfg_off = dataclasses.replace(cfg, ftl_mode="off")
    params = M._init_layer(cfg, torch.Generator(device=dev).manual_seed(0),
                           "attn", dev)
    plan = registry.plan_block(cfg_plan, m=m, dtype=dname, target=base,
                               device=dev)
    if dev.type == "cuda":
        execs = executor_block.resolved_executors(plan, m=m, dtype=dname)
        plain = {k: v for k, v in execs.items()
                 if registry.get(v).backend != "cuda"}
        if plain:
            raise ValueError(
                f"measure_block({arch!r}, m={m}): the {plan.target.name} "
                f"plan ({plan.schedule}, MLP {plan.mlp_schedule}) runs no "
                f"CUDA executor for {plain} on the card")
    positions = torch.arange(m, device=dev)
    x = _randn((1, m, cfg.d_model), 1, dtype, dev)

    @torch.no_grad()
    def plan_fn(xx):
        return registry.run_block(plan, params, xx, positions=positions)

    @torch.no_grad()
    def ref_fn(xx):
        return layers.block_layer(cfg_off, params, xx, positions=positions)

    plan_s = wallclock_s(plan_fn, x, repeats=repeats, warmup=warmup)
    ref_s = wallclock_s(ref_fn, x, repeats=repeats, warmup=warmup)
    unfused = partition.plan_fixed(plan.graph,
                                   partition.all_cuts(plan.graph),
                                   target=base)
    return [
        Measurement(
            name=f"block_{arch}_m{m}_plan", kind="block",
            measured_s=plan_s, segments=features_from_chain(plan),
            meta=(("arch", arch), ("m", m), ("schedule", plan.schedule)),
        ),
        Measurement(
            name=f"block_{arch}_m{m}_ref", kind="block",
            measured_s=ref_s, segments=features_from_chain(unfused),
            meta=(("arch", arch), ("m", m), ("schedule", "unfused")),
        ),
    ]


__all__ = [
    "COMPUTE", "TRANSFER", "SegmentFeatures", "Measurement",
    "modeled_measurement_s", "features_from_chain",
    "measurement_from_chain", "wallclock_s",
    "measure_gemms", "measure_elementwise", "measure_dma_proxy",
    "microbench_sweep", "measure_block",
]
