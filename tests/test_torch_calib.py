"""The port's calibration loop against the reference's.

``repro_torch.calib.fit`` is numpy copied from ``repro.calib.fit``: on
one shared synthetic set of ``Measurement``s (priced on a perturbed
target with numpy-seeded jitter, features shaped by the base preset)
``calibrate`` and ``drift_gate`` must give the reference's constants
within 1e-9 relative, and the same residuals and verdicts, on
``cpu_cache``, ``rv32_npu`` (engines) and the port's ``h100`` (built as
a reference ``Target`` field by field).  ``features_from_chain`` and
``modeled_measurement_s`` must agree on planned zoo blocks.  The port's
``measure_*`` sweeps run here on the CPU (``device='cpu'``, one timed
repeat, no time asserted): their features must be the reference's for
the same shapes, counted at the measured dtype's element size, and a
float32 ``measure_gemms`` runs the plain GEMM, launching no kernel.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import calib as jcalib  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.calib import measure as jmeasure  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.core.ftl import partition as jpartition  # noqa: E402
from repro.core.ftl import registry as jregistry  # noqa: E402

from repro_torch import calib as tcalib  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.calib import measure as tmeasure  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.core.ftl import registry as tregistry  # noqa: E402
from repro_torch.kernels import gemm as gemm_kernel  # noqa: E402

MB = 1 << 20
REL = 1e-9


def _ref_target(t):
    """The reference ``Target`` with every field of the port's ``t``."""
    return jhw.Target(
        name=t.name,
        levels=tuple(jhw.MemoryLevel(**dataclasses.asdict(lv))
                     for lv in t.levels),
        flops=t.flops,
        engines=tuple(jhw.Engine(e.name, e.rates) for e in t.engines))


def _truth(base, rng):
    """``base`` with every backing level's bandwidth and setup and every
    rate moved by a numpy-drawn factor: the machine the synthetic
    measurements are priced on."""
    levels = [base.levels[0]] + [
        dataclasses.replace(
            lv, bw_bytes_per_s=lv.bw_bytes_per_s * float(rng.uniform(0.3, 1)),
            dma_setup_s=max(lv.dma_setup_s, 1e-7)
            * float(rng.uniform(0.5, 3)))
        for lv in base.levels[1:]]
    engines = tuple(thw.Engine(e.name, tuple(
        (k, r * float(rng.uniform(0.2, 1))) for k, r in e.rates))
        for e in base.engines)
    return dataclasses.replace(base, levels=tuple(levels),
                               flops=base.flops * float(rng.uniform(0.2, 1)),
                               engines=engines)


def _synth_rows(base, seed=0, noise=0.05):
    """(name, kind, branch, seconds, flops_by_kind, bytes_by_level,
    transfers_by_level) rows: GEMMs and activations (compute), copies at
    sizes straddling the base's backing levels (transfer), and one mixed
    two-segment block row (validation only)."""
    rng = np.random.default_rng(seed)
    truth = _truth(base, rng)
    rows = []

    def add(name, kind, branch, flops, by, nl, repeat=1):
        f = tmeasure.SegmentFeatures(
            flops_by_kind=tuple(sorted(flops.items())),
            bytes_by_level=tuple(sorted(by.items())),
            transfers_by_level=tuple(sorted(nl.items())), repeat=repeat)
        secs = f.modeled_s(truth) * float(1 + rng.uniform(-noise, noise))
        rows.append((name, kind, branch, secs, flops, by, nl, repeat))

    for m, k, n in ((256, 256, 256), (1024, 512, 1024), (4096, 4096, 4096)):
        add(f"g{m}", "gemm", tmeasure.COMPUTE,
            {"gemm": 2.0 * m * k * n}, {}, {})
    for n in (1 << 20, 1 << 23):
        add(f"e{n}", "elementwise", tmeasure.COMPUTE,
            {"elementwise": float(n)}, {}, {})
    caps = sorted(lv.capacity_bytes for lv in base.backing[:-1])
    sizes = sorted({max(1, c // 4) for c in caps} | {2 * c for c in caps}
                   | {c // 2 for c in caps} | {1 << 16})
    for b in sizes:
        homes = base.assign_homes({"src": b, "dst": b})
        by, nl = {}, {}
        for t in ("src", "dst"):
            lv = homes[t].name
            by[lv] = by.get(lv, 0) + b
            nl[lv] = nl.get(lv, 0) + 1
        add(f"d{b}", "dma", tmeasure.TRANSFER, {}, by, nl)
    last = base.backing[-1].name
    add("blk", "block", None, {"gemm": 1e9}, {last: 1 << 26}, {last: 4},
        repeat=3)
    return rows


def _measurements(mod, rows):
    return [mod.Measurement(
        name, kind, secs,
        (mod.SegmentFeatures(flops_by_kind=tuple(sorted(fl.items())),
                             bytes_by_level=tuple(sorted(by.items())),
                             transfers_by_level=tuple(sorted(nl.items())),
                             repeat=rep),),
        branch=branch)
        for name, kind, branch, secs, fl, by, nl, rep in rows]


def _close(a, b) -> bool:
    return abs(a - b) <= REL * max(abs(a), abs(b))


BASES = ["cpu_cache", "rv32_npu", "h100"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("base", BASES)
def test_calibrate_and_drift_gate_match_reference(base, seed):
    tb = thw.get_target(base)
    jb = _ref_target(tb)
    rows = _synth_rows(tb, seed=seed)
    jres = jcalib.calibrate(_measurements(jcalib, rows), base=jb)
    tres = tcalib.calibrate(_measurements(tcalib, rows), base=tb)
    assert [n for n, _ in tres.fitted] == [n for n, _ in jres.fitted]
    assert tres.fitted, "nothing fitted"
    for (_, a), (_, b) in zip(tres.fitted, jres.fitted):
        assert _close(a, b), (tres.fitted, jres.fitted)
    assert tres.inherited == jres.inherited
    assert tres.n_iter == jres.n_iter
    assert [(r.name, r.kind, r.in_fit, r.measured_s) for r in tres.residuals] \
        == [(r.name, r.kind, r.in_fit, r.measured_s) for r in jres.residuals]
    for tr, jr in zip(tres.residuals, jres.residuals):
        assert _close(tr.base_modeled_s, jr.base_modeled_s)
        assert _close(tr.calibrated_modeled_s, jr.calibrated_modeled_s)
    # the calibrated machine, field by field
    tt, jt = tres.target, jres.target
    assert tt.name == jt.name == f"{base}@calib"
    for tl, jl in zip(tt.levels, jt.levels):
        assert (tl.name, tl.capacity_bytes, tl.buffer_depth, tl.dma_port) \
            == (jl.name, jl.capacity_bytes, jl.buffer_depth, jl.dma_port)
        assert _close(tl.bw_bytes_per_s, jl.bw_bytes_per_s)
        assert _close(tl.dma_setup_s, jl.dma_setup_s) or \
            tl.dma_setup_s == jl.dma_setup_s
    assert _close(tt.flops, jt.flops)
    assert [(e.name, [k for k, _ in e.rates]) for e in tt.engines] == \
        [(e.name, [k for k, _ in e.rates]) for e in jt.engines]
    for te, je in zip(tt.engines, jt.engines):
        for (_, a), (_, b) in zip(te.rates, je.rates):
            assert _close(a, b)
    for kw in ({}, {"band": (0.9, 1.1)}, {"require_tighter": False}):
        tg, jg = tcalib.drift_gate(tres, **kw), jcalib.drift_gate(jres, **kw)
        assert set(tg) == set(jg)
        for k in tg:
            if isinstance(tg[k], float):
                assert _close(tg[k], jg[k]), k
            else:
                assert tg[k] == jg[k], k
    assert tres.summary().splitlines()[0] == jres.summary().splitlines()[0]
    # Target.calibrated is calibrate(...).target
    assert thw.Target.calibrated(_measurements(tcalib, rows), base=tb) \
        == tres.target


def test_fit_recovers_h100_constants_from_noise_free_rows():
    tb = thw.H100
    rows = _synth_rows(tb, seed=3, noise=0.0)
    res = tcalib.calibrate(_measurements(tcalib, rows), base=tb)
    # noise-free rows priced on a truth: the fit reproduces them
    for r in res.residuals:
        if r.in_fit:
            assert r.calibrated_ratio == pytest.approx(1.0, rel=1e-6)
    assert tcalib.drift_gate(res)["ok"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nnls_matches_reference(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((9, 4))
    b = rng.standard_normal(9)
    assert np.array_equal(tcalib.nnls(a, b), jcalib.nnls(a, b))
    assert (tcalib.nnls(a, b) >= 0).all()


def _zoo_plans(arch, target):
    jc = dataclasses.replace(jconfigs.get_config(arch).reduced(),
                             dtype="float32", remat=False, ftl_mode="auto")
    tc = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                             dtype="float32", remat=False, ftl_mode="auto")
    tt = thw.get_target(target)
    jt = jhw.get_target(target) if target in jhw.PRESETS else _ref_target(tt)
    return (jregistry.plan_block(jc, m=32, dtype="float32", target=jt),
            tregistry.plan_block(tc, m=32, dtype="float32", target=tt,
                                 device="cpu"))


def _feat_key(feats):
    return [dataclasses.astuple(f) for f in feats]


@pytest.mark.parametrize("target", sorted(thw.PRESETS))
@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-20b"])
def test_features_and_modeled_seconds_match(arch, target):
    jp, tp = _zoo_plans(arch, target)
    jf, tf = jcalib.features_from_chain(jp), tcalib.features_from_chain(tp)
    assert _feat_key(tf) == _feat_key(jf)
    assert _feat_key(tcalib.features_from_chain(tp.chain)) == _feat_key(tf)
    jm = jcalib.measurement_from_chain("blk", jp, 1e-3)
    tm = tcalib.measurement_from_chain("blk", tp, 1e-3)
    # priced on the plan's own machine and on one with other constants
    t = tp.target
    for tt in (t, dataclasses.replace(t, flops=t.flops / 3, levels=tuple(
            dataclasses.replace(lv, bw_bytes_per_s=lv.bw_bytes_per_s / 2)
            for lv in t.levels))):
        assert tcalib.modeled_measurement_s(tt, tm) == \
            jcalib.modeled_measurement_s(_ref_target(tt), jm)
    # the plan's own modeled runtime is the measurement's modeled side
    assert tcalib.modeled_measurement_s(tp.target, tm) == \
        pytest.approx(tp.chain.modeled_runtime_s, rel=1e-12)


def test_measure_gemms_on_cpu_runs_the_plain_gemm():
    before = gemm_kernel.launches
    shapes = [(32, 64, 48), (16, 16, 16)]
    rows = tcalib.measure_gemms(shapes, base=thw.H100, repeats=1, warmup=0,
                                dtype=torch.float32, device="cpu")
    assert gemm_kernel.launches == before
    jb = _ref_target(thw.H100)
    for r, (m, k, n) in zip(rows, shapes):
        assert r.name == f"gemm_m{m}_k{k}_n{n}" and r.branch == "compute"
        assert r.measured_s > 0
        want = jmeasure._streamed_features(
            jb, {"x": 4 * m * k, "w": 4 * k * n, "y": 4 * m * n},
            {"gemm": 2.0 * m * k * n})
        assert dataclasses.astuple(r.segments[0]) == \
            dataclasses.astuple(want)
    # bf16 rows count two bytes an element
    (r,) = tcalib.measure_gemms([(32, 64, 48)], base=thw.H100, repeats=1,
                                warmup=0, dtype=torch.bfloat16, device="cpu")
    assert dict(r.segments[0].bytes_by_level) == {
        "l2": 2 * (32 * 64 + 64 * 48 + 32 * 48)}


def test_sweeps_match_reference_features():
    tb, jb = thw.CPU_CACHE, jhw.CPU_CACHE
    el = tcalib.measure_elementwise([1 << 10, 1 << 12], base=tb, repeats=1,
                                    warmup=0, device="cpu")
    for r, n in zip(el, (1 << 10, 1 << 12)):
        want = jmeasure._streamed_features(jb, {"x": 4 * n, "y": 4 * n},
                                           {"elementwise": float(n)})
        assert dataclasses.astuple(r.segments[0]) == \
            dataclasses.astuple(want)
        assert r.name == f"gelu_n{n}"
    sizes = [1 << 16, 40 * MB]
    dma = tcalib.measure_dma_proxy(sizes, base=tb, repeats=1, warmup=0,
                                   device="cpu")
    for r, b in zip(dma, sizes):
        want = jmeasure._streamed_features(jb, {"src": b, "dst": b},
                                           {"elementwise": b / 4})
        assert dataclasses.astuple(r.segments[0]) == \
            dataclasses.astuple(want)
        assert r.name == f"dma_{b}B" and r.branch == "transfer"
    # the levels the two sizes land on differ: per-level constants are
    # identifiable
    assert len({r.segments[0].bytes_by_level[0][0] for r in dma}) == 2
    # several calls a sample (the card's graph replay): the features
    # repeat, the fit takes the per-call time
    r3 = dataclasses.replace(dma[0], segments=(dataclasses.replace(
        dma[0].segments[0], repeat=3),))
    assert tcalib.modeled_measurement_s(tb, r3) == \
        3 * tcalib.modeled_measurement_s(tb, dma[0])
    # on the CPU a sample is one call, as the reference's
    ms = tcalib.microbench_sweep(base=tb, gemm_shapes=((16, 16, 16),),
                                 elementwise_sizes=(1 << 10,),
                                 dma_sizes=tuple(sizes), repeats=1,
                                 warmup=0, device="cpu")
    assert [m.segments[0].repeat for m in ms] == [1, 1, 1, 1]
    assert [m.kind for m in ms] == ["gemm", "elementwise", "dma", "dma"]
    res = tcalib.calibrate(ms, base=tb)
    assert all(math.isfinite(v) and v > 0 for _, v in res.fitted
               if not _.startswith("dma_setup"))


def test_measure_block_on_cpu_has_the_reference_features():
    rows = tcalib.measure_block("llama3.2-3b", 32, base=thw.CPU_CACHE,
                                repeats=1, warmup=0, device="cpu")
    assert [r.name for r in rows] == ["block_llama3.2-3b_m32_plan",
                                      "block_llama3.2-3b_m32_ref"]
    jc = dataclasses.replace(jconfigs.get_config("llama3.2-3b").reduced(),
                             dtype="float32", remat=False, ftl_mode="auto")
    jp = jregistry.plan_block(jc, m=32, dtype="float32",
                              target=jhw.CPU_CACHE)
    unfused = jpartition.plan_fixed(jp.graph, jpartition.all_cuts(jp.graph),
                                    target=jhw.CPU_CACHE)
    assert _feat_key(rows[0].segments) == \
        _feat_key(jcalib.features_from_chain(jp))
    assert _feat_key(rows[1].segments) == \
        _feat_key(jcalib.features_from_chain(unfused))
    assert dict(rows[0].meta)["schedule"] == jp.schedule
    assert all(r.branch is None and r.measured_s > 0 for r in rows)


def test_wallclock_calls_and_the_card_default():
    calls = []

    def fn(x):
        calls.append(1)
        return [x, (x + 1,)]

    s = tcalib.wallclock_s(fn, torch.ones(4), repeats=2, warmup=1)
    assert s >= 0 and len(calls) == 1 + 1 + 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcalib.measure_gemms([(16, 16, 16)], repeats=1, warmup=0)


def test_measurement_validation():
    f = tcalib.SegmentFeatures(flops_by_kind=(("gemm", 1.0),))
    with pytest.raises(ValueError):
        tcalib.Measurement("x", "gemm", 0.0, (f,))
    with pytest.raises(ValueError):
        tcalib.Measurement("x", "gemm", 1.0, (f,), branch="sideways")
    with pytest.raises(ValueError):
        tcalib.Measurement("x", "gemm", 1.0, ())
    with pytest.raises(ValueError, match="branch hint"):
        tcalib.calibrate([tcalib.Measurement("x", "block", 1.0, (f,))],
                         base=thw.H100)
