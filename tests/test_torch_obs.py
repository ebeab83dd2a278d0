"""The port's exporters and drift monitor against the reference's, and
the serving and training telemetry.

``repro_torch.obs.export`` and ``.drift`` are copies of the reference's:
for the same registry contents ``prometheus_text`` gives identical text,
``merged_chrome_trace`` the identical document (the modeled lane on pid
0 from the same plan, live spans on pid 1), and ``DriftMonitor`` the
same ratios, rolling geomeans and gauges, on numpy-drawn observations.
Then the serve engine with ``obs=True`` on the CPU (the reference's
``tests/test_obs.py`` case on the port's engine: spans, gauges, the
decode-step histogram, ``plan_report``'s schema, the block's drift row),
the serve CLI's ``--obs``/``--obs-trace``/``--obs-metrics``/``--trace``
with the reference's checks, and the train CLI's obs flags.
"""
import dataclasses
import gc
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.calib import measure as jmeasure  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.core.ftl import registry as jregistry  # noqa: E402
from repro.obs import spans as jspans  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.calib import measure as tmeasure  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.core.ftl import registry as tregistry  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.obs import spans as tspans  # noqa: E402


def _ref_target(t):
    return jhw.Target(
        name=t.name,
        levels=tuple(jhw.MemoryLevel(**dataclasses.asdict(lv))
                     for lv in t.levels),
        flops=t.flops,
        engines=tuple(jhw.Engine(e.name, e.rates) for e in t.engines))


def _fill(reg, seed: int = 0) -> None:
    """The same counters, gauges and histograms, numpy-drawn values."""
    rng = np.random.default_rng(seed)
    c = reg.counter("req_total", "requests", ("route",))
    for route in ("a", "b"):
        c.labels(route=route).inc(float(rng.integers(1, 9)))
    reg.counter("plain_total").inc()
    g = reg.gauge("depth", "queue depth")
    g.set(float(rng.uniform(0, 5)))
    g.inc(2.0)
    reg.gauge("ratio", "per segment", ("segment", "target")).labels(
        segment="block_exec", target="h100").set(float(rng.uniform()))
    h = reg.histogram("step_seconds", "per step")
    for v in rng.exponential(0.01, size=20):
        h.observe(float(v))
    reg.histogram("lat", "labelled", ("phase",), buckets=(0.1, 1.0)) \
        .labels(phase="decode").observe(0.5)
    reg.register_collector(
        lambda r: r.gauge("collected", "at scrape time").set(7.0))


def _plans(target: str):
    jc = dataclasses.replace(jconfigs.get_config("llama3.2-3b").reduced(),
                             dtype="float32", remat=False, ftl_mode="auto")
    tc = dataclasses.replace(tconfigs.get_config("llama3.2-3b").reduced(),
                             dtype="float32", remat=False, ftl_mode="auto")
    tt = thw.get_target(target)
    jt = jhw.get_target(target) if target in jhw.PRESETS else _ref_target(tt)
    return (jregistry.plan_block(jc, m=32, dtype="float32", target=jt),
            tregistry.plan_block(tc, m=32, dtype="float32", target=tt,
                                 device="cpu"))


@pytest.mark.parametrize("seed", [0, 1])
def test_prometheus_text_is_identical(seed):
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    _fill(jreg, seed)
    _fill(treg, seed)
    assert tobs.prometheus_text(treg) == jobs.prometheus_text(jreg)
    assert tobs.metrics_snapshot(treg) == jobs.metrics_snapshot(jreg)


def test_write_prometheus_round_trips(tmp_path):
    treg = tobs.MetricsRegistry()
    _fill(treg)
    out = tmp_path / "m.prom"
    tobs.write_prometheus(out, treg)
    assert out.read_text() == tobs.prometheus_text(treg)


@pytest.mark.parametrize("target", ["h100", "rv32_npu", "cpu_cache"])
def test_merged_trace_is_identical(target, tmp_path):
    jplan, tplan = _plans(target)
    rng = np.random.default_rng(0)
    t0 = np.cumsum(rng.uniform(1e-4, 1e-3, size=5))
    rows = [("serve:admit", "serve", float(a), float(a + d), i % 2, 100 + i)
            for i, (a, d) in enumerate(zip(t0, rng.uniform(1e-5, 1e-4, 5)))]
    measured = [("row", float(s)) for s in rng.uniform(1e-4, 1e-3, 2)]
    jdoc = jobs.merged_chrome_trace(
        spans=[jspans.Span(*r) for r in rows], chain=jplan,
        measured=measured, registry=jobs.MetricsRegistry())
    tdoc = tobs.merged_chrome_trace(
        spans=[tspans.Span(*r) for r in rows], chain=tplan,
        measured=measured, registry=tobs.MetricsRegistry())
    assert tdoc == jdoc
    pids = {e["pid"] for e in tdoc["traceEvents"] if e.get("ph") == "X"}
    assert pids == {0, 1}
    # a recorder works as the span source, and the writer round-trips
    rec = tspans.SpanRecorder(capacity=8)
    with rec.span("live_work", "t"):
        pass
    out = tmp_path / "t.json"
    tobs.write_merged_trace(out, spans=rec, chain=tplan,
                            registry=tobs.MetricsRegistry())
    doc = json.loads(out.read_text())
    assert [e["name"] for e in doc["traceEvents"]
            if e.get("pid") == 1 and e.get("ph") == "X"] == ["live_work"]


def test_drift_monitor_matches_reference():
    jplan, tplan = _plans("h100")
    jt, tt = _ref_target(thw.H100), thw.H100
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jmon = jobs.DriftMonitor(target=jt, registry=jreg, window=4,
                             band=(0.5, 2.0))
    tmon = tobs.DriftMonitor(target=tt, registry=treg, window=4,
                             band=(0.5, 2.0))
    modeled = tmeasure.modeled_measurement_s(
        tt, tmeasure.measurement_from_chain("b", tplan, 1.0))
    rng = np.random.default_rng(0)
    jseg = jmeasure.features_from_chain(jplan)
    tseg = tmeasure.features_from_chain(tplan)
    for i, f in enumerate(rng.uniform(0.2, 5.0, size=9)):
        secs = modeled * float(f)
        if i % 3 == 2:
            a = jmon.observe("step", secs * 4, jseg, kind="decode",
                             scale=4.0)
            b = tmon.observe("step", secs * 4, tseg, kind="decode",
                             scale=4.0)
        else:
            a = jmon.observe_chain(jplan, secs, name="block")
            b = tmon.observe_chain(tplan, secs, name="block")
        assert a == b
    for name in (None, "block", "step", "absent"):
        assert tmon.geomean_ratio(name) == jmon.geomean_ratio(name)
        assert tmon.in_band(name) == jmon.in_band(name)
    assert tmon.status() == jmon.status()
    assert tobs.prometheus_text(treg) == jobs.prometheus_text(jreg)
    # the online geomean is the offline formula over the window
    rows = [m for m in tmon.measurements() if m.name == "block"][-4:]
    want = math.exp(sum(math.log(tmeasure.modeled_measurement_s(tt, m)
                                 / m.measured_s) for m in rows) / len(rows))
    assert tmon.geomean_ratio("block") == pytest.approx(want, rel=1e-12)
    assert tobs.DEFAULT_BAND == jobs.DEFAULT_BAND


@pytest.fixture
def spans_on():
    tobs.disable()
    tobs.enable(capacity=4096)
    yield
    tobs.disable()


@pytest.fixture(scope="module")
def llama():
    cfg = dataclasses.replace(tconfigs.get_config("llama3.2-3b").reduced(),
                              remat=False)
    return cfg, TM.init_params(cfg, 0, device="cpu")


def _hist_count(snap) -> float:
    ((_, count),) = [(lbl, v) for lbl, v
                     in snap["serve_decode_step_seconds"]["samples"]
                     if "__count__" in lbl]
    return count


def test_serve_engine_obs_spans_gauges_and_report_schema(llama, spans_on):
    cfg, params = llama
    rng = np.random.default_rng(0)
    eng = tserve.ServeEngine(cfg, params, batch_slots=2, max_seq=32,
                             eos_id=-1, obs=True, device="cpu")
    before = _hist_count(tobs.collect())
    reqs = [tserve.Request(i, rng.integers(2, cfg.vocab_size, size=6)
                           .astype(np.int32), 3) for i in range(2)]
    eng.run(list(reqs), {})
    names = {s.name for s in tobs.recorder().snapshot()}
    assert "serve:decode_step" in names and "serve:admit" in names
    assert any(n.startswith("serve:prefill:m") for n in names)
    snap = tobs.collect()
    assert _hist_count(snap) - before == eng.stats["decode_steps"] >= 2
    for g in ("serve_active_slots", "serve_queue_depth",
              "serve_kv_free_blocks", "serve_kv_page_occupancy",
              "serve_evictions_total", "serve_stats", "serve_plan_cache",
              "serve_plan_segments", "serve_decode_differs_from_prefill"):
        assert g in snap, g
    stats = {dict(lbl)["stat"]: v for lbl, v in snap["serve_stats"]["samples"]}
    assert stats["decode_steps"] == eng.stats["decode_steps"]
    report = eng.plan_report()
    assert set(report) == {"target", "buckets", "prefill", "decode",
                           "decode_differs_from_prefill", "plan_caches"}
    for regime in ("prefill", "decode"):
        entry = report[regime]
        assert set(entry) == {"m", "schedule", "cuts", "executors"}
        assert set(entry["executors"]) == {"gemm", "attention", "mlp"}
    # the whole planned block feeds the drift monitor
    blk = eng.execute_block_plan()
    assert math.isfinite(blk["drift_ratio"]) and blk["drift_ratio"] > 0
    row = [m for m in eng.drift.measurements() if m.name == "block_exec"][-1]
    assert blk["drift_ratio"] == pytest.approx(
        tmeasure.modeled_measurement_s(eng.target, row) / row.measured_s,
        rel=1e-12)
    assert eng.drift.status()["per_segment"]["block_exec"]["n_window"] == 1
    # the collector is bound weakly: a dead engine's is a no-op
    del eng
    gc.collect()
    tobs.collect()


def test_engine_without_obs_pays_nothing(llama):
    cfg, params = llama
    tobs.disable()
    eng = tserve.ServeEngine(cfg, params, batch_slots=1, max_seq=32,
                             eos_id=-1, device="cpu")
    assert not eng.obs and eng.drift is None
    assert not tobs.enabled()
    eng.run([tserve.Request(0, np.arange(2, 8, dtype=np.int32), 3)])
    assert "drift_ratio" not in eng.execute_block_plan()


SERVE = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
         "--requests", "3", "--slots", "2", "--prompt-len", "8",
         "--max-new", "20", "--max-seq", "64"]


def test_serve_cli_obs_exports(tmp_path, capsys):
    tobs.metrics.REGISTRY.reset()
    paths = {k: str(tmp_path / f"{k}") for k in ("trace", "obs", "prom")}
    try:
        eng = tserve.main(SERVE + ["--obs-trace", paths["obs"],
                                   "--obs-metrics", paths["prom"],
                                   "--trace", paths["trace"]])
    finally:
        tobs.disable()
    assert eng.obs
    out = capsys.readouterr().out
    assert "drift monitor on cpu_cache" in out
    assert "modeled/measured" in out
    for p in (paths["obs"], paths["trace"]):
        doc = json.load(open(p))
        xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        assert {e["pid"] for e in xs} == {0, 1}
        assert any(e["name"].startswith("serve:") for e in xs
                   if e["pid"] == 1)
    text = open(paths["prom"]).read()
    (line,) = [ln for ln in text.splitlines()
               if ln.startswith("serve_decode_step_seconds_count")]
    assert float(line.split()[-1]) == eng.stats["decode_steps"] > 16
    st = eng.drift.status()
    assert st["n_observed"] >= 2 and math.isfinite(st["geomean_ratio"])
    assert "decode_step" in st["per_segment"]


def test_serve_cli_flag_checks(tmp_path):
    same = str(tmp_path / "t.json")
    with pytest.raises(SystemExit):
        tserve.main(SERVE + ["--trace", same, "--obs-trace", same])
    # --trace alone: the decode plan's modeled timeline, written before
    # the run, no live lane
    eng = tserve.main(SERVE + ["--trace", same])
    assert not eng.obs and eng.drift is None
    doc = json.load(open(same))
    assert {e["pid"] for e in doc["traceEvents"]} == {0}
    eng = tserve.main(SERVE + ["--obs-metrics", str(tmp_path / "m")])
    tobs.disable()
    assert eng.obs


def test_train_cli_obs_flags(tmp_path, capsys):
    trace, prom = str(tmp_path / "t.json"), str(tmp_path / "m.prom")
    try:
        ttrain.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
                     "--steps", "2", "--batch", "2", "--seq", "32",
                     "--log-every", "1", "--obs-trace", trace,
                     "--obs-metrics", prom])
        assert tobs.enabled()
    finally:
        tobs.disable()
    out = capsys.readouterr().out
    assert "stragglers:" in out and "wrote merged trace" in out
    doc = json.load(open(trace))
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {e["pid"] for e in xs} == {0, 1}
    assert any(e["name"].startswith("train_step:") for e in xs
               if e["pid"] == 1)
    assert "train_step_seconds" in open(prom).read()
    args = ttrain.parser().parse_args(["--arch", "x", "--obs-trace", "p"])
    assert args.obs_trace == "p" and not args.obs
