"""The port's schedule simulator against the reference's.

``repro_torch.sim`` is a copy of ``repro.sim`` over the port's planner:
on the same plan it must lower the same events and replay them to the
same floats — ``lower_chain``, ``simulate_chain``, ``compare_plan``,
``timeline`` and ``to_chrome_trace`` — on reduced zoo blocks and the
paper's op, on every preset (the port's ``h100`` included, built as a
reference ``Target`` field by field).  Also the port's own invariants:
the replay never beats the analytic floor, and a deeper buffer never
slows it.
"""
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro import sim as jsim  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.core.ftl import graph as jgraph  # noqa: E402
from repro.core.ftl import partition as jpartition  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import sim as tsim  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.core.ftl import graph as tgraph  # noqa: E402
from repro_torch.core.ftl import partition as tpartition  # noqa: E402
from repro_torch.core.ftl import registry as tregistry  # noqa: E402

TARGETS = sorted(thw.PRESETS)
ZOO = ["llama3.2-3b", "granite-20b", "recurrentgemma-9b"]


def _ref_target(name: str):
    """The reference ``Target`` of the port's preset ``name`` (the
    reference's own preset where it has one)."""
    if name in jhw.PRESETS:
        return jhw.get_target(name)
    t = thw.get_target(name)
    return jhw.Target(
        name=t.name,
        levels=tuple(jhw.MemoryLevel(**dataclasses.asdict(lv))
                     for lv in t.levels),
        flops=t.flops,
        engines=tuple(jhw.Engine(e.name, e.rates) for e in t.engines))


def _zoo_graphs(arch: str, m: int = 32):
    out = []
    for cfgmod, gmod in ((jconfigs, jgraph), (tconfigs, tgraph)):
        cfg = dataclasses.replace(cfgmod.get_config(arch).reduced(),
                                  dtype="float32", remat=False)
        out.append(gmod.block_graph(cfg, m=m, dtype="float32"))
    return out


def _paper_graphs(m: int = 512):
    return [g.gemm_act_graph(m=m, k=768, n=3072, dtype="int8")
            for g in (jgraph, tgraph)]


def _chains(graphs, target: str):
    jg, tg = graphs
    return (jpartition.plan_chain(jg, target=_ref_target(target)),
            tpartition.plan_chain(tg, target=thw.get_target(target)))


def _ev(e) -> tuple:
    return (type(e).__name__, dataclasses.astuple(e))


def _sched_key(s) -> tuple:
    return (s.name, s.target.name, s.n_steps, s.buffer_depth,
            [_ev(e) for e in s.events], s.compute_time_s,
            s.transfer_time_s, s.modeled_runtime_s, s.per_engine_compute_s,
            s.per_level_traffic, s.tensor_depths)


def _res_key(r) -> tuple:
    return (r.runtime_s, r.busy_s, r.per_level_busy_s, r.analytic_runtime_s,
            r.n_events, [(_ev(e), a, b) for e, a, b in r.trace])


def _assert_same_replay(jc, tc):
    jl, tl = jsim.lower_chain(jc), tsim.lower_chain(tc)
    assert [(_sched_key(s), rep) for s, rep in jl] == \
        [(_sched_key(s), rep) for s, rep in tl]
    for (js, _), (ts, _) in zip(jl, tl):
        assert _res_key(jsim.simulate(js, trace=True)) == \
            _res_key(tsim.simulate(ts, trace=True))
        assert _res_key(jsim.simulate(js, share_ports=True)) == \
            _res_key(tsim.simulate(ts, share_ports=True))
    jr, tr = jsim.simulate_chain(jl), tsim.simulate_chain(tl)
    assert [(_res_key(r), rep) for r, rep in jr.segments] == \
        [(_res_key(r), rep) for r, rep in tr.segments]
    assert (jr.runtime_s, jr.busy_s, jr.overlap_efficiency) == \
        (tr.runtime_s, tr.busy_s, tr.overlap_efficiency)
    assert jsim.compare_plan(jc) == tsim.compare_plan(tc)
    return tl, tr


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("arch", ZOO)
def test_zoo_block_replays_as_the_reference(arch, target):
    jc, tc = _chains(_zoo_graphs(arch), target)
    tl, tr = _assert_same_replay(jc, tc)
    # the replay is never faster than the analytic floor
    assert tr.runtime_s >= tc.modeled_runtime_s * (1 - 1e-9)
    for seg, (sched, _), (r, _) in zip(tc.segments, tl, tr.segments):
        assert r.runtime_s >= sched.modeled_runtime_s * (1 - 1e-9)
        # the events reproduce the cost model's DMA count and traffic
        assert len(sched.dma_events()) == seg.plan.report.dma_transfers
        assert sum(e.bytes for e in sched.dma_events()) == \
            seg.plan.report.traffic_bytes


@pytest.mark.parametrize("target", TARGETS)
def test_paper_op_replays_as_the_reference(target):
    jc, tc = _chains(_paper_graphs(), target)
    _assert_same_replay(jc, tc)
    # and its unfused cut, segment by segment
    jg, tg = _paper_graphs()
    ju = jpartition.plan_fixed(jg, jpartition.all_cuts(jg),
                               target=_ref_target(target))
    tu = tpartition.plan_fixed(tg, tpartition.all_cuts(tg),
                               target=thw.get_target(target))
    _assert_same_replay(ju, tu)


@pytest.mark.parametrize("target", TARGETS)
def test_depth_sweep_matches_and_never_slows(target):
    jc, tc = _chains(_paper_graphs(m=256), target)
    js = jsim.lower_chain(jc)[0][0]
    ts = tsim.lower_chain(tc)[0][0]
    prev = None
    for depth in (1, 2, 3, 4):
        jr = jsim.simulate(js, buffer_depth=depth)
        tr = tsim.simulate(ts, buffer_depth=depth)
        assert _res_key(jr) == _res_key(tr)
        if prev is not None:
            assert tr.runtime_s <= prev * (1 + 1e-12)
        prev = tr.runtime_s
    with pytest.raises(ValueError):
        tsim.simulate(ts, buffer_depth=0)


@pytest.mark.parametrize("target", ["h100", "rv32_npu", "tpu_v5e"])
def test_chrome_trace_and_timeline_match(target):
    jc, tc = _chains(_zoo_graphs("llama3.2-3b"), target)
    rng = np.random.default_rng(0)
    secs = [float(s) for s in rng.uniform(1e-5, 1e-3, size=3)]
    measured = [(f"row{i}", s) for i, s in enumerate(secs)]
    for pid in (0, 3):
        assert jsim.to_chrome_trace(jc, measured=measured, pid=pid) == \
            tsim.to_chrome_trace(tc, measured=measured, pid=pid)
    jsched = jsim.lower_chain(jc)[0][0]
    tsched = tsim.lower_chain(tc)[0][0]
    assert jsim.to_chrome_trace(jsched) == tsim.to_chrome_trace(tsched)
    assert jsim.timeline(jsched, max_steps=2) == \
        tsim.timeline(tsched, max_steps=2)
    assert jsim.chain_timeline(jc, max_steps=1) == \
        tsim.chain_timeline(tc, max_steps=1)
    json.dumps(tsim.to_chrome_trace(tc))


def test_block_plan_lowers_through_its_chain(tmp_path):
    cfg = dataclasses.replace(tconfigs.get_config("llama3.2-3b").reduced(),
                              ftl_mode="auto")
    bp = tregistry.plan_block(cfg, m=32, dtype="float32", target=thw.H100,
                              device="cpu")
    lowered = tsim.lower_block(bp)
    assert [s.name for s, _ in lowered] == \
        [s.name for s, _ in tsim.lower_chain(bp.chain)]
    assert tsim.compare_plan(bp) == tsim.compare_plan(bp.chain)
    assert tsim.sim_rows([bp, bp.chain])[0] == tsim.compare_plan(bp)
    out = tmp_path / "trace.json"
    tsim.write_chrome_trace(bp, out)
    assert json.loads(out.read_text()) == tsim.to_chrome_trace(bp)


def test_step_compute_chain_matches():
    jc, tc = _chains(_paper_graphs(), "rv32_npu")
    for js, ts in zip(jc.segments, tc.segments):
        assert jsim.step_compute_chain(js.plan.report) == \
            tsim.step_compute_chain(ts.plan.report)
    assert tsim.Engine is thw.Engine
    assert tsim.port_key("dma") == "dma" and \
        tsim.port_key("ici") == "dma:ici"
