"""The port's simulator-in-the-loop autotuner against the reference's.

``repro_torch.tune`` is a copy of ``repro.tune`` over the port's planner
and simulator: with ``AutotuneConfig()`` it must choose the same cuts,
tiles, engine overrides and per-level buffer depths and report the same
simulated runtimes and replay counts, on every preset (the port's
``h100`` built as a reference ``Target`` field by field).  Also the
planner wiring — ``plan_block(autotune=)`` and ``model._block_plan(
autotune=)`` set ``tune``, key their caches on the config and bind
against the tuned target — a tuned plan run through ``run_block`` on the
CPU against the reference's tuned plan on the same fp32 weights
(rtol=atol=2e-5), and the card's refusal of a gated MLP planned
``partial``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.core.ftl import graph as jgraph  # noqa: E402
from repro.core.ftl import registry as jregistry  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.tune import AutotuneConfig as JConfig  # noqa: E402
from repro.tune import autotune_chain as jautotune  # noqa: E402
from repro.tune import tile_ladder as jladder  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.core.ftl import executor_block as texec  # noqa: E402
from repro_torch.core.ftl import graph as tgraph  # noqa: E402
from repro_torch.core.ftl import registry as tregistry  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tune import AutotuneConfig, autotune_chain  # noqa: E402
from repro_torch.tune import tile_ladder  # noqa: E402

TARGETS = sorted(thw.PRESETS)
TOL = dict(rtol=2e-5, atol=2e-5)
# small shapes + tight budget, as the reference's tests use
FAST = AutotuneConfig(top_k_partitions=2, top_k_tiles=2, beam_width=3,
                      max_rounds=2, max_sims=64)


def _ref_target(name: str):
    if name in jhw.PRESETS:
        return jhw.get_target(name)
    t = thw.get_target(name)
    return jhw.Target(
        name=t.name,
        levels=tuple(jhw.MemoryLevel(**dataclasses.asdict(lv))
                     for lv in t.levels),
        flops=t.flops,
        engines=tuple(jhw.Engine(e.name, e.rates) for e in t.engines))


def _cfgs(arch: str, **over):
    over = dict(dtype="float32", remat=False, ftl_mode="auto", **over)
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), **over),
            dataclasses.replace(tconfigs.get_config(arch).reduced(), **over))


def _graphs(name: str):
    if name == "paper_op":
        return [g.gemm_act_graph(m=256, k=768, n=3072, dtype="int8")
                for g in (jgraph, tgraph)]
    jc, tc = _cfgs(name)
    return [jgraph.block_graph(jc, m=32, dtype="float32"),
            tgraph.block_graph(tc, m=32, dtype="float32")]


def _chain_key(chain) -> tuple:
    t = chain.target
    return (chain.cuts(), chain.schedule, chain.modeled_runtime_s,
            chain.traffic_bytes, t.name,
            [dataclasses.astuple(lv) for lv in t.levels],
            [(s.lo, s.hi, s.repeat, sorted(s.plan.tiles.items()),
              [(oc.name, oc.engine, oc.seconds)
               for oc in s.plan.report.op_compute])
             for s in chain.segments])


def _tune_key(res) -> tuple:
    return (_chain_key(res.chain), res.sim_runtime_s,
            _chain_key(res.baseline_chain), res.baseline_sim_runtime_s,
            res.n_scored, res.n_feasible, res.improved, res.improvement,
            res.analytic_runtime_s)


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("graph", ["paper_op", "llama3.2-3b", "granite-20b"])
def test_autotune_matches_reference(graph, target):
    jg, tg = _graphs(graph)
    jres = jautotune(jg, target=_ref_target(target), config=JConfig())
    tres = autotune_chain(tg, target=thw.get_target(target),
                          config=AutotuneConfig())
    assert _tune_key(tres) == _tune_key(jres)
    assert tres.summary() == jres.summary()
    # the analytic plan is a seed: tuned never replays slower
    assert thw.round_time(tres.sim_runtime_s) <= \
        thw.round_time(tres.baseline_sim_runtime_s)


@pytest.mark.parametrize("target", ["h100", "cpu_cache", "rv32_l1_l2"])
def test_fast_config_matches_reference(target):
    jg, tg = _graphs("paper_op")
    jcfg = JConfig(**dataclasses.asdict(FAST))
    assert _tune_key(autotune_chain(tg, target=thw.get_target(target),
                                    config=FAST)) == \
        _tune_key(jautotune(jg, target=_ref_target(target), config=jcfg))


def test_tuner_moves_depths_somewhere():
    """At least one preset's tuned chain runs on a depth-modified target,
    in the port as in the reference (the depth move is exercised)."""
    _, tg = _graphs("llama3.2-3b")
    names = [autotune_chain(tg, target=t, config=AutotuneConfig())
             .chain.target.name for t in thw.presets()]
    assert any("@" in n for n in names), names


def test_tile_ladder_matches_reference():
    jg, tg = _graphs("paper_op")
    jc = jregistry.partition.plan_chain(jg, target=jhw.get_target("rv32_npu"))
    tc = tregistry.partition.plan_chain(tg,
                                        target=thw.get_target("rv32_npu"))
    for js, ts in zip(jc.segments, tc.segments):
        for d in ts.plan.constraints:
            assert tile_ladder(ts.plan.constraints[d]) == \
                jladder(js.plan.constraints[d])


def test_autotune_config_validates_and_caches():
    with pytest.raises(ValueError):
        AutotuneConfig(top_k_tiles=0)
    with pytest.raises(ValueError):
        AutotuneConfig(beam_width=0)
    with pytest.raises(ValueError):
        AutotuneConfig(max_sims=0)
    with pytest.raises(ValueError):
        AutotuneConfig(depth_candidates=(0, 2))
    _, tg = _graphs("paper_op")
    t = thw.get_target("cpu_cache")
    assert autotune_chain(tg, target=t, config=FAST) is \
        autotune_chain(tg, target=t, config=FAST)
    assert "tune._autotune_cached" in tregistry.plan_cache_stats()


def test_plan_block_autotune_sets_tune_and_keys_the_cache():
    _, cfg = _cfgs("llama3.2-3b")
    t = thw.get_target("cpu_cache")
    plain = tregistry.plan_block(cfg, m=32, dtype="float32", target=t,
                                 device="cpu")
    tuned = tregistry.plan_block(cfg, m=32, dtype="float32", target=t,
                                 device="cpu", autotune=AutotuneConfig())
    assert plain.tune is None and tuned.tune is not None
    assert tuned.chain is tuned.tune.chain
    assert tuned.target == tuned.chain.target
    # cpu_cache's tuned chain runs on a deeper fast level: its bindings
    # were qualified against that target, not the request's
    assert tuned.target.name != t.name
    assert len(tuned.bindings) == len(tuned.chain.segments)
    assert tregistry.plan_block(cfg, m=32, dtype="float32", target=t,
                                device="cpu",
                                autotune=AutotuneConfig()) is tuned
    other = tregistry.plan_block(cfg, m=32, dtype="float32", target=t,
                                 device="cpu", autotune=FAST)
    assert other is not tuned and other.tune.config == FAST
    assert tregistry.plan_block(cfg, m=32, dtype="float32", target=t,
                                device="cpu") is plain


def test_model_block_plan_cache_keys_autotune():
    _, cfg = _cfgs("llama3.2-3b")
    t = thw.TPU_V5E
    plain = TM._block_plan(cfg, 32, "float32", target=t, device="cpu")
    assert plain is not None and plain.tune is None
    tuned = TM._block_plan(cfg, 32, "float32", target=t, device="cpu",
                           autotune=FAST)
    assert tuned is not plain and tuned.tune.config == FAST
    assert thw.round_time(tuned.tune.sim_runtime_s) <= \
        thw.round_time(tuned.tune.baseline_sim_runtime_s)
    other = dataclasses.replace(FAST, max_sims=32)
    assert TM._block_plan(cfg, 32, "float32", target=t, device="cpu",
                          autotune=other) is not tuned
    assert TM._block_plan(cfg, 32, "float32", target=t,
                          device="cpu") is plain


def _layer(jcfg):
    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    dt = jnp.float32
    jp = {"ln1": jlayers.init_norm(jcfg.d_model, jcfg.norm, dt),
          "attn": jlayers.init_attention(jcfg, ks[0]),
          "ln2": jlayers.init_norm(jcfg.d_model, jcfg.norm, dt),
          "mlp": jlayers.init_mlp(jcfg, ks[1])}
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("target", ["cpu_cache", "rv32_l1_l2", "h100"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-20b"])
def test_tuned_block_runs_as_the_reference(arch, target):
    """The slice end to end on the CPU: the same tuned plan, run through
    each package's ``run_block`` on the same weights and input."""
    jcfg, tcfg = _cfgs(arch)
    jplan = jregistry.plan_block(jcfg, m=32, dtype="float32",
                                 target=_ref_target(target),
                                 autotune=JConfig())
    tplan = tregistry.plan_block(tcfg, m=32, dtype="float32",
                                 target=thw.get_target(target), device="cpu",
                                 autotune=AutotuneConfig())
    assert _chain_key(tplan.chain) == _chain_key(jplan.chain)
    jp, tp = _layer(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (2, 32, jcfg.d_model)).astype(np.float32)
    jy = jregistry.run_block(jplan, jp, jnp.asarray(x),
                             positions=jnp.arange(32))
    ty = tregistry.run_block(tplan, tp, torch.from_numpy(x),
                             positions=torch.arange(32))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_gated_partial_mlp_has_no_card_executor():
    """On the card a gated MLP planned ``partial`` has no kernel (the
    partial kernels take no gate): a run under 'auto' raises where the
    plan binds plain PyTorch; 'fused' runs the fused-MLP kernel."""
    cfg = dataclasses.replace(tconfigs.get_config("llama3.2-3b"),
                              ftl_mode="auto")
    plan = tregistry.plan_block(cfg, m=256, target=thw.H100, device="cuda")
    assert plan.mlp_schedule == "partial"
    assert texec.resolved_executors(plan)["mlp"] == "torch_partial_scan_mlp"
    with pytest.raises(ValueError, match="no CUDA executor"):
        texec.resolve_mlp(plan, "auto", 256, "bfloat16", plat="cuda")
    assert texec.resolve_mlp(plan, "fused", 256, "bfloat16",
                             plat="cuda").name == "cuda_fused_mlp"
    # the CPU runs its plain version, and decode plans never bind kernels
    assert texec.resolve_mlp(plan, "auto", 256, "bfloat16",
                             plat="cpu").backend == "torch"
    dec = tregistry.plan_block(cfg, m=1, target=thw.H100, device="cuda",
                               phase="decode")
    texec.resolve_mlp(dec, "auto", 1, "bfloat16", plat="cuda")


@pytest.mark.parametrize("stage", ["gemm", "attention"])
def test_card_prefill_stage_without_a_kernel_raises(stage):
    """The card's rule holds for every stage, not the MLP alone: under
    'auto' a prefill binding that requalifies to plain PyTorch on a CUDA
    tensor (here float32, which the kernels do not take) raises; the
    report names the plain executor, and 'fused' keeps its meaning."""
    cfg = dataclasses.replace(tconfigs.get_config("granite-20b"),
                              ftl_mode="auto")
    plan = tregistry.plan_block(cfg, m=256, target=thw.H100, device="cuda")
    resolve, kernel = {
        "gemm": (texec.resolve_gemm, "cuda_gemm"),
        "attention": (texec.resolve_attention, "cuda_flash_attention"),
    }[stage]
    assert resolve(plan, "auto", 256, "bfloat16", plat="cuda").name == \
        kernel
    with pytest.raises(ValueError, match="no CUDA executor"):
        resolve(plan, "auto", 256, "float32", plat="cuda")
    assert texec.resolved_executors(plan, dtype="float32")[stage] \
        .startswith("torch_")
    assert resolve(plan, "fused", 256, "float32",
                   plat="cuda").backend == "torch"
    assert resolve(plan, "auto", 256, "float32", plat="cpu").backend == \
        "torch"
