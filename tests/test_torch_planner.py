"""The port's planner against the reference planner.

The planning modules of ``repro_torch.core.ftl`` are copies of
``repro.core.ftl``: on every reference preset they must give exactly the
same cuts, tiles, traffic and modeled runtime.  Also: the ``h100``
preset plans every serving bucket, the Hopper kernels' block choices fit
its shared memory, and ``detect_target`` maps the card it sees.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.core.ftl import graph as jgraph  # noqa: E402
from repro.core.ftl import partition as jpartition  # noqa: E402
from repro.core.ftl import solver as jsolver  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.core.ftl import graph as tgraph  # noqa: E402
from repro_torch.core.ftl import partition as tpartition  # noqa: E402
from repro_torch.core.ftl import registry as tregistry  # noqa: E402
from repro_torch.core.ftl import solver as tsolver  # noqa: E402
from repro_torch.kernels import flash_attention, fused_mlp, gemm  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

REF_PRESETS = sorted(jhw.PRESETS)


def _chain_key(chain):
    return (chain.cuts(), chain.schedule, chain.traffic_bytes,
            chain.modeled_runtime_s, chain.per_level_traffic,
            [(s.lo, s.hi, dict(s.plan.tiles), s.plan.traffic_bytes,
              s.plan.modeled_runtime_s) for s in chain.segments])


def _plan_key(plan):
    return (dict(plan.tiles), plan.traffic_bytes, plan.modeled_runtime_s)


def test_reference_presets_are_copied_exactly():
    for name in REF_PRESETS:
        j, t = jhw.get_target(name), thw.get_target(name)
        assert dataclasses.astuple(j) == dataclasses.astuple(t), name


# (graph builder args, label): llama3.2-3b's full and reduced block at a
# prefill and the decode shape, and the paper's ViT-Base MLP (int8
# GEMM+activation chain and the bf16 two-GEMM MLP)
def _graphs(mod, cfgmod):
    full = cfgmod.get_config("llama3.2-3b")
    red = full.reduced()
    return {
        "llama_full_m512": mod.block_graph(full, m=512),
        "llama_full_m1": mod.block_graph(full, m=1),
        "llama_reduced_m32": mod.block_graph(red, m=32),
        "paper_gemm_act": mod.gemm_act_graph(m=3072, k=768, n=3072,
                                             dtype="int8"),
        "paper_mlp": mod.mlp_graph(m=2048, d_model=768, d_ff=3072),
    }


GRAPH_NAMES = ["llama_full_m512", "llama_full_m1", "llama_reduced_m32",
               "paper_gemm_act", "paper_mlp"]


@pytest.mark.parametrize("target", REF_PRESETS)
@pytest.mark.parametrize("gname", GRAPH_NAMES)
def test_plan_chain_matches_reference(gname, target):
    jg = _graphs(jgraph, jconfigs)[gname]
    tg = _graphs(tgraph, tconfigs)[gname]
    try:
        jc = jpartition.plan_chain(jg, target=jhw.get_target(target))
    except jsolver.InfeasibleError:
        with pytest.raises(tsolver.InfeasibleError):
            tpartition.plan_chain(tg, target=thw.get_target(target))
        return
    tc = tpartition.plan_chain(tg, target=thw.get_target(target))
    assert _chain_key(tc) == _chain_key(jc)


@pytest.mark.parametrize("target", REF_PRESETS)
@pytest.mark.parametrize("whole", [frozenset(), frozenset({"K", "N"}),
                                   frozenset({"K", "F", "N"})])
def test_solve_matches_reference(target, whole):
    jg = _graphs(jgraph, jconfigs)["paper_mlp"]
    tg = _graphs(tgraph, tconfigs)["paper_mlp"]
    try:
        jp = jsolver.solve(jg.group(0, jg.n_ops),
                           target=jhw.get_target(target), whole_dims=whole)
    except jsolver.InfeasibleError:
        with pytest.raises(tsolver.InfeasibleError):
            tsolver.solve(tg.group(0, tg.n_ops),
                          target=thw.get_target(target), whole_dims=whole)
        return
    tp = tsolver.solve(tg.group(0, tg.n_ops), target=thw.get_target(target),
                       whole_dims=whole)
    assert _plan_key(tp) == _plan_key(jp)


def _llama():
    return dataclasses.replace(tconfigs.get_config("llama3.2-3b"),
                               ftl_mode="fused")


@pytest.mark.parametrize("m", [8, 16, 32, 64, 128, 256, 512, 1024])
def test_h100_plans_every_bucket(m):
    plan = tregistry.plan_block(_llama(), m=m, target=thw.H100,
                                device="cuda")
    assert plan.target.name == "h100"
    names = {b.kind: b.executor for b in plan.bindings}
    # the fused-mode serving path binds the kernels on the card
    assert names.get("gemm") in (None, "cuda_gemm")


def test_h100_decode_plan_never_binds_kernels():
    plan = tregistry.plan_block(_llama(), m=1, target=thw.H100,
                                device="cuda", phase="decode")
    assert all(not b.executor.startswith("cuda_") for b in plan.bindings)


def test_h100_serving_executors_resolve_to_kernels():
    from repro_torch.core.ftl import executor_block
    _, plan = TM.serve_plan(_llama(), m=1024, target=thw.H100,
                            device="cuda")
    assert executor_block.resolved_executors(plan) == {
        "gemm": "cuda_gemm", "attention": "cuda_flash_attention",
        "mlp": "cuda_fused_mlp"}


@pytest.mark.parametrize("m", [1, 4, 64, 200, 1024])
def test_hopper_kernel_blocks_fit_shared_memory(m):
    cap = thw.H100.fast.capacity_bytes
    assert cap == 232_448
    s = fused_mlp.schedule(m, 3072, 8192, 3072, True)
    assert s.block_m == (64 if m <= 256 else 128)
    assert s.block_f % 64 == 0 and 8192 % s.block_f == 0
    assert s.smem_bytes <= cap
    assert gemm.SMEM_BYTES <= cap
    assert flash_attention.smem_bytes(128) <= cap
    # the registry qualifies the fixed-tile kernels on that footprint
    for kind, name in (("gemm", "cuda_gemm"),
                       ("attention", "cuda_flash_attention")):
        c = tregistry.ExecContext(kind=kind, platform="cuda",
                                  schedule="fused", m=m, d_model=3072,
                                  d_ff=8192, target=thw.H100, head_dim=128)
        assert tregistry.find(kind, c).name == name


def test_fused_mlp_block_f_widens_with_m():
    """Few tokens spread the weight stream over narrow F slices on half
    the SMs; many tokens take wider slices under 128-row tiles."""
    small = fused_mlp.schedule(4, 3072, 8192, 3072, True)
    big = fused_mlp.schedule(1024, 3072, 8192, 3072, True)
    assert (small.block_m, small.block_f, small.grid) == (64, 128, 64)
    assert big.block_m == 128 and big.block_f > small.block_f
    # at decode the partials are a small share of the weight stream
    w_bytes = 2 * 3 * 3072 * 8192
    assert 2 * small.partial_bytes <= w_bytes / 8


def test_fused_mlp_plan_prices_the_partials(monkeypatch):
    """The schedule's estimate charges each slice the fp32 partials its
    blocks store and sum (4·M·N bytes a slice): priced dear enough, they
    drive the pick to the widest slice that fits, which moves the
    fewest."""
    fused_mlp.schedule.cache_clear()
    monkeypatch.setattr(fused_mlp, "PARTIAL_COST", 1e6)
    s = fused_mlp.schedule(4096, 3072, 8192, 3072, True)
    fused_mlp.schedule.cache_clear()
    widest = fused_mlp.block_f_choices(8192, 128, True)[-1]
    assert s.block_f == widest
    assert s.partial_bytes == 4 * (8192 // widest) * 4096 * 3072
    assert all(fused_mlp.schedule(4096, 3072, 8192, 3072, True,
                                  block_f=bf).partial_bytes > s.partial_bytes
               for bf in fused_mlp.block_f_choices(8192, 128, True)[:-1])


def test_fused_mlp_infeasible_on_a_tiny_fast_level():
    fast, *rest = thw.H100.levels
    tiny = dataclasses.replace(
        thw.H100, name="tiny",
        levels=(dataclasses.replace(fast, capacity_bytes=16 * 1024), *rest))
    with pytest.raises(tsolver.InfeasibleError):
        fused_mlp.schedule(64, 3072, 8192, 3072, True,
                           smem_limit=tiny.fast.capacity_bytes)
    c = tregistry.ExecContext(kind="mlp", platform="cuda", schedule="fused",
                              m=64, d_model=3072, d_ff=8192, gated=True,
                              target=tiny)
    assert tregistry.find("mlp", c).name != "cuda_fused_mlp"


def test_detect_target_maps_h100_and_cpu(monkeypatch):
    h100 = types.SimpleNamespace(name="NVIDIA H100 80GB HBM3")
    assert thw.detect_target(h100) is thw.H100
    with pytest.raises(RuntimeError, match="H100"):
        thw.detect_target(types.SimpleNamespace(name="NVIDIA A100-SXM4-40GB"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert thw.detect_target() is thw.CPU_CACHE
