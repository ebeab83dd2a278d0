"""The port's serving engine against the JAX package's.

Same weights (the JAX ``init_params`` tree through ``params_from_numpy``),
same prompts of mixed lengths, two slots: the port's greedy tokens equal
the JAX engine's, paged and dense.  Also: paged equals dense, eviction
returns pages, steady state replans zero times, and the CLI runs on the
CPU when asked to.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_config("llama3.2-3b").reduced(),
                               remat=False)
    tcfg = dataclasses.replace(tconfigs.get_config("llama3.2-3b").reduced(),
                               remat=False)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def _prompts(vocab, lens=(5, 13, 8, 20), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=n).astype(np.int32) for n in lens]


def _t_engine(tcfg, tp, **kw):
    kw.setdefault("batch_slots", 2)
    return TS.ServeEngine(tcfg, tp, max_seq=32, eos_id=-1,
                          target=thw.CPU_CACHE, device="cpu", **kw)


@pytest.mark.parametrize("paged", [True, False])
def test_greedy_tokens_match_reference(setup, paged):
    jcfg, jp, tcfg, tp = setup
    prompts = _prompts(jcfg.vocab_size)
    jeng = JS.ServeEngine(jcfg, jp, batch_slots=2, max_seq=32, eos_id=-1,
                          target=jhw.CPU_CACHE, paged=paged)
    jout = {r.rid: r.out for r in jeng.run(
        [JS.Request(i, p, 5) for i, p in enumerate(prompts)], {})}
    teng = _t_engine(tcfg, tp, paged=paged)
    tout = {r.rid: r.out for r in teng.run(
        [TS.Request(i, p, 5) for i, p in enumerate(prompts)])}
    assert tout == jout
    assert all(len(v) == 5 for v in tout.values())


def test_fused_mode_matches_off_mode(setup):
    _, _, tcfg, tp = setup
    prompts = _prompts(tcfg.vocab_size, seed=3)
    outs = []
    for mode in ("off", "fused"):
        eng = _t_engine(dataclasses.replace(tcfg, ftl_mode=mode), tp)
        outs.append({r.rid: r.out for r in eng.run(
            [TS.Request(i, p, 4) for i, p in enumerate(prompts)])})
    assert outs[0] == outs[1]


def test_paged_equals_dense_and_pages_return(setup):
    _, _, tcfg, tp = setup
    prompts = _prompts(tcfg.vocab_size, lens=(6, 9, 15, 3, 11), seed=1)

    def reqs():
        return [TS.Request(i, p, 4) for i, p in enumerate(prompts)]

    eng_p = _t_engine(tcfg, tp, paged=True, block_size=8)
    out_p = {r.rid: r.out for r in eng_p.run(reqs())}
    eng_d = _t_engine(tcfg, tp, paged=False)
    out_d = {r.rid: r.out for r in eng_d.run(reqs())}
    assert out_p == out_d
    assert eng_p.kv.free_blocks == eng_p.kv.num_blocks
    assert (eng_p.kv.n_alloc == 0).all()


def test_admission_control_under_pressure(setup):
    _, _, tcfg, tp = setup
    prompts = _prompts(tcfg.vocab_size, lens=(9, 9, 9), seed=2)
    # room for one 32-token slot only: requests queue for pages
    eng = _t_engine(tcfg, tp, batch_slots=3, paged=True, block_size=8,
                    kv_blocks=4)
    done = eng.run([TS.Request(i, p, 3) for i, p in enumerate(prompts)])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert eng.kv.free_blocks == 4


def test_zero_replans_and_plan_report(setup):
    _, _, tcfg, tp = setup
    eng = _t_engine(dataclasses.replace(tcfg, ftl_mode="fused"), tp)
    eng.warmup_compile()
    eng.run([TS.Request(i, p, 3)
             for i, p in enumerate(_prompts(tcfg.vocab_size))])
    assert eng.stats["replans"] == 0
    assert eng.plans.counters()["misses_after_warmup"] == 0
    rep = eng.plan_report()
    assert rep["prefill"]["executors"]["mlp"] == "cuda_fused_mlp"
    assert rep["prefill"]["executors"]["attention"] == "torch_ref_attention"
    blk = eng.execute_block_plan()
    assert blk["finite"] and blk["executors"] == rep["prefill"]["executors"]


def test_warmup_leaves_engine_state_untouched(setup):
    _, _, tcfg, tp = setup
    for paged in (True, False):
        eng = _t_engine(tcfg, tp, paged=paged)
        before = [t.clone() for t in _leaves(eng.kv.pool if paged
                                            else eng.cache)]
        eng.warmup_compile()
        after = _leaves(eng.kv.pool if paged else eng.cache)
        for b, a in zip(before, after):
            if paged:   # only the scratch page may change
                a, b = a[:, 1:], b[:, 1:]
            assert torch.equal(a, b)


def _leaves(tree):
    from repro_torch.models.model import tree_leaves
    return tree_leaves(tree)


def test_poisson_arrivals_match_reference():
    assert TS.poisson_arrivals(5, 3.0, seed=4) == \
        JS.poisson_arrivals(5, 3.0, seed=4)


def test_cli_runs_on_cpu(capsys):
    TS.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
             "--requests", "3", "--slots", "2", "--prompt-len", "8",
             "--max-new", "3", "--max-seq", "32", "--target", "cpu_cache"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "0 decode replans" in out
