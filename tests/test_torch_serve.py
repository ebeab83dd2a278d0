"""The port's serving engine against the JAX package's.

Same weights (the JAX ``init_params`` tree through ``params_from_numpy``),
same prompts of mixed lengths, two slots: the port's greedy tokens equal
the JAX engine's, paged and dense.  Also: paged equals dense, eviction
returns pages, steady state replans zero times, and the CLI runs on the
CPU when asked to.

Hybrid (recurrentgemma-9b, reduced, window 32): the port's engine is held
to the JAX *model's* greedy loop (``prefill`` + ``decode_step``) on the
unpadded prompt, not to the JAX engine, which takes the recurrent state
and the local ring at the bucket's end, pads included.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

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


# ---------------------------------------------------------------------------
# hybrid: recurrent state beside ring-buffered local attention
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hybrid():
    jcfg = dataclasses.replace(
        jconfigs.get_config("recurrentgemma-9b").reduced(), remat=False)
    tcfg = dataclasses.replace(
        tconfigs.get_config("recurrentgemma-9b").reduced(), remat=False)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def _model_greedy(jcfg, jp, prompt, n, max_seq):
    """The JAX model's own greedy loop on the unpadded prompt."""
    logits, cache = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt)[None]},
                               max_seq=max_seq)
    out = [int(jnp.argmax(logits[0, -1]))]
    pos = len(prompt)
    while len(out) < n:
        logits, cache = JM.decode_step(jcfg, jp, jnp.asarray([[out[-1]]]),
                                       cache, jnp.int32(pos))
        out.append(int(jnp.argmax(logits[0, -1])))
        pos += 1
    return out


@pytest.mark.parametrize("lens,slots,max_seq", [
    ((5, 8, 11), 1, 64),        # one slot: each prompt alone
    ((5, 8, 11), 2, 64),        # two slots decoding together
    ((40,), 1, 128),            # past the window, bucket 64 past it too
    ((7, 20), 2, 24),           # max_seq below the window
])
def test_hybrid_tokens_match_reference_model_loop(hybrid, lens, slots,
                                                  max_seq):
    jcfg, jp, tcfg, tp = hybrid
    prompts = _prompts(jcfg.vocab_size, lens=lens, seed=len(lens))
    n = 4 if max_seq < jcfg.local_window else 6
    eng = TS.ServeEngine(tcfg, tp, batch_slots=slots, max_seq=max_seq,
                         eos_id=-1, target=thw.CPU_CACHE, device="cpu")
    assert not eng.paged
    got = {r.rid: r.out for r in eng.run(
        [TS.Request(i, p, n) for i, p in enumerate(prompts)])}
    want = {i: _model_greedy(jcfg, jp, p, n, max_seq)
            for i, p in enumerate(prompts)}
    assert got == want


def test_reference_engine_takes_hybrid_state_at_bucket_end(hybrid):
    """Why the port is held to the JAX model's loop and not to the JAX
    engine: the JAX engine prefills the padded bucket and keeps the state
    after the pads, so its tokens leave the model's after the first one
    unless the prompt fills its bucket."""
    jcfg, jp, _, _ = hybrid
    rng = np.random.default_rng(0)
    for n in (5, 8, 11):
        prompt = rng.integers(2, jcfg.vocab_size, size=n).astype(np.int32)
        want = _model_greedy(jcfg, jp, prompt, 6, 64)
        eng = JS.ServeEngine(jcfg, jp, batch_slots=1, max_seq=64, eos_id=-1,
                             target=jhw.CPU_CACHE)
        got = eng.run([JS.Request(0, prompt, 6)], {})[0].out
        assert got[0] == want[0]
        assert (got == want) == (n == 8), (n, got, want)


def test_hybrid_zero_replans_and_block_plan(hybrid):
    """The hybrid plan is MLP-only; ``execute_block_plan`` runs it on the
    first local layer, attention included."""
    _, _, tcfg, tp = hybrid
    eng = TS.ServeEngine(dataclasses.replace(tcfg, ftl_mode="fused"), tp,
                         batch_slots=2, max_seq=64, eos_id=-1,
                         target=thw.CPU_CACHE, device="cpu")
    p, kind = eng._first_block_params()
    assert kind == "local" and "attn" in p and "mlp" in p
    eng.warmup_compile()
    eng.run([TS.Request(i, q, 3)
             for i, q in enumerate(_prompts(tcfg.vocab_size))])
    assert eng.stats["replans"] == 0
    assert eng.plans.counters()["misses_after_warmup"] == 0
    assert eng.plan_report()["prefill"]["executors"]["mlp"] == \
        "cuda_fused_mlp"
    blk = eng.execute_block_plan()
    assert blk["finite"]


def test_hybrid_cli_runs_on_cpu(capsys):
    TS.main(["--arch", "recurrentgemma-9b", "--reduced", "--device", "cpu",
             "--requests", "3", "--slots", "2", "--prompt-len", "40",
             "--max-new", "3", "--max-seq", "64", "--target", "cpu_cache"])
    out = capsys.readouterr().out
    assert "dense KV" in out
    assert "served 3 requests" in out and "0 decode replans" in out


@pytest.mark.parametrize("ring", [True, False])
def test_splice_cuts_only_a_local_ring(ring):
    """A prefill leaf longer than its slot is cut to the slot only when it
    is a local-window ring (its rows past ``max_seq`` are padding); any
    other leaf raises rather than losing rows."""
    full = torch.full((2, 3, 4, 5), 7.0)      # (periods, slots, seq, dim)
    one = torch.arange(2 * 6 * 5, dtype=torch.float32).reshape(2, 1, 6, 5)
    if not ring:
        with pytest.raises(ValueError, match="does not fit"):
            TS._splice(full, one, 1, 1)
        return
    TS._splice(full, one, 1, 1, ring=True)
    assert torch.equal(full[:, 1], one[:, 0, :4])
    assert bool((full[:, 0] == 7).all() and (full[:, 2] == 7).all())
    short = torch.ones(1, 2, 5)                # (slots=1, seq 2 < 4, dim)
    TS._splice(full[0], short, 0, 0)
    assert torch.equal(full[0, 0, :2], short[0])
    assert bool((full[0, 0, 2:] == 0).all())
