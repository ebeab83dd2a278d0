"""The port's xLSTM family (xlstm-1.3b, reduced) against the JAX package's,
on the same weights.

``xlstm-1.3b.reduced()`` has 4 layers and ``slstm_every`` 8, so it holds
four mLSTM layers and no sLSTM, all past the last whole period (under
``rem``); ``slstm_every=2`` gives two whole (mLSTM, sLSTM) periods.  The
JAX ``init_params`` tree goes through ``params_from_numpy``.  fp32 logits
of ``forward``, ``prefill`` and ``decode_step`` agree within rtol = atol =
1e-4 (the tolerance of ``tests/test_torch_model.py``); decode also matches
the port's own teacher-forced forward at the reference smoke test's
5e-3.  The engine's greedy tokens equal the JAX *model's* loop on the
unpadded prompt; the JAX engine's do not, unless the prompt fills its
bucket (it takes the state after the pads).
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
from repro_torch.models import model as TM  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "xlstm-1.3b"
# the reduced stack (4 mLSTM layers, no sLSTM) and one with sLSTM layers
VARIANTS = {"reduced": {}, "slstm_every2": {"slstm_every": 2}}


def _cfgs(variant="reduced", **kw):
    over = dict(VARIANTS[variant], remat=False, **kw)
    return (dataclasses.replace(jconfigs.get_config(ARCH).reduced(), **over),
            dataclasses.replace(tconfigs.get_config(ARCH).reduced(), **over))


@pytest.fixture(scope="module")
def weights():
    out = {}
    for variant in VARIANTS:
        jcfg, _ = _cfgs(variant)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
        out[variant] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                              "cpu"))
    return out


def _flatten(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, pre + k + ".")
        else:
            yield pre + k, v


def _spec(tree):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in _flatten(tree)}


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(2, vocab, size=(b, s))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def test_config_is_the_reference_copy():
    j, t = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert ARCH in tconfigs.ARCHS
    assert TM.period_kinds(t) == ["mlstm"] * 7 + ["slstm"]
    assert (t.n_layers, t.d_model, t.n_heads, t.xlstm_expand,
            t.vocab_size, t.d_ff) == (48, 2048, 4, 2, 50304, 0)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_keys_shapes_dtypes_match_reference(variant, dtype):
    """Same keys, shapes and dtypes as the reference tree (``wi``, ``wf``
    and the sLSTM's ``r*`` in fp32 beside bf16 leaves), and the converter
    keeps each leaf's dtype."""
    jcfg, tcfg = _cfgs(variant, dtype=dtype)
    jtree = jax.tree.map(np.asarray,
                         JM.init_params(jcfg, jax.random.PRNGKey(0)))
    want = _spec(jtree)
    assert _spec(TM.init_params(tcfg, 0, device="cpu")) == want
    assert _spec(params_from_numpy(jtree, "cpu")) == want
    if variant == "reduced":       # 4 layers, period 8: all under ``rem``
        assert set(jtree["rem"]) == {f"rem{i}" for i in range(4)}
        assert want["rem.rem0.mix.wi.w"][1] == "float32"
    else:
        assert "rem" not in want
        assert want["layers.pos1.mix.rz"][1] == "float32"


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_reference(weights, variant):
    jp, tp = weights[variant]
    jcfg, tcfg = _cfgs(variant)
    toks = _tokens(2, 24, jcfg.vocab_size)
    jl, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, _ = TM.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_reference(weights, variant):
    """Prefill logits and every cache leaf, then decode steps with a
    vector position, against the reference; decode against the port's
    own teacher-forced forward (the reference smoke test's check)."""
    jp, tp = weights[variant]
    jcfg, tcfg = _cfgs(variant)
    s, extra = 10, 4
    toks = _tokens(2, s + extra, jcfg.vocab_size, seed=7)
    tfull, _ = TM.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :s])},
                        max_seq=s + extra)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :s])},
                        max_seq=s + extra)
    _close(tl, jl)
    jflat = dict(_flatten(jax.tree.map(np.asarray, jc)))
    tflat = dict(_flatten(tc))
    assert _spec(tc) == _spec(jax.tree.map(np.asarray, jc))
    for name, leaf in tflat.items():
        _close(leaf, jflat[name])
    for i in range(extra):
        tok = toks[:, s + i:s + i + 1]
        pos = np.full((2,), s + i)
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(tok), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        _close(tl, jl)
        _close(tl[:, 0], tfull[:, s + i].numpy(), rtol=5e-3, atol=5e-3)
    jflat = dict(_flatten(jax.tree.map(np.asarray, jc)))
    for name, leaf in _flatten(tc):
        _close(leaf, jflat[name])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_decode_dtype_discipline(variant):
    """The reference smoke test's bf16 case: finite logits, and every
    cache leaf keeps its dtype (fp32 state) through a decode step."""
    _, tcfg = _cfgs(variant, dtype="bfloat16")
    tp = TM.init_params(tcfg, 0, device="cpu")
    b, s = 2, 16
    toks = torch.from_numpy(_tokens(b, s, tcfg.vocab_size, seed=3))
    _, cache = TM.prefill(tcfg, tp, {"tokens": toks}, max_seq=s + 2)
    before = {k: v.dtype for k, v in _flatten(cache)}
    logits, cache2 = TM.decode_step(tcfg, tp, torch.ones((b, 1),
                                                         dtype=torch.long),
                                    cache, torch.tensor(s))
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())
    assert {k: v.dtype for k, v in _flatten(cache2)} == before
    assert set(before.values()) == {torch.float32}
    empty = TM.init_cache(tcfg, b, s + 2, device="cpu")
    assert {k: v.dtype for k, v in _flatten(empty)} == before


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_state_at_last_pos_equals_unpadded_prefill(weights, variant):
    """A right-padded prompt prefilled with ``last_pos`` leaves the decode
    state of the unpadded prompt (mLSTM C/n/m, sLSTM h/c/n/m)."""
    jp, tp = weights[variant]
    jcfg, tcfg = _cfgs(variant)
    for n, bucket in ((5, 8), (13, 16)):
        toks = _tokens(1, bucket, jcfg.vocab_size, seed=n)
        jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :n])},
                            max_seq=32)
        tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                            max_seq=32, last_pos=n - 1)
        _close(tl, jl)
        jflat = dict(_flatten(jax.tree.map(np.asarray, jc)))
        for name, leaf in _flatten(tc):
            _close(leaf, jflat[name])


def test_stateless_forward_refuses_the_chunked_remat_scan(weights):
    """The stateless ``forward`` with ``mlstm_chunk > 0`` (the
    reference's remat scan; the name is kept from when the port refused
    it) matches the reference's logits, at a T the chunk of 16 does not
    divide (both halve it to 8) and on both stacks."""
    for variant in VARIANTS:
        jp, tp = weights[variant]
        jcfg, tcfg = _cfgs(variant, mlstm_chunk=16)
        toks = _tokens(2, 24, jcfg.vocab_size, seed=5)
        jl, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
        tl, _ = TM.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
        _close(tl, jl)


def test_unsupported_families_name_what_the_port_serves():
    """A stack with a layer kind the port does not build raises, naming
    what it builds (xLSTM's mLSTM and sLSTM among them); the reference's
    encoder–decoder, which raised here before the whisper slice, builds."""
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(),
                               family="hybrid",
                               block_pattern=("mlstm", "gru"))
    with pytest.raises(NotImplementedError,
                       match=r"\['gru'\].*xLSTM \(mlstm, slstm\)"):
        TM.init_params(tcfg, 0, device="cpu")
    cfg = jconfigs.get_config("whisper-base")
    p = TM.init_params(tconfigs.get_config(cfg.name).reduced(), 0,
                       device="cpu")
    assert "enc_layers" in p


# ---------------------------------------------------------------------------
# serving: a dense per-slot state cache, no plannable block
# ---------------------------------------------------------------------------

def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=n).astype(np.int32) for n in lens]


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


@pytest.mark.parametrize("variant,slots", [("reduced", 1), ("reduced", 2),
                                           ("slstm_every2", 2)])
def test_engine_tokens_match_reference_model_loop(weights, variant, slots):
    jp, tp = weights[variant]
    jcfg, tcfg = _cfgs(variant)
    prompts = _prompts(jcfg.vocab_size, (5, 8, 11), seed=slots)
    eng = TS.ServeEngine(tcfg, tp, batch_slots=slots, max_seq=64, eos_id=-1,
                         target=thw.CPU_CACHE, device="cpu")
    assert not eng.paged
    got = {r.rid: r.out for r in eng.run(
        [TS.Request(i, p, 6) for i, p in enumerate(prompts)])}
    want = {i: _model_greedy(jcfg, jp, p, 6, 64)
            for i, p in enumerate(prompts)}
    assert got == want


def test_reference_engine_takes_xlstm_state_at_bucket_end(weights):
    """Why the port is held to the JAX model's loop and not to the JAX
    engine: the JAX engine prefills the padded bucket and keeps the
    mLSTM state after the pads, so its tokens leave the model's after
    the first one unless the prompt fills its bucket."""
    jp, _ = weights["reduced"]
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(0)
    for n in (5, 8, 11):
        prompt = rng.integers(2, jcfg.vocab_size, size=n).astype(np.int32)
        want = _model_greedy(jcfg, jp, prompt, 6, 64)
        eng = JS.ServeEngine(jcfg, jp, batch_slots=1, max_seq=64, eos_id=-1,
                             target=jhw.CPU_CACHE)
        got = eng.run([JS.Request(0, prompt, 6)], {})[0].out
        assert got[0] == want[0]
        assert (got == want) == (n == 8), (n, got, want)


def test_engine_has_no_plannable_block(weights):
    """No attention and no MLP: the CLI serves it with ``ftl_mode='off'``,
    both plans are None, ``execute_block_plan`` returns None and steady
    state replans zero times."""
    assert TS.serving_ftl_mode(tconfigs.get_config(ARCH)) == "off"
    _, tp = weights["slstm_every2"]
    _, tcfg = _cfgs("slstm_every2", ftl_mode="fused")
    eng = TS.ServeEngine(tcfg, tp, batch_slots=2, max_seq=32, eos_id=-1,
                         target=thw.CPU_CACHE, device="cpu")
    assert eng.block_plan is None and eng.decode_plan is None
    assert eng._first_block_params() == (None, None)
    assert eng.execute_block_plan() is None
    rep = eng.plan_report()
    assert rep["prefill"] is None and rep["decode"] is None
    eng.warmup_compile()
    eng.run([TS.Request(i, q, 3)
             for i, q in enumerate(_prompts(tcfg.vocab_size, (5, 13)))])
    assert eng.stats["replans"] == 0
    assert eng.plans.counters()["misses_after_warmup"] == 0
    # the slots' state: fp32 C (periods, slots, H, Dh, Dh)
    e = tcfg.xlstm_expand * tcfg.d_model
    dh = e // tcfg.n_heads
    assert eng.cache["layers"]["pos0"]["C"].shape == (2, 2, tcfg.n_heads,
                                                      dh, dh)


def test_cli_runs_on_cpu(capsys):
    TS.main(["--arch", ARCH, "--reduced", "--device", "cpu",
             "--requests", "3", "--slots", "2", "--prompt-len", "8",
             "--max-new", "6", "--max-seq", "64", "--target", "cpu_cache"])
    out = capsys.readouterr().out
    assert "dense KV" in out and "no plannable block" in out
    assert "served 3 requests" in out and "0 decode replans" in out
