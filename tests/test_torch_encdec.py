"""The port's encoder–decoder (whisper-base) against the JAX package's.

``whisper-base.reduced()`` in fp32 (2 encoder and 4 decoder layers over 64
frames): the JAX ``init_params`` tree goes through ``params_from_numpy``;
``_encode``, ``forward``, ``prefill`` (with ``last_pos`` on a right-padded
prompt) and four ``decode_step``s give the same logits and caches within
1e-4; the loss and its gradient under ``ftl_mode="off"`` match
``jax.value_and_grad``; bf16 within a loose tolerance.

Serving: the port's engine decodes each slot at its own position, so its
tokens for mixed prompt lengths equal each request's JAX *model* loop at
batch 1.  The JAX engine decodes encoder–decoder slots at one scalar
position, the largest among the active slots, so a shorter request's
tokens leave its own loop: pinned below.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import steps as JST  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.launch import kv_cache as TKV  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import steps as TST  # noqa: E402

ARCH = "whisper-base"
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(**kw):
    kw = {"remat": False, **kw}
    return (dataclasses.replace(jconfigs.get_config(ARCH).reduced(), **kw),
            dataclasses.replace(tconfigs.get_config(ARCH).reduced(), **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(autouse=True)
def same_target():
    jhw.set_default_target("cpu_cache")
    thw.set_default_target("cpu_cache")
    yield
    jhw.set_default_target(None)
    thw.set_default_target(None)


def _frames(cfg, b=1, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(2, vocab, size=(b, s))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def _flat(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + k + "/")
        else:
            yield pre + k, v


def _caches_close(tcache, jcache):
    jflat = dict(_flat(jax.tree.map(np.asarray, jcache)))
    tflat = dict(_flat(tcache))
    assert set(tflat) == set(jflat)
    for name, t in tflat.items():
        assert tuple(t.shape) == jflat[name].shape, name
        _close(t, jflat[name])


@functools.lru_cache(maxsize=None)
def _jitted(jcfg, max_seq):
    return (jax.jit(functools.partial(JM.prefill, jcfg, max_seq=max_seq)),
            jax.jit(functools.partial(JM.decode_step, jcfg)))


def test_param_tree_matches_reference_structure(weights):
    jp, tp = weights
    _, tcfg = _cfgs()
    own = TM.init_params(tcfg, 0, device="cpu")
    shapes = lambda tree: {k: tuple(v.shape)  # noqa: E731
                           for k, v in _flat(tree)}
    assert shapes(own) == shapes(jax.tree.map(np.asarray, jp)) == shapes(tp)
    for name in ("enc_layers/pos0/attn/wq/w", "enc_norm/scale",
                 "layers/pos0/lnx/bias", "layers/pos0/xattn/wk/b",
                 "layers/pos0/mlp/w2/b"):
        assert name in shapes(own), name


@pytest.mark.parametrize("offset", [0, 7, 300])
def test_sinusoid_matches_reference(offset):
    _close(TM._sinusoid(5, 128, offset), JM._sinusoid(5, 128, offset))


def test_sinusoid_vector_offsets_are_one_row_each():
    """A (B,) offset gives each row the scalar sinusoid at its own offset
    (the reference's is scalar-only)."""
    offs = torch.tensor([0, 3, 41])
    got = TM._sinusoid(2, 64, offs)
    assert got.shape == (3, 2, 64)
    for i, o in enumerate(offs.tolist()):
        torch.testing.assert_close(got[i], TM._sinusoid(2, 64, o),
                                   rtol=0, atol=0)


def test_encode_matches_reference(weights):
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    fr = _frames(jcfg, 2)
    _close(TM._encode(tcfg, tp, torch.from_numpy(fr)),
           JM._encode(jcfg, jp, jnp.asarray(fr)))


def test_forward_matches_reference(weights):
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    fr, toks = _frames(jcfg, 2), _tokens(2, 12, jcfg.vocab_size)
    jl, jaux = jax.jit(functools.partial(JM.forward, jcfg))(
        jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)})
    tl, taux = TM.forward(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                     "frames": torch.from_numpy(fr)})
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0 and taux.dtype == torch.float32


def test_prefill_and_decode_match_reference(weights):
    """``prefill`` of a prompt padded on the right, read at ``last_pos``,
    with the self-attention cache padded to ``max_seq`` and the cross
    cache the encoder's whole length; then 4 ``decode_step``s at a scalar
    position: logits and every cache leaf."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    fr, toks = _frames(jcfg, 2, seed=1), _tokens(2, 16, jcfg.vocab_size, 1)
    max_seq, last = 24, 10
    prefill, decode = _jitted(jcfg, max_seq)
    jl, jc = prefill(jp, {"tokens": jnp.asarray(toks),
                          "frames": jnp.asarray(fr)},
                     last_pos=jnp.int32(last))
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                   "frames": torch.from_numpy(fr)},
                        max_seq=max_seq, last_pos=last)
    _close(tl, jl)
    _caches_close(tc, jc)
    assert tc["layers"]["pos0"]["self"]["k"].shape[2] == max_seq
    assert tc["layers"]["pos0"]["cross"]["k"].shape[2] == jcfg.encoder_seq
    rng = np.random.default_rng(2)
    for i in range(4):
        tok = rng.integers(2, jcfg.vocab_size, size=(2, 1))
        jl, jc = decode(jp, jnp.asarray(tok), jc, jnp.int32(last + 1 + i))
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(tok), tc,
                                torch.tensor(last + 1 + i))
        _close(tl, jl)
    _caches_close(tc, jc)


def test_vector_pos_decodes_each_row_at_its_own_position(weights):
    """``decode_step`` with a (B,) ``pos``: each row equals the reference's
    scalar decode of that row alone at its position (the KV written and
    masked there, its sinusoid taken there)."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    fr, toks = _frames(jcfg, 2, seed=3), _tokens(2, 16, jcfg.vocab_size, 3)
    lens = (5, 13)
    _, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                  "frames": torch.from_numpy(fr)},
                       max_seq=32)
    tok = _tokens(2, 1, jcfg.vocab_size, seed=4)
    tl, _ = TM.decode_step(tcfg, tp, torch.from_numpy(tok), tc,
                           torch.tensor(lens))
    prefill, decode = _jitted(jcfg, 32)
    for row, n in enumerate(lens):
        _, jc = prefill(jp, {"tokens": jnp.asarray(toks[row:row + 1, :n]),
                             "frames": jnp.asarray(fr[row:row + 1])})
        jl, _ = decode(jp, jnp.asarray(tok[row:row + 1]), jc, jnp.int32(n))
        _close(tl[row:row + 1], jl)


def test_bf16_forward_matches_reference_loosely(weights):
    """The fp32 weights cast to bf16, a bf16 forward on both sides."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), weights[0])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    fr, toks = _frames(jcfg, 1, seed=5), _tokens(1, 10, jcfg.vocab_size, 5)
    jl, _ = jax.jit(functools.partial(JM.forward, jcfg))(
        jp, {"tokens": jnp.asarray(toks),
             "frames": jnp.asarray(fr, jnp.bfloat16)})
    tl, _ = TM.forward(tcfg, tp, {
        "tokens": torch.from_numpy(toks),
        "frames": torch.from_numpy(fr).to(torch.bfloat16)})
    assert tl.dtype == torch.bfloat16
    _close(tl, np.asarray(jl, np.float32), rtol=5e-2, atol=5e-2)


def test_loss_and_gradients_match_reference(weights):
    """Under ``ftl_mode="off"``, with ``frames`` in the batch: the loss
    and every leaf's gradient (encoder, cross-attention and decoder) within
    2e-5 of that leaf's largest.  A key bias adds one score to every key a
    query sees, which the softmax cancels: its gradient is zero but for
    rounding, on both sides, so those leaves are held to be below 1e-6 of
    the largest gradient of any leaf."""
    jp, _ = weights
    jcfg, tcfg = _cfgs(ftl_mode="off")
    fr = _frames(jcfg, 2, seed=6)
    toks = _tokens(2, 12, jcfg.vocab_size, seed=6).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(JST.make_loss_fn(jcfg),
                                             has_aux=True))(
        jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)})
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    names, leaves = zip(*_flat(tp))
    for p in leaves:
        p.requires_grad_(True)
    tl, _ = TST.make_loss_fn(tcfg)(tp, {"tokens": torch.from_numpy(toks),
                                        "frames": torch.from_numpy(fr)})
    gs = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    jflat = dict(_flat(jax.tree.map(np.asarray, jg)))
    assert set(names) == set(jflat)
    top = max(float(np.abs(g).max()) for g in jflat.values())
    for name, g in zip(names, gs):
        want = jflat[name]
        got = np.zeros(want.shape, np.float32) if g is None else g.numpy()
        if name.endswith("wk/b"):
            assert max(float(np.abs(got).max()),
                       float(np.abs(want).max())) <= 1e-6 * top, name
            continue
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 2e-5 * scale, name
    for name in ("enc_layers/pos0/attn/wq/w", "layers/pos0/xattn/wk/w"):
        assert float(np.abs(jflat[name]).max()) > 0, name


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=n).astype(np.int32) for n in lens]


def _model_greedy(jcfg, jp, prompt, frames, n, max_seq):
    """The JAX model's own greedy loop on one unpadded prompt, batch 1
    (its prefill and decode step under ``jax.jit``)."""
    prefill, decode = _jitted(jcfg, max_seq)
    logits, cache = prefill(jp, {"tokens": jnp.asarray(prompt)[None],
                                 "frames": frames})
    out = [int(jnp.argmax(logits[0, -1]))]
    pos = len(prompt)
    while len(out) < n:
        logits, cache = decode(jp, jnp.asarray([[out[-1]]]), cache,
                               jnp.int32(pos))
        out.append(int(jnp.argmax(logits[0, -1])))
        pos += 1
    return out


@pytest.mark.parametrize("lens,slots", [((5, 13), 2), ((3, 11, 7, 20), 3)])
def test_engine_matches_model_loop(weights, lens, slots):
    """Mixed prompt lengths on 2-3 slots, one ``frames`` set shared as
    ``extras``: each request's tokens equal its own reference model loop
    at batch 1, and the cache is dense."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    fr = _frames(jcfg, seed=0)
    prompts = _prompts(jcfg.vocab_size, lens, seed=len(lens))
    eng = TS.ServeEngine(tcfg, tp, batch_slots=slots, max_seq=32, eos_id=-1,
                         target=thw.CPU_CACHE, device="cpu")
    assert not eng.paged and not TKV.paged_supported(tcfg)
    got = {r.rid: r.out for r in eng.run(
        [TS.Request(i, p, 6) for i, p in enumerate(prompts)],
        {"frames": torch.from_numpy(fr)})}
    want = {i: _model_greedy(jcfg, jp, p, jnp.asarray(fr), 6, 32)
            for i, p in enumerate(prompts)}
    assert got == want


def test_engine_splices_the_encdec_cache(weights):
    """After one admission the slot holds the request's prefill cache:
    ``self`` padded with zeros to ``max_seq``, ``cross`` whole."""
    _, tp = weights
    _, tcfg = _cfgs()
    fr = torch.from_numpy(_frames(tcfg, seed=7))
    prompt = _prompts(tcfg.vocab_size, (6,), seed=7)[0]
    eng = TS.ServeEngine(tcfg, tp, batch_slots=2, max_seq=32, eos_id=-1,
                         target=thw.CPU_CACHE, device="cpu")
    assert eng._admit(TS.Request(0, prompt, 4), 1, {"frames": fr})
    padded = np.zeros(8, np.int64)
    padded[:6] = prompt
    _, one = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(padded)[None],
                                   "frames": fr}, last_pos=5)
    got, want = eng.cache["layers"]["pos0"], one["layers"]["pos0"]
    torch.testing.assert_close(got["cross"]["k"][:, 1],
                               want["cross"]["k"][:, 0], rtol=0, atol=0)
    torch.testing.assert_close(got["self"]["v"][:, 1, :8],
                               want["self"]["v"][:, 0], rtol=0, atol=0)
    assert not got["self"]["v"][:, 1, 8:].any()
    assert not got["cross"]["k"][:, 0].any()


def test_reference_engine_decodes_encdec_at_the_largest_position(weights):
    """Why the port is held to the JAX model's loop and not to the JAX
    engine: the JAX engine decodes encoder–decoder slots at one scalar
    position, the largest among the active slots.  The longer request is
    decoded at its own position and keeps its loop's tokens; the shorter
    one writes its KV and takes its sinusoid at the longer one's, and
    leaves its loop."""
    jp, _ = weights
    jcfg, _ = _cfgs()
    fr = jnp.asarray(_frames(jcfg, seed=0))
    short, long_ = _prompts(jcfg.vocab_size, (5, 13), seed=2)
    eng = JS.ServeEngine(jcfg, jp, batch_slots=2, max_seq=32, eos_id=-1,
                         target=jhw.CPU_CACHE)
    assert not eng._vector_pos
    got = {r.rid: r.out for r in eng.run(
        [JS.Request(0, short, 6), JS.Request(1, long_, 6)], {"frames": fr})}
    assert got[1] == _model_greedy(jcfg, jp, long_, fr, 6, 32)
    want = _model_greedy(jcfg, jp, short, fr, 6, 32)
    assert got[0][0] == want[0]
    assert got[0] != want, (got[0], want)


def test_cli_runs_on_cpu(capsys):
    TS.main(["--arch", ARCH, "--reduced", "--device", "cpu",
             "--requests", "3", "--slots", "2", "--prompt-len", "8",
             "--max-new", "6", "--max-seq", "64", "--target", "cpu_cache"])
    out = capsys.readouterr().out
    assert "dense KV" in out
    assert "served 3 requests" in out and "0 decode replans" in out


def test_serving_mode_is_auto():
    """whisper-base's ungated MLP is served under ``"auto"``."""
    assert TS.serving_ftl_mode(tconfigs.get_config(ARCH)) == "auto"
