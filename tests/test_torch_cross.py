"""The port's cross-attention layers (llama-3.2-vision-90b) against the
JAX package's.

``llama-3.2-vision-90b.reduced()`` in fp32 (4 layers, every 2nd a
``cross`` layer over 16 image tokens): the JAX ``init_params`` tree goes
through ``params_from_numpy``, with every ``xgate`` set to 0.5 on both
sides (at the reference's zero init ``tanh(0)·o = 0`` hides the
cross-attention from every output).  ``forward``, ``prefill`` (with
``last_pos``) and ``decode_step`` (with a vector ``pos``) give the same
logits within 1e-4, and the same caches; the attention layers with a
``kv_source`` and ``attention_decode(cross=True)`` match the reference's;
the engine serves from a dense cache and gives the JAX engine's tokens.
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
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import steps as JST  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.launch import kv_cache as TKV  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import steps as TST  # noqa: E402

ARCH = "llama-3.2-vision-90b"
TOL = dict(rtol=1e-4, atol=1e-4)
XGATE = 0.5


def _cfgs(**kw):
    kw = {"remat": False, **kw}
    return (dataclasses.replace(jconfigs.get_config(ARCH).reduced(), **kw),
            dataclasses.replace(tconfigs.get_config(ARCH).reduced(), **kw))


def _gated(path, leaf):
    return (jnp.full_like(leaf, XGATE)
            if jax.tree_util.keystr(path).endswith("['xgate']") else leaf)


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map_with_path(_gated, jp)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(autouse=True)
def same_target():
    jhw.set_default_target("cpu_cache")
    thw.set_default_target("cpu_cache")
    yield
    jhw.set_default_target(None)
    thw.set_default_target(None)


def _image(cfg, b=1, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)


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


def _batch(toks, img, lib):
    if lib is torch:
        return {"tokens": torch.from_numpy(toks),
                "image_embeds": torch.from_numpy(img)}
    return {"tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)}


def test_param_tree_matches_reference_structure(weights):
    jp, tp = weights
    _, tcfg = _cfgs()
    own = TM.init_params(tcfg, 0, device="cpu")
    shapes = lambda tree: {k: tuple(v.shape)  # noqa: E731
                           for k, v in _flat(tree)}
    assert shapes(own) == shapes(jax.tree.map(np.asarray, jp))
    assert TM.period_kinds(tcfg) == ["attn", "cross"]
    x = own["layers"]["pos1"]["xgate"]
    assert x.dtype == torch.float32 and x.shape == (2, 1) and not x.any()
    assert tp["layers"]["pos1"]["xgate"].eq(XGATE).all()


def test_cross_attention_layers_match_reference(weights):
    """``attention_layer`` and ``attention_prefill`` with a ``kv_source``
    (not causal, no rope, the cache the context's whole K and V), then
    ``attention_decode(cross=True)`` on that cache."""
    jp, _ = weights
    jcfg, tcfg = _cfgs()
    jpa = jax.tree.map(lambda a: a[0], jp["layers"]["pos1"]["attn"])
    tpa = params_from_numpy(jax.tree.map(np.asarray, jpa), "cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    ctx = _image(jcfg, 2, seed=1)
    pos = np.arange(9)
    kw = dict(causal=False, use_rope=False)
    _close(TL.attention_layer(tcfg, tpa, torch.from_numpy(x),
                              positions=torch.from_numpy(pos),
                              kv_source=torch.from_numpy(ctx), **kw),
           JL.attention_layer(jcfg, jpa, jnp.asarray(x),
                              positions=jnp.asarray(pos),
                              kv_source=jnp.asarray(ctx), **kw))
    jo, jc = JL.attention_prefill(jcfg, jpa, jnp.asarray(x),
                                  positions=jnp.asarray(pos),
                                  kv_source=jnp.asarray(ctx), **kw)
    to, tc = TL.attention_prefill(tcfg, tpa, torch.from_numpy(x),
                                  positions=torch.from_numpy(pos),
                                  kv_source=torch.from_numpy(ctx),
                                  pad_to=32, length=5, **kw)
    _close(to, jo)
    assert tc["k"].shape[1] == jcfg.n_image_tokens
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    keep = {k: v.clone() for k, v in tc.items()}
    jo, _ = JL.attention_decode(jcfg, jpa, jnp.asarray(x[:, :1]), jc,
                                jnp.asarray([3, 7], jnp.int32), cross=True)
    to, _ = TL.attention_decode(tcfg, tpa, torch.from_numpy(x[:, :1]), tc,
                                torch.tensor([3, 7]), cross=True)
    _close(to, jo)
    assert all(torch.equal(keep[k], tc[k]) for k in keep)


def test_forward_matches_reference(weights):
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    toks, img = _tokens(2, 12, jcfg.vocab_size), _image(jcfg, 2)
    jl, _ = jax.jit(functools.partial(JM.forward, jcfg))(
        jp, _batch(toks, img, jnp))
    tl, aux = TM.forward(tcfg, tp, _batch(toks, img, torch))
    _close(tl, jl)
    assert float(aux) == 0.0
    # the gate carries the cross-attention: at xgate = 0 the logits move
    cross = tp["layers"]["pos1"]
    zero = {**tp, "layers": {**tp["layers"], "pos1": {
        **cross, "xgate": torch.zeros_like(cross["xgate"])}}}
    tl0, _ = TM.forward(tcfg, zero, _batch(toks, img, torch))
    assert float((tl0 - tl).abs().max()) > 1e-3


def test_prefill_and_decode_match_reference(weights):
    """``prefill`` read at ``last_pos`` with ``max_seq`` (self-attention
    KV padded to it, the cross layers' K and V the 16 image tokens whole),
    then 3 ``decode_step``s at a vector ``pos``."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    toks, img = _tokens(2, 16, jcfg.vocab_size, 2), _image(jcfg, 2, 2)
    jl, jc = JM.prefill(jcfg, jp, _batch(toks, img, jnp), max_seq=24,
                        last_pos=jnp.int32(10))
    tl, tc = TM.prefill(tcfg, tp, _batch(toks, img, torch), max_seq=24,
                        last_pos=10)
    _close(tl, jl)
    jflat = dict(_flat(jax.tree.map(np.asarray, jc)))
    tflat = dict(_flat(tc))
    assert set(tflat) == set(jflat)
    for name, t in tflat.items():
        _close(t, jflat[name])
    assert tc["layers"]["pos1"]["k"].shape[2] == jcfg.n_image_tokens
    assert tc["layers"]["pos0"]["k"].shape[2] == 24
    decode = jax.jit(functools.partial(JM.decode_step, jcfg))
    pos = np.array([11, 13])
    rng = np.random.default_rng(3)
    for i in range(3):
        tok = rng.integers(2, jcfg.vocab_size, size=(2, 1))
        jl, jc = decode(jp, jnp.asarray(tok), jc,
                        jnp.asarray(pos + i, jnp.int32))
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos + i))
        _close(tl, jl)


def test_init_cache_holds_the_image_tokens():
    _, tcfg = _cfgs()
    c = TM.init_cache(tcfg, 3, 40, device="cpu")
    assert c["layers"]["pos0"]["k"].shape == (2, 3, 40, 4, 32)
    assert c["layers"]["pos1"]["v"].shape == (2, 3, tcfg.n_image_tokens, 4,
                                              32)


def test_bf16_forward_matches_reference_loosely(weights):
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jp = jax.tree.map(lambda a: a if a.dtype == jnp.float32 and a.shape[-1:]
                      == (1,) else a.astype(jnp.bfloat16), weights[0])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["layers"]["pos1"]["xgate"].dtype == torch.float32
    toks, img = _tokens(1, 10, jcfg.vocab_size, 4), _image(jcfg, 1, 4)
    jl, _ = jax.jit(functools.partial(JM.forward, jcfg))(
        jp, {"tokens": jnp.asarray(toks),
             "image_embeds": jnp.asarray(img, jnp.bfloat16)})
    tl, _ = TM.forward(tcfg, tp, {
        "tokens": torch.from_numpy(toks),
        "image_embeds": torch.from_numpy(img).to(torch.bfloat16)})
    assert tl.dtype == torch.bfloat16
    _close(tl, np.asarray(jl, np.float32), rtol=5e-2, atol=5e-2)


def test_loss_and_gradients_match_reference(weights):
    """Under ``ftl_mode="off"`` with ``image_embeds`` in the batch: the
    loss and every leaf's gradient, ``xgate`` included, within 2e-5 of
    that leaf's largest."""
    jp, _ = weights
    jcfg, tcfg = _cfgs(ftl_mode="off")
    toks = _tokens(2, 12, jcfg.vocab_size, 5).astype(np.int32)
    img = _image(jcfg, 2, 5)
    (jl, _), jg = jax.jit(jax.value_and_grad(JST.make_loss_fn(jcfg),
                                             has_aux=True))(
        jp, _batch(toks, img, jnp))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    names, leaves = zip(*_flat(tp))
    for p in leaves:
        p.requires_grad_(True)
    tl, _ = TST.make_loss_fn(tcfg)(tp, _batch(toks, img, torch))
    gs = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    jflat = dict(_flat(jax.tree.map(np.asarray, jg)))
    assert set(names) == set(jflat)
    for name, g in zip(names, gs):
        want = jflat[name]
        got = np.zeros(want.shape, np.float32) if g is None else g.numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 2e-5 * scale, name
    assert float(np.abs(jflat["layers/pos1/xgate"]).max()) > 0


def test_engine_matches_reference_engine(weights):
    """Two slots, mixed prompt lengths, one ``image_embeds`` set shared as
    ``extras``: a dense cache (cross layers cannot page), and the JAX
    engine's greedy tokens."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    img = _image(jcfg, 1, seed=6)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 13, 8)]
    teng = TS.ServeEngine(tcfg, tp, batch_slots=2, max_seq=32, eos_id=-1,
                          target=thw.CPU_CACHE, device="cpu")
    assert not teng.paged and not TKV.paged_supported(tcfg)
    jeng = JS.ServeEngine(jcfg, jp, batch_slots=2, max_seq=32, eos_id=-1,
                          target=jhw.CPU_CACHE)
    tout = {r.rid: r.out for r in teng.run(
        [TS.Request(i, p, 5) for i, p in enumerate(prompts)],
        {"image_embeds": torch.from_numpy(img)})}
    jout = {r.rid: r.out for r in jeng.run(
        [JS.Request(i, p, 5) for i, p in enumerate(prompts)],
        {"image_embeds": jnp.asarray(img)})}
    assert tout == jout


def test_cli_runs_on_cpu(capsys):
    TS.main(["--arch", ARCH, "--reduced", "--device", "cpu",
             "--requests", "3", "--slots", "2", "--prompt-len", "8",
             "--max-new", "6", "--max-seq", "64", "--target", "cpu_cache"])
    out = capsys.readouterr().out
    assert "dense KV" in out and "'mlp': 'cuda_fused_mlp'" in out
    assert "served 3 requests" in out and "0 decode replans" in out


def test_serving_mode_is_fused():
    """The VLM's gated MLP is served under ``"fused"``."""
    assert TS.serving_ftl_mode(tconfigs.get_config(ARCH)) == "fused"
