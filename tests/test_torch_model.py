"""The port's model against the JAX package's on the same weights.

``llama3.2-3b.reduced()`` in fp32: the JAX ``init_params`` tree goes
through ``params_from_numpy``; ``forward``, ``prefill`` (with
``last_pos``) and ``decode_step`` (with a vector ``pos``) give the same
logits within 1e-4, and the same KV caches.  Both sides plan on the same
explicit default target.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jconfigs.get_config("llama3.2-3b").reduced(),
                               remat=False)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(autouse=True)
def same_target():
    jhw.set_default_target("cpu_cache")
    thw.set_default_target("cpu_cache")
    yield
    jhw.set_default_target(None)
    thw.set_default_target(None)


def _cfgs(mode):
    return (dataclasses.replace(jconfigs.get_config("llama3.2-3b").reduced(),
                                remat=False, ftl_mode=mode),
            dataclasses.replace(tconfigs.get_config("llama3.2-3b").reduced(),
                                remat=False, ftl_mode=mode))


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(2, vocab, size=(b, s))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_param_tree_matches_reference_structure(weights):
    jnp_tree = weights[1]
    _, tcfg = _cfgs("off")
    tp = TM.init_params(tcfg, 0, device="cpu")
    flat = lambda t: {k: v.shape for k, v in _flatten(t)}  # noqa: E731
    assert flat(tp) == flat(jnp_tree)
    conv = params_from_numpy(jnp_tree, "cpu")
    assert all(v.dtype == torch.float32 for _, v in _flatten(conv))


def _flatten(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, pre + k + ".")
        else:
            yield pre + k, v


def test_init_scales_follow_the_reference():
    """Same distributions and scales as the reference initializers."""
    _, tcfg = _cfgs("off")
    cfg = dataclasses.replace(tcfg, d_model=256, d_ff=512, vocab_size=4096)
    p = TM.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    a = p["layers"]["pos0"]
    std = lambda t: float(t.float().std())  # noqa: E731
    assert abs(std(p["embed"]["tok"]) - 256 ** -0.5) < 0.02 * 256 ** -0.5
    assert abs(std(a["attn"]["wq"]["w"]) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    wo = (cfg.n_heads * cfg.resolved_head_dim) ** -0.5 / (2 * 4) ** 0.5
    assert abs(std(a["attn"]["wo"]["w"]) - wo) < 0.05 * wo
    w2 = 512 ** -0.5 / (2 * 4) ** 0.5
    assert abs(std(a["mlp"]["w2"]["w"]) - w2) < 0.05 * w2
    assert torch.equal(a["ln1"]["scale"], torch.ones(4, 256))


@pytest.mark.parametrize("mode", ["off", "auto", "fused"])
def test_forward_matches_reference(weights, mode):
    jp, npp = weights
    jcfg, tcfg = _cfgs(mode)
    toks = _tokens(2, 16, jcfg.vocab_size)
    jl, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, _ = TM.forward(tcfg, params_from_numpy(npp, "cpu"),
                       {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)


@pytest.mark.parametrize("mode", ["off", "fused"])
def test_prefill_and_vector_decode_match_reference(weights, mode):
    jp, npp = weights
    tp = params_from_numpy(npp, "cpu")
    jcfg, tcfg = _cfgs(mode)
    toks = _tokens(2, 16, jcfg.vocab_size, seed=1)
    # bucket-padded prompt: the real last token sits at index 10
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_seq=32,
                        last_pos=jnp.int32(10))
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                        max_seq=32, last_pos=10)
    _close(tl, jl)
    _close(tc["layers"]["pos0"]["k"], jc["layers"]["pos0"]["k"])
    _close(tc["layers"]["pos0"]["v"], jc["layers"]["pos0"]["v"])
    # one decode step with each row at its own position
    pos = np.array([11, 16])
    nxt = np.array([[5], [7]])
    for _ in range(2):
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(nxt), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(nxt), tc,
                                torch.from_numpy(pos))
        _close(tl, jl)
        _close(tc["layers"]["pos0"]["k"], jc["layers"]["pos0"]["k"])
        nxt = np.array(jnp.argmax(jl[:, 0], -1))[:, None]
        pos = pos + 1


def test_scalar_decode_matches_reference(weights):
    jp, npp = weights
    tp = params_from_numpy(npp, "cpu")
    jcfg, tcfg = _cfgs("off")
    toks = _tokens(1, 8, jcfg.vocab_size, seed=2)
    _, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_seq=16)
    _, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                       max_seq=16)
    jl, _ = JM.decode_step(jcfg, jp, jnp.asarray([[3]]), jc, jnp.int32(8))
    tl, _ = TM.decode_step(tcfg, tp, torch.tensor([[3]]), tc,
                           torch.tensor(8))
    _close(tl, jl)


def test_local_window_prefill_and_decode_match_reference():
    """The ring-buffered local-window cache of an 'attn'-only stack with a
    window (the layers' window path) against the reference layers."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    jcfg, tcfg = _cfgs("off")
    d, w = jcfg.d_model, 8
    ka = jax.random.PRNGKey(4)
    jpa = JL.init_attention(jcfg, ka)
    tpa = params_from_numpy(jax.tree.map(np.asarray, jpa), "cpu")
    x = np.random.default_rng(5).standard_normal((2, 12, d)).astype(
        np.float32)
    pos = np.arange(12)
    jo, jcache = JL.attention_prefill(jcfg, jpa, jnp.asarray(x),
                                      positions=jnp.asarray(pos), window=w)
    to, tcache = TL.attention_prefill(tcfg, tpa, torch.from_numpy(x),
                                      positions=torch.from_numpy(pos),
                                      window=w)
    _close(to, jo)
    _close(tcache["k"], jcache["k"])
    x1 = x[:, :1]
    p = np.array([12, 12])
    jo, _ = JL.attention_decode(jcfg, jpa, jnp.asarray(x1), jcache,
                                jnp.asarray(p, jnp.int32), window=w)
    to, _ = TL.attention_decode(tcfg, tpa, torch.from_numpy(x1), tcache,
                                torch.from_numpy(p), window=w)
    _close(to, jo)


def test_unported_families_raise():
    cfg = tconfigs.ModelConfig(name="ssm", family="ssm", n_layers=2,
                               d_model=32, n_heads=2, n_kv_heads=2, d_ff=0,
                               vocab_size=16, dtype="float32")
    with pytest.raises(NotImplementedError):
        TM.init_params(cfg, 0, device="cpu")


def test_bucket_m_ladder():
    assert TM.bucket_m(1) == 8 and TM.bucket_m(200) == 256
    assert TM.bucket_m(1024) == 1024
    with pytest.raises(ValueError):
        TM.bucket_m(5000)
    with pytest.raises(ValueError):
        TM.bucket_m(0)
