"""The port's model against the JAX package's on the same weights.

The dense configs' ``.reduced()`` in fp32 (llama3.2-3b, yi-6b, and
qwen2-72b with its QKV bias): the JAX ``init_params`` tree goes through
``params_from_numpy``; ``forward``, ``prefill`` (with ``last_pos``) and
``decode_step`` (with a vector ``pos``) give the same logits within
1e-4, and the same KV caches.  Both sides plan on the same explicit
default target.
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
DENSE = ["llama3.2-3b", "yi-6b", "qwen2-72b"]


@pytest.fixture(scope="module", params=DENSE)
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def weights(arch):
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(),
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


def _cfgs(mode, arch="llama3.2-3b"):
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(),
                                remat=False, ftl_mode=mode),
            dataclasses.replace(tconfigs.get_config(arch).reduced(),
                                remat=False, ftl_mode=mode))


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(2, vocab, size=(b, s))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_param_tree_matches_reference_structure(weights, arch):
    jnp_tree = weights[1]
    _, tcfg = _cfgs("off", arch)
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
def test_forward_matches_reference(weights, arch, mode):
    jp, npp = weights
    jcfg, tcfg = _cfgs(mode, arch)
    toks = _tokens(2, 16, jcfg.vocab_size)
    jl, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, _ = TM.forward(tcfg, params_from_numpy(npp, "cpu"),
                       {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)


@pytest.mark.parametrize("mode", ["off", "fused"])
def test_prefill_and_vector_decode_match_reference(weights, arch, mode):
    jp, npp = weights
    tp = params_from_numpy(npp, "cpu")
    jcfg, tcfg = _cfgs(mode, arch)
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


def test_scalar_decode_matches_reference(weights, arch):
    jp, npp = weights
    tp = params_from_numpy(npp, "cpu")
    jcfg, tcfg = _cfgs("off", arch)
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
    """Every family of the reference builds now (encoder–decoder and
    cross-attention since the whisper/VLM slice); a stack whose layer
    kinds the port does not build still raises, at every entry point,
    naming the kinds it builds."""
    base = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                vocab_size=16, dtype="float32")
    cfg = tconfigs.ModelConfig(name="odd", family="hybrid", d_ff=64,
                               block_pattern=("attn", "conv"), **base)
    toks = torch.zeros((1, 4), dtype=torch.long)
    for call in (lambda: TM.init_params(cfg, 0, device="cpu"),
                 lambda: TM.init_cache(cfg, 1, 8, device="cpu"),
                 lambda: TM.forward(cfg, {}, {"tokens": toks}),
                 lambda: TM.prefill(cfg, {}, {"tokens": toks})):
        with pytest.raises(NotImplementedError,
                           match=r"\['conv'\].*attn, local window, cross"):
            call()
    for name in ("whisper-base", "llama-3.2-vision-90b"):
        TM.init_params(tconfigs.get_config(name).reduced(), 0, device="cpu")


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b",
                                  "yi-6b", "qwen2-72b"])
def test_new_configs_match_reference(name):
    """The port's copies of the MoE and remaining dense configs equal the
    reference's, and build at ``.reduced()``."""
    assert dataclasses.asdict(tconfigs.get_config(name)) == \
        dataclasses.asdict(jconfigs.get_config(name))
    cfg = tconfigs.get_config(name).reduced()
    p = TM.init_params(cfg, 0, device="cpu")
    assert ("moe" in p["layers"]["pos0"]) == cfg.is_moe


def test_bucket_m_ladder():
    assert TM.bucket_m(1) == 8 and TM.bucket_m(200) == 256
    assert TM.bucket_m(1024) == 1024
    with pytest.raises(ValueError):
        TM.bucket_m(5000)
    with pytest.raises(ValueError):
        TM.bucket_m(0)
