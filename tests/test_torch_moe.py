"""The port's Mixture-of-Experts against the JAX package's, on the CPU.

The reference's trees (``repro.models.moe.init_moe``, ``init_params``)
go through ``params_from_numpy``; inputs come from numpy with a seed.
fp32 within ``rtol = atol = 2e-5`` (``tests/test_block_exec.py``), bf16
by the port's loose rule (``2e-2 + 2e-2 |ref|``).  Routing is compared
exactly: the port's expert choices equal the reference's ``lax.top_k``
of the same fp32 router, and each case asserts the smallest gap between
a token's k-th and (k+1)-th router probability in its data (at least
1e-5 here: fp32 rounding, about 1e-7, cannot swap a choice), so that
identical routing is what the comparison holds.

* ``init_moe``'s tree and the MoE configs' whole trees: keys, shapes,
  dtypes (the router fp32).
* ``capacity`` over a grid of token counts for both full configs.
* ``moe_layer_scatter`` and ``moe_layer_grouped`` (``moe_groups`` 0 and
  4) on reduced qwen2-moe-a2.7b and moonshot-v1-16b-a3b, at
  ``capacity_factor`` 1.25 and 0.5 (tokens drop), a ragged S among
  them: expert choices, y and aux; two calls bit-identical.
* ``forward`` (logits and the summed aux), ``prefill`` and
  ``decode_step`` of both reduced MoE configs; the loss with its aux and
  its gradient against ``jax.value_and_grad`` under ``ftl_mode="off"``.
* The engine against the model's greedy loop at the bucket, and the
  reference's engine pinned to route a prompt at its bucket, pads
  included (so its capacity is the bucket's).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.launch import serve as JSV  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.train import steps as JST  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.train import steps as TST  # noqa: E402

MOE_ARCHS = ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"]
FP32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
# the smallest k-th / (k+1)-th router probability gap a case may hold
MIN_MARGIN = 1e-5


@pytest.fixture(autouse=True)
def same_target():
    jhw.set_default_target("cpu_cache")
    thw.set_default_target("cpu_cache")
    with jax.default_matmul_precision("highest"):
        yield
    jhw.set_default_target(None)
    thw.set_default_target(None)


def _cfgs(arch, **kw):
    kw.setdefault("remat", False)
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw),
            dataclasses.replace(tconfigs.get_config(arch).reduced(), **kw))


def _flat(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + k + "/")
        else:
            yield pre + k, v


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def weights():
    """The reference's ``init_params`` of each reduced MoE config (fp32),
    as numpy."""
    out = {}
    for i, arch in enumerate(MOE_ARCHS):
        jcfg, _ = _cfgs(arch)
        out[arch] = jax.tree.map(np.asarray,
                                 JM.init_params(jcfg, jax.random.PRNGKey(i)))
    return out


# ---------------------------------------------------------------------------
# trees and capacity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_moe_tree_matches_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jt = dict(_flat(jax.tree.map(np.asarray, JMOE.init_moe(
        jcfg, jax.random.PRNGKey(0)))))
    tt = dict(_flat(TMOE.init_moe(tcfg, torch.Generator().manual_seed(0),
                                  getattr(torch, dtype), "cpu")))
    assert set(tt) == set(jt)
    assert "shared/wg/w" in tt and "wg" in tt       # gated, shared experts
    for name, want in jt.items():
        assert tuple(tt[name].shape) == want.shape, name
        assert str(tt[name].dtype).split(".")[-1] == want.dtype.name, name
    assert tt["router/w"].dtype == torch.float32
    assert tt["shared/w1/w"].shape == (tcfg.d_model, tcfg.shared_d_ff)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_tree_matches_reference(weights, arch):
    _, tcfg = _cfgs(arch)
    tp = TM.init_params(tcfg, 0, device="cpu")
    want = {k: (v.shape, v.dtype.name) for k, v in _flat(weights[arch])}
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in _flat(tp)}
    assert got == want
    # the reference's draws carried leaf by leaf, the router in fp32
    conv = dict(_flat(params_from_numpy(weights[arch], "cpu")))
    assert conv["layers/pos0/moe/router/w"].dtype == torch.float32
    for k, v in _flat(weights[arch]):
        np.testing.assert_array_equal(conv[k].numpy(), v)


def test_init_scales_follow_the_reference():
    """Each expert slab drawn on its own keeps the reference's scales."""
    _, tcfg = _cfgs("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(tcfg, n_experts=16, moe_d_ff=256)
    p = TMOE.init_moe(cfg, torch.Generator().manual_seed(1), torch.float32,
                      "cpu", lead=(2,))
    d, f, n = cfg.d_model, cfg.moe_d_ff, cfg.n_layers
    for name, want in (("w1", d ** -0.5), ("wg", d ** -0.5),
                       ("w2", f ** -0.5 / (2 * n) ** 0.5)):
        assert abs(float(p[name].std()) - want) < 0.02 * want, name
    # every slab its own draw
    assert not torch.equal(p["w1"][0, 0], p["w1"][0, 1])
    assert not torch.equal(p["w1"][0], p["w1"][1])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_matches_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for n in (1, 3, 4, 7, 8, 9, 16, 60, 64, 100, 128, 256, 437, 512, 1000,
              1024, 2048, 4096):
        for cf in (0.5, 1.25, 2.0):
            j = dataclasses.replace(jcfg, capacity_factor=cf)
            t = dataclasses.replace(tcfg, capacity_factor=cf)
            assert TMOE.capacity(n, t) == JMOE.capacity(n, j), (n, cf)
    # the served path's: a 1024-token bucket and four decode slots
    if arch == "qwen2-moe-a2.7b":
        assert TMOE.capacity(1024, tcfg) == 88
        assert TMOE.capacity(4, tcfg) == 8


@pytest.mark.parametrize("groups", [0, 3, 4, 16])
def test_n_groups_matches_reference(groups):
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", moe_groups=groups)
    for n in (1, 6, 26, 64, 96, 1000):
        assert TMOE._n_groups(tcfg, n) == JMOE._n_groups(jcfg, n)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _layer_params(arch, dtype, seed=0):
    jcfg, _ = _cfgs(arch, dtype=dtype)
    jp = JMOE.init_moe(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _reference_choices(jcfg, jp, x, groups: int | None):
    """The reference's expert choices on x, by its own expressions
    (``moe_layer_scatter``: one group; ``moe_layer_grouped``: G), and the
    smallest k-th / (k+1)-th probability gap."""
    b, s, d = x.shape
    n = b * s
    g = 1 if groups is None else JMOE._n_groups(jcfg, n)
    xg = jnp.asarray(x).reshape(g, n // g, d).astype(jnp.float32)
    probs = jax.nn.softmax(xg @ jp["router"]["w"], axis=-1)
    _, idx = jax.lax.top_k(probs, jcfg.n_experts_per_token)
    top = jnp.sort(probs, axis=-1)[..., ::-1]
    k = jcfg.n_experts_per_token
    return np.asarray(idx), float((top[..., k - 1] - top[..., k]).min())


# (B, S) of each dispatch, the second ragged: groups of at least 32
# tokens, so that at capacity_factor 0.5 (8 slots an expert, the floor)
# some expert is over capacity; grouped dispatch puts 387 tokens in one
# group (387 is odd)
SHAPES = {"scatter": ((2, 16), (3, 13)),
          "grouped0": ((8, 64), (3, 129)),      # 16 groups of 32
          "grouped4": ((2, 64), (3, 129))}      # 4 groups of 32
LAYER_CASES = [(arch, disp, cf, shape)
               for arch in MOE_ARCHS
               for disp in SHAPES
               for cf in (1.25, 0.5)
               for shape in SHAPES[disp]]


@pytest.mark.parametrize("arch,dispatch,cf,shape", LAYER_CASES)
def test_moe_layer_matches_reference(arch, dispatch, cf, shape):
    groups = None if dispatch == "scatter" else int(dispatch[-1])
    kw = dict(capacity_factor=cf,
              moe_dispatch="scatter" if groups is None else "grouped",
              moe_groups=groups or 0)
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _layer_params(arch, "float32")
    x = np.random.default_rng(3).standard_normal(
        (*shape, jcfg.d_model)).astype(np.float32)
    want_idx, margin = _reference_choices(jcfg, jp, x, groups)
    assert margin >= MIN_MARGIN, margin
    xt = torch.from_numpy(x)
    g = 1 if groups is None else TMOE._n_groups(tcfg, x.shape[0] * x.shape[1])
    _, _, idx = TMOE.route(tcfg, tp, xt.reshape(g, -1, tcfg.d_model))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    jy, jaux = JMOE.moe_layer(jcfg, jp, jnp.asarray(x))
    ty, taux = TMOE.moe_layer(tcfg, tp, xt)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FP32)
    np.testing.assert_allclose(float(taux), float(jaux), **FP32)
    # at half capacity some expert is over capacity and slots drop
    n = x.shape[0] * x.shape[1]
    c = TMOE.capacity(n // g, tcfg)
    counts = np.stack([np.bincount(r.reshape(-1), minlength=tcfg.n_experts)
                       for r in want_idx])
    if cf == 0.5:
        assert (counts > c).any(), (counts, c)
    # two calls give the same bits
    ty2, taux2 = TMOE.moe_layer(tcfg, tp, xt)
    assert torch.equal(ty, ty2) and torch.equal(taux, taux2)


@pytest.mark.parametrize("dispatch", ["scatter", "grouped"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_bf16_matches_reference(arch, dispatch):
    """bf16 weights and activations (the router fp32): the same choices,
    y by the loose rule, aux in fp32."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16", moe_dispatch=dispatch,
                       capacity_factor=0.5)
    jp, tp = _layer_params(arch, "bfloat16", seed=2)
    x = np.random.default_rng(4).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    groups = None if dispatch == "scatter" else 0
    want_idx, margin = _reference_choices(
        jcfg, jp, np.asarray(jx.astype(jnp.float32)), groups)
    assert margin >= MIN_MARGIN, margin
    g = 1 if groups is None else TMOE._n_groups(tcfg, 48)
    _, _, idx = TMOE.route(tcfg, tp, xt.reshape(g, -1, tcfg.d_model))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    jy, jaux = JMOE.moe_layer(jcfg, jp, jx)
    ty, taux = TMOE.moe_layer(tcfg, tp, xt)
    assert ty.dtype == torch.bfloat16 and taux.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), np.asarray(jy.astype(jnp.float32)),
                               **BF16)
    np.testing.assert_allclose(float(taux), float(jaux), **FP32)


def test_equal_probabilities_rank_the_lower_expert_first():
    """A zero router gives every expert the same probability: ``lax.top_k``
    takes the lowest indices in order, and so does the port's stable
    sort (``torch.topk`` leaves the order of equal values open)."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b")
    x = np.random.default_rng(5).standard_normal(
        (1, 10, jcfg.d_model)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.zeros((jcfg.d_model,
                                                       jcfg.n_experts)))
    _, jidx = jax.lax.top_k(probs, jcfg.n_experts_per_token)
    p = {"router": {"w": torch.zeros(tcfg.d_model, tcfg.n_experts)}}
    _, gate, idx = TMOE.route(tcfg, p, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0, 0].tolist() == list(range(tcfg.n_experts_per_token))
    assert torch.allclose(gate, torch.full_like(gate, 0.5))


def test_slot_ranks_are_token_major():
    """A token's second choice ranks after its first and before the next
    token's first; the slot past capacity goes to the dropped row."""
    flat = torch.tensor([[0, 1, 1, 0, 0, 2]])     # tokens (0,1), (1,0), (0,2)
    dest_e, dest_c, keep, counts = TMOE._slots(flat, 3, 2)
    assert dest_c.tolist() == [[0, 0, 1, 1, 0, 0]]
    assert keep.tolist() == [[True, True, True, True, False, True]]
    assert dest_e.tolist() == [[0, 1, 1, 0, 3, 2]]
    assert counts.tolist() == [[3, 2, 1]]


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode, the loss and its gradient
# ---------------------------------------------------------------------------

def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(2, vocab, size=(b, s))


def _first_layer_margin(jcfg, jweights, toks):
    """The reference's smallest top-k gap in the first MoE layer's
    router on these tokens (the layers after it see the port's own
    inputs, held within the fp32 tolerance by the logits' agreement)."""
    jp = jax.tree.map(jnp.asarray, jweights)
    p0 = jax.tree.map(lambda a: a[0], jp["layers"]["pos0"])
    x = JM._embed(jcfg, jp["embed"], jnp.asarray(toks))
    from repro.models.layers import norm as jnorm
    x = x + JM._apply_mixer(jcfg, p0, "attn", x,
                            positions=jnp.arange(toks.shape[1]), ctx=None)
    h = jnorm(p0["ln2"], x, jcfg.norm)
    return _reference_choices(jcfg, p0["moe"], np.asarray(h), None)[1]


@pytest.mark.parametrize("dispatch", ["scatter", "grouped"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_reference(weights, arch, dispatch):
    jcfg, tcfg = _cfgs(arch, moe_dispatch=dispatch, capacity_factor=0.5)
    toks = _tokens(2, 16, jcfg.vocab_size)
    assert _first_layer_margin(jcfg, weights[arch], toks) >= MIN_MARGIN
    jl, jaux = JM.forward(jcfg, jax.tree.map(jnp.asarray, weights[arch]),
                          {"tokens": jnp.asarray(toks)})
    tl, taux = TM.forward(tcfg, params_from_numpy(weights[arch], "cpu"),
                          {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
    assert taux.dtype == torch.float32 and float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), **FP32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_reference(weights, arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jax.tree.map(jnp.asarray, weights[arch])
    tp = params_from_numpy(weights[arch], "cpu")
    toks = _tokens(2, 16, jcfg.vocab_size, seed=1)
    # bucket-padded prompt: the real last token at index 10
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_seq=32,
                        last_pos=jnp.int32(10))
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                        max_seq=32, last_pos=10)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["layers"]["pos0"][name].numpy(),
                                   np.asarray(jc["layers"]["pos0"][name]),
                                   **FP32)
    pos = np.array([11, 16])
    nxt = np.array([[5], [7]])
    for _ in range(3):
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(nxt), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(nxt), tc,
                                torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
        nxt = np.array(jnp.argmax(jl[:, 0], -1))[:, None]
        pos = pos + 1


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_gradients_match_reference(weights, arch):
    """Under ``ftl_mode="off"``: the loss with ``router_aux_weight`` times
    the summed aux, ``moe_aux`` reported, every leaf's gradient within
    2e-5 of that leaf's largest (the router's through the gates and the
    aux included)."""
    jcfg, tcfg = _cfgs(arch, ftl_mode="off", capacity_factor=0.5)
    toks = _tokens(2, 24, jcfg.vocab_size, seed=2).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, weights[arch])
    (jl, jaux), jg = jax.value_and_grad(JST.make_loss_fn(jcfg), has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)})
    tp = params_from_numpy(weights[arch], "cpu")
    leaves = TM.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl, taux = TST.make_loss_fn(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    gs = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **FP32)
    assert set(taux) == set(jaux) and "moe_aux" in taux
    np.testing.assert_allclose(float(taux["moe_aux"].detach()),
                               float(jaux["moe_aux"]),
                               **FP32)
    names = [n for n, _ in _flat(tp)]
    jflat = dict(_flat(jax.tree.map(np.asarray, jg)))
    assert set(names) == set(jflat)
    for name, p, g in zip(names, leaves, gs):
        want = jflat[name]
        got = np.zeros(want.shape, np.float32) if g is None else g.numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 2e-5 * scale, name
    assert float(np.abs(jflat["layers/pos0/moe/router/w"]).max()) > 0


def test_train_step_reports_moe_aux():
    _, tcfg = _cfgs("qwen2-moe-a2.7b")
    state = TST.init_train_state(tcfg, 0, device="cpu")
    step = TST.make_train_step(tcfg)
    toks = torch.from_numpy(_tokens(2, 16, tcfg.vocab_size, seed=3))
    state, m = step(state, {"tokens": toks})
    assert np.isfinite(float(m["loss"])) and float(m["moe_aux"]) > 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_serving_mode_fuses_the_shared_experts():
    for arch in MOE_ARCHS:
        cfg = tconfigs.get_config(arch)
        assert cfg.d_ff == 0 and cfg.shared_d_ff and cfg.mlp_gated
        assert TSV.serving_ftl_mode(cfg) == "fused"
    no_shared = dataclasses.replace(tconfigs.get_config(MOE_ARCHS[0]),
                                    n_shared_experts=0, shared_d_ff=0)
    assert TSV.serving_ftl_mode(no_shared) == "off"


def _model_greedy_at_bucket(jcfg, jp, prompt, n, bucket, max_seq):
    """The JAX model's greedy loop on the prompt padded to its bucket
    (the real last token at ``last_pos``), as an engine prefills it."""
    padded = np.zeros(bucket, np.int32)
    padded[:len(prompt)] = prompt
    logits, cache = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(padded)[None]},
                               max_seq=max_seq,
                               last_pos=jnp.int32(len(prompt) - 1))
    out = [int(jnp.argmax(logits[0, -1]))]
    pos = len(prompt)
    while len(out) < n:
        logits, cache = JM.decode_step(jcfg, jp, jnp.asarray([[out[-1]]]),
                                       cache, jnp.int32(pos))
        out.append(int(jnp.argmax(logits[0, -1])))
        pos += 1
    return out


@pytest.mark.parametrize("slots", [1, 2])
def test_engine_matches_model_loop_at_the_bucket(weights, slots):
    """The port's engine (paged KV, shared experts under ``'fused'``)
    gives the reference model's greedy tokens for each prompt padded to
    its bucket, and the reference engine's tokens."""
    arch = "qwen2-moe-a2.7b"
    jcfg, tcfg = _cfgs(arch, capacity_factor=0.5)
    tcfg = dataclasses.replace(tcfg, ftl_mode=TSV.serving_ftl_mode(tcfg))
    jp = jax.tree.map(jnp.asarray, weights[arch])
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 13, 20)]
    eng = TSV.ServeEngine(tcfg, params_from_numpy(weights[arch], "cpu"),
                          batch_slots=slots, max_seq=32, eos_id=-1,
                          target=thw.CPU_CACHE, device="cpu")
    assert eng.paged
    got = {r.rid: r.out for r in eng.run(
        [TSV.Request(i, p, 5) for i, p in enumerate(prompts)])}
    want = {i: _model_greedy_at_bucket(jcfg, jp, p, 5,
                                       TM.bucket_m(len(p), eng.buckets), 32)
            for i, p in enumerate(prompts)}
    assert got == want
    jeng = JSV.ServeEngine(jcfg, jp, batch_slots=slots, max_seq=32,
                           eos_id=-1, target=jhw.CPU_CACHE)
    jout = {r.rid: r.out for r in jeng.run(
        [JSV.Request(i, p, 5) for i, p in enumerate(prompts)], {})}
    assert got == jout


def test_reference_engine_routes_the_padded_bucket(weights):
    """Pinned: the reference engine prefills a prompt at its bucket, pads
    included, so the prompt's tokens are routed with the bucket's
    capacity (16 slots an expert at 32 tokens against 8 at 20) and its
    first token is the padded prefill's.  Fewer tokens can drop than in
    an unpadded prefill of the same prompt; the port does the same and
    is held to this, not to the unpadded prefill."""
    arch = "qwen2-moe-a2.7b"
    jcfg, _ = _cfgs(arch)
    jp = jax.tree.map(jnp.asarray, weights[arch])
    prompt = np.random.default_rng(7).integers(
        2, jcfg.vocab_size, size=20).astype(np.int32)
    assert JMOE.capacity(20, jcfg) == 8 < JMOE.capacity(32, jcfg) == 16
    jeng = JSV.ServeEngine(jcfg, jp, batch_slots=1, max_seq=32, eos_id=-1,
                           target=jhw.CPU_CACHE)
    got = jeng.run([JSV.Request(0, prompt, 3)], {})[0].out
    assert got == _model_greedy_at_bucket(jcfg, jp, prompt, 3, 32, 32)
    # the unpadded prefill routes 20 tokens at capacity 8 and drops slots
    # the bucket keeps: its last-token logits differ
    padded = np.zeros(32, np.int32)
    padded[:20] = prompt
    at_bucket, _ = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(padded)[None]},
                              last_pos=jnp.int32(19))
    unpadded, _ = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt)[None]})
    assert float(jnp.abs(at_bucket - unpadded).max()) > 1e-3


def test_moe_cli_runs_on_cpu(capsys):
    TSV.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu",
              "--requests", "3", "--slots", "2", "--prompt-len", "8",
              "--max-new", "3", "--max-seq", "32", "--target", "cpu_cache"])
    out = capsys.readouterr().out
    assert "paged KV" in out and "'mlp': 'cuda_fused_mlp'" in out
    assert "served 3 requests" in out and "0 decode replans" in out
