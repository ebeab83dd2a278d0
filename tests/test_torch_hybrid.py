"""The port's hybrid family (recurrentgemma-9b, reduced) against the JAX
package's, on the same weights.

``recurrentgemma-9b.reduced()`` (rec, rec, local; window 32): the JAX
``init_params`` tree goes through ``params_from_numpy``.  fp32 logits of
``forward``, ``prefill`` and ``decode_step`` across the local ring's
wrap agree within rtol = atol = 1e-4 (the tolerance of
``tests/test_torch_model.py``); decode after the wrap also matches the
port's own teacher-forced forward at the reference smoke test's 1e-2.
Both sides plan on the same explicit default target.
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
ARCH = "recurrentgemma-9b"


def _cfgs(mode="off", **kw):
    return (dataclasses.replace(jconfigs.get_config(ARCH).reduced(),
                                remat=False, ftl_mode=mode, **kw),
            dataclasses.replace(tconfigs.get_config(ARCH).reduced(),
                                remat=False, ftl_mode=mode, **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(autouse=True)
def same_target():
    jhw.set_default_target("cpu_cache")
    thw.set_default_target("cpu_cache")
    yield
    jhw.set_default_target(None)
    thw.set_default_target(None)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_keys_shapes_dtypes_match_reference(dtype):
    """Same keys, shapes and dtypes as the reference tree, the fp32 ``lam``
    beside bf16 leaves included, and the converter keeps each leaf's
    dtype."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jtree = jax.tree.map(np.asarray,
                         JM.init_params(jcfg, jax.random.PRNGKey(0)))
    want = _spec(jtree)
    assert _spec(TM.init_params(tcfg, 0, device="cpu")) == want
    assert _spec(params_from_numpy(jtree, "cpu")) == want
    assert want["layers.pos0.mix.lam"][1] == "float32"
    assert "rem" not in want          # reduced: 3 layers, one whole period


def test_remainder_layers_follow_the_reference():
    """38 = 12×3 + 2: the layers past the last whole period live under
    ``rem`` (here 5 = 1×3 + 2)."""
    jcfg, tcfg = _cfgs(n_layers=5)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    npp = jax.tree.map(np.asarray, jp)
    assert _spec(TM.init_params(tcfg, 0, device="cpu")) == _spec(npp)
    assert set(npp["rem"]) == {"rem0", "rem1"}
    toks = _tokens(1, 12, jcfg.vocab_size, seed=4)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_seq=16)
    tp = params_from_numpy(npp, "cpu")
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                        max_seq=16)
    _close(tl, jl)
    _close(tc["rem"]["rem1"]["h"], jc["rem"]["rem1"]["h"])
    jl, _ = JM.decode_step(jcfg, jp, jnp.asarray([[9]]), jc, jnp.int32(12))
    tl, _ = TM.decode_step(tcfg, tp, torch.tensor([[9]]), tc,
                           torch.tensor(12))
    _close(tl, jl)


@pytest.mark.parametrize("mode", ["off", "auto", "fused"])
def test_forward_matches_reference(weights, mode):
    jp, tp = weights
    jcfg, tcfg = _cfgs(mode)
    toks = _tokens(2, 40, jcfg.vocab_size)
    jl, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, _ = TM.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)


def test_recurrent_layers_never_run_the_block_plan(weights, monkeypatch):
    """Under a plan only the local layer goes through ``block_layer``
    (``run_block``); the recurrent layers keep their own mixer."""
    _, tp = weights
    _, tcfg = _cfgs("fused")
    seen = []
    real = TM.block_layer

    def spy(cfg, p, x, **kw):
        seen.append("mix" in p)
        return real(cfg, p, x, **kw)

    monkeypatch.setattr(TM, "block_layer", spy)
    TM.forward(tcfg, tp, {"tokens": torch.from_numpy(
        _tokens(1, 8, tcfg.vocab_size))})
    assert seen == [False]


def test_prefill_and_decode_across_ring_wrap(weights):
    """The reference smoke test's ring-buffer case: prefill past the
    window, then decode steps that wrap the ring, logits against the
    reference's at 1e-4 and against the port's own forward."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    w = jcfg.local_window
    total = w + 8
    toks = _tokens(1, total, jcfg.vocab_size, seed=7)
    tfull, _ = TM.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    s = w + 2
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :s])},
                        max_seq=total)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :s])},
                        max_seq=total)
    _close(tl, jl)
    _close(tc["layers"]["pos2"]["k"], jc["layers"]["pos2"]["k"])
    _close(tc["layers"]["pos0"]["conv"], jc["layers"]["pos0"]["conv"])
    for i in range(3):
        tok = toks[:, s + i:s + i + 1]
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(tok), jc,
                                jnp.int32(s + i))
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(tok), tc,
                                torch.tensor(s + i))
        _close(tl, jl)
        _close(tl[:, 0], tfull[:, s + i].numpy(), rtol=1e-2, atol=1e-2)
        _close(tc["layers"]["pos1"]["h"], jc["layers"]["pos1"]["h"])
        _close(tc["layers"]["pos2"]["v"], jc["layers"]["pos2"]["v"])


def test_vector_pos_decode_matches_reference(weights):
    """Two rows at their own positions, one of them past the window."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    w = jcfg.local_window
    toks = _tokens(2, w + 4, jcfg.vocab_size, seed=9)
    _, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_seq=64)
    _, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                       max_seq=64)
    pos = np.array([w + 4, 10])
    nxt = np.array([[5], [7]])
    for _ in range(2):
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(nxt), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(nxt), tc,
                                torch.from_numpy(pos))
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl[:, 0], -1))[:, None]
        pos = pos + 1


def test_bf16_decode_dtype_discipline():
    """The reference smoke test's bf16 case: finite logits, and every
    cache leaf keeps its dtype through a decode step (recurrent state in
    fp32, KV in bf16)."""
    _, tcfg = _cfgs(dtype="bfloat16")
    tp = TM.init_params(tcfg, 0, device="cpu")
    b, s = 2, 16
    toks = torch.from_numpy(_tokens(b, s, tcfg.vocab_size, seed=3))
    _, cache = TM.prefill(tcfg, tp, {"tokens": toks}, max_seq=s + 2)
    before = {k: v.dtype for k, v in _flatten(cache)}
    logits, cache2 = TM.decode_step(tcfg, tp, torch.ones((b, 1),
                                                         dtype=torch.long),
                                    cache, torch.tensor(s))
    assert bool(torch.isfinite(logits.float()).all())
    assert {k: v.dtype for k, v in _flatten(cache2)} == before
    assert before["layers.pos0.h"] == torch.float32
    assert before["layers.pos0.conv"] == torch.float32
    assert before["layers.pos2.k"] == torch.bfloat16
    empty = TM.init_cache(tcfg, b, s + 2, device="cpu")
    assert {k: v.dtype for k, v in _flatten(empty)} == before


def test_prefill_state_at_last_pos_equals_unpadded_prefill(weights):
    """A right-padded prompt prefilled with ``last_pos`` leaves the decode
    state of the unpadded prompt: recurrent h and conv, and the local
    ring, also when the padded length passes the window and the prompt
    does not, and when both do."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    w = jcfg.local_window
    for n, bucket in ((5, 8), (20, 64), (40, 64)):
        toks = _tokens(1, bucket, jcfg.vocab_size, seed=n)
        _, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :n])},
                           max_seq=64)
        tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                            max_seq=64, last_pos=n - 1)
        for name in ("h", "conv"):
            _close(tc["layers"]["pos0"][name], jc["layers"]["pos0"][name])
        ring_k = tc["layers"]["pos2"]["k"]
        assert ring_k.shape[2] == w
        _close(ring_k, jc["layers"]["pos2"]["k"])


def test_full_width_plan_binds_the_four_kernels():
    """recurrentgemma-9b at its published width on the ``h100`` target:
    the (MLP-only) prefill plan resolves to the three kernels ``run_block``
    can bind, flash attention at head_dim 256 included, and the fused
    MLP has a feasible F slice at every bucket and at decode."""
    from repro_torch.core.ftl import executor_block, registry
    from repro_torch.kernels import flash_attention, fused_mlp

    cfg = dataclasses.replace(tconfigs.get_config(ARCH), ftl_mode="fused")
    plan = registry.plan_block(cfg, m=4096, target=thw.H100, device="cuda")
    assert executor_block.resolved_executors(plan) == {
        "gemm": "cuda_gemm", "attention": "cuda_flash_attention",
        "mlp": "cuda_fused_mlp"}
    # the largest footprint at head_dim 256: a 64-row Q tile and a
    # three-stage ring of 64-key K and V tiles, with its mbarriers and
    # the 1 KB that aligns it to the swizzle
    assert flash_attention.smem_bytes(256) == \
        1024 + 64 * 256 * 2 + 3 * 2 * 64 * 256 * 2 + 256
    assert flash_attention.smem_bytes(256) <= thw.H100.fast.capacity_bytes
    for m in (4, *TM.PREFILL_BUCKETS):
        s = fused_mlp.schedule(m, 4096, 12288, 4096, True)
        assert s.block_f in fused_mlp.block_f_choices(12288, s.block_m, True)
        assert s.smem_bytes <= thw.H100.fast.capacity_bytes
        if m == 4096:             # the fp32 partial buffer, 4·M·N·F/BF B
            assert (s.block_f, s.partial_bytes) == (512, 1_610_612_736)
