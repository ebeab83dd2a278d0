"""The port's RG-LRU pieces against the JAX package's, on the CPU.

Same numpy-seeded inputs, fp32: the plain scan against the reference's
plain scan and its Pallas kernel in interpret mode, with and without
``h0``; ``_causal_conv`` with and without ``prev``; ``rec_block`` with
``return_state`` and ``rec_block_decode`` on converted weights.
Tolerance: rtol = atol = 1e-4, as in ``tests/test_torch_model.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rg_lru import rg_lru_scan as jkernel  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref as tref  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _scan_inputs(b, t, w, seed=0):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, t, w))).astype(np.float32)
    a = (0.79 + 0.2 / (1 + np.exp(-rng.standard_normal((b, t, w))))
         ).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return x, a, h0


@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_scan_matches_reference_plain_and_pallas(with_h0):
    x, a, h0 = _scan_inputs(2, 128, 128)
    h0 = h0 if with_h0 else None
    th, th_t = tref.rg_lru_scan(torch.from_numpy(x), torch.from_numpy(a),
                                None if h0 is None else torch.from_numpy(h0))
    jh, jh_t = jref.rg_lru_scan(jnp.asarray(x), jnp.asarray(a),
                                None if h0 is None else jnp.asarray(h0))
    _close(th, jh)
    _close(th_t, jh_t)
    kh, kh_t = jkernel(jnp.asarray(x), jnp.asarray(a),
                       None if h0 is None else jnp.asarray(h0),
                       block_t=64, block_d=128, interpret=True)
    _close(th, kh)
    _close(th_t, kh_t)
    assert th.dtype == torch.float32 and th_t.dtype == torch.float32


def test_rg_lru_dtypes_and_cpu_dispatch():
    """h in x's dtype, h_T in fp32; ``ops.rg_lru`` on CPU tensors is the
    plain scan, at any T and W."""
    x, a, _ = _scan_inputs(1, 37, 13, seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ab = torch.from_numpy(a).to(torch.bfloat16)
    h, h_t = ops.rg_lru(xb, ab)
    assert h.dtype == torch.bfloat16 and h_t.dtype == torch.float32
    hr, hr_t = tref.rg_lru_scan(xb, ab)
    assert torch.equal(h, hr) and torch.equal(h_t, hr_t)
    jh, jh_t = jref.rg_lru_scan(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(a, jnp.bfloat16))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(jh_t), **TOL)


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_matches_reference(with_prev):
    rng = np.random.default_rng(2)
    xt = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    prev = rng.standard_normal((2, 3, 16)).astype(np.float32) \
        if with_prev else None
    t = TR._causal_conv(torch.from_numpy(xt), torch.from_numpy(w),
                        torch.from_numpy(b),
                        None if prev is None else torch.from_numpy(prev))
    j = JR._causal_conv(jnp.asarray(xt), jnp.asarray(w), jnp.asarray(b),
                        None if prev is None else jnp.asarray(prev))
    _close(t, j)


@pytest.fixture(scope="module")
def block():
    jcfg = dataclasses.replace(
        jconfigs.get_config("recurrentgemma-9b").reduced(), remat=False)
    tcfg = dataclasses.replace(
        tconfigs.get_config("recurrentgemma-9b").reduced(), remat=False)
    jp = JR.init_rec_block(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def test_rec_block_prefill_state_and_decode_match_reference(block):
    jcfg, jp, tcfg, tp = block
    x = np.random.default_rng(3).standard_normal(
        (2, 12, jcfg.d_model)).astype(np.float32)
    jy, jst = JR.rec_block(jcfg, jp, jnp.asarray(x), return_state=True)
    ty, tst = TR.rec_block(tcfg, tp, torch.from_numpy(x), return_state=True)
    _close(ty, jy)
    _close(tst["h"], jst["h"])
    _close(tst["conv"], jst["conv"])
    assert tst["h"].dtype == tst["conv"].dtype == torch.float32
    _close(TR.rec_block(tcfg, tp, torch.from_numpy(x)), jy)
    for i in range(3):
        x1 = np.random.default_rng(10 + i).standard_normal(
            (2, 1, jcfg.d_model)).astype(np.float32)
        jy1, jst = JR.rec_block_decode(jcfg, jp, jnp.asarray(x1), jst)
        ty1, tst2 = TR.rec_block_decode(tcfg, tp, torch.from_numpy(x1), tst)
        assert tst2 is tst              # updated in place
        _close(ty1, jy1)
        _close(tst["h"], jst["h"])
        _close(tst["conv"], jst["conv"])


def test_rec_block_state_at_length_equals_unpadded(block):
    """The state of a right-padded sequence taken at ``length`` equals the
    reference's state of the unpadded sequence."""
    jcfg, jp, tcfg, tp = block
    x = np.random.default_rng(4).standard_normal(
        (1, 16, jcfg.d_model)).astype(np.float32)
    for n in (2, 7, 16):
        _, jst = JR.rec_block(jcfg, jp, jnp.asarray(x[:, :n]),
                              return_state=True)
        ty, tst = TR.rec_block(tcfg, tp, torch.from_numpy(x),
                               return_state=True, length=n)
        _close(tst["h"], jst["h"])
        k = jcfg.conv_width - 1
        want = np.asarray(jst["conv"])
        if want.shape[1] < k:          # the reference keeps only n rows
            want = np.pad(want, ((0, 0), (k - want.shape[1], 0), (0, 0)))
        np.testing.assert_allclose(tst["conv"].numpy(), want, **TOL)
        jy = JR.rec_block(jcfg, jp, jnp.asarray(x[:, :n]))
        _close(ty[:, :n], jy)
