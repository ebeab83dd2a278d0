"""The port's blockwise plain attention (``ref.attention_blockwise``) and
its routing in ``ops.attention`` against the reference.

The same inputs, made with numpy, go through ``repro.kernels.ref.
attention_blockwise`` (a ``lax.scan``) and the port's loop of plain ops:
the cases of ``tests/test_perf_variants.py`` (fp32 within 2e-5, bf16
within 3e-2, ``q_offset``), and the gradient against ``jax.grad`` of the
reference within 1e-4.  ``ops.set_plain_attention`` (the reference's
``set_xla_attention``) sends the plain path to the blockwise schedule
from ``min_len`` keys up, and never a tensor off the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402

from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def rnd(seed, shape, dtype="float32"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def qkv(shape_q, shape_kv, dtype="float32"):
    return rnd(0, shape_q, dtype), rnd(1, shape_kv, dtype), \
        rnd(2, shape_kv, dtype)


def t(a):
    return tensor_from_numpy(a, "cpu")


@pytest.fixture
def plain_mode():
    """Restore the plain path's attention schedule after the test."""
    saved = dict(ops._PLAIN_ATTN)
    yield
    ops._PLAIN_ATTN.update(saved)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockwise_matches_reference(causal, window, dtype):
    q, k, v = qkv((2, 8, 256, 64), (2, 2, 256, 64), dtype)
    want = jref.attention_blockwise(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window, block_k=64)
    got = ref.attention_blockwise(t(q), t(k), t(v), causal=causal,
                                  window=window, block_k=64)
    naive = ref.attention(t(q), t(k), t(v), causal=causal, window=window)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    assert got.dtype == naive.dtype and got.shape == naive.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got.float().numpy(), naive.float().numpy(),
                               rtol=tol, atol=tol)


def test_blockwise_q_offset():
    q, k, v = qkv((1, 2, 64, 32), (1, 2, 256, 32))
    want = jref.attention_blockwise(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    q_offset=192, block_k=64)
    got = ref.attention_blockwise(t(q), t(k), t(v), causal=True,
                                  q_offset=192, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_blockwise_falls_back_to_one_block():
    """A block that does not divide Tk runs one block, as the
    reference's."""
    q, k, v = qkv((1, 4, 100, 32), (1, 2, 100, 32))
    want = jref.attention_blockwise(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), block_k=64)
    got = ref.attention_blockwise(t(q), t(k), t(v), block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 48)])
def test_blockwise_gradient_matches_jax_grad(causal, window):
    q, k, v = qkv((1, 4, 128, 32), (1, 2, 128, 32))
    kw = dict(causal=causal, window=window, block_k=32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    gq, gk, gv = jax.grad(
        lambda a, b, c: jref.attention_blockwise(a, b, c, **kw).sum(),
        argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    ref.attention_blockwise(tq, tk, tv, **kw).sum().backward()
    for got, want in ((tq.grad, gq), (tk.grad, gk), (tv.grad, gv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def _spy(monkeypatch) -> list:
    calls = []
    real = ref.attention_blockwise

    def spy(*a, **k):
        calls.append(k["block_k"])
        return real(*a, **k)

    monkeypatch.setattr(ops._ref, "attention_blockwise", spy)
    return calls


@pytest.mark.parametrize("tk,blockwise", [(32, False), (63, False),
                                          (64, True), (128, True)])
def test_ops_routes_to_blockwise_from_min_len(monkeypatch, plain_mode, tk,
                                              blockwise):
    calls = _spy(monkeypatch)
    ops.set_plain_attention("blockwise", min_len=64)
    q, k, v = qkv((1, 4, 16, 32), (1, 2, tk, 32))
    out = ops.attention(t(q), t(k), t(v), causal=False)
    assert calls == ([1024] if blockwise else [])
    naive = ref.attention(t(q), t(k), t(v), causal=False)
    np.testing.assert_allclose(out.numpy(), naive.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_ops_naive_mode_never_blockwise(monkeypatch, plain_mode):
    calls = _spy(monkeypatch)
    ops.set_plain_attention("naive", min_len=1)
    q, k, v = qkv((1, 4, 16, 32), (1, 2, 128, 32))
    ops.attention(t(q), t(k), t(v))
    ops.attention(t(q), t(k), t(v), backend="ref")
    assert calls == []


def test_ops_blockwise_block_is_the_flash_key_tile_or_1024(monkeypatch,
                                                            plain_mode):
    """block_k = max(flash's key tile at the head dim, 1024): 1024 at every
    head dim the kernel builds (tiles of 128 and 64 keys)."""
    calls = _spy(monkeypatch)
    ops.set_plain_attention("blockwise", min_len=8)
    for dh in (64, 128, 256):
        q, k, v = qkv((1, 2, 4, dh), (1, 2, 2048, dh))
        ops.attention(t(q), t(k), t(v), backend="ref")
        assert calls[-1] == max(tflash.block_kv(dh), 1024) == 1024


def test_ops_blockwise_is_differentiable(plain_mode):
    ops.set_plain_attention("blockwise", min_len=8)
    q, k, v = qkv((1, 4, 64, 32), (1, 2, 2048, 32))
    tq = t(q).requires_grad_(True)
    ops.attention(tq, t(k), t(v)).sum().backward()
    want = jax.grad(lambda a: jref.attention_blockwise(
        a, jnp.asarray(k), jnp.asarray(v), block_k=1024).sum())(
            jnp.asarray(q))
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_ops_blockwise_leaves_a_device_tensor_to_the_kernel(plain_mode):
    """Off the CPU the mode does not apply: a ``meta`` tensor goes to the
    flash kernel's path, which raises for a tensor that is not on a card,
    as a CUDA tensor would launch it."""
    ops.set_plain_attention("blockwise", min_len=8)
    q = torch.empty((1, 4, 16, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 2, 2048, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        ops.attention(q, k, k)


def test_set_plain_attention_rejects_unknown_mode(plain_mode):
    with pytest.raises(ValueError):
        ops.set_plain_attention("tiled")
    assert ops._PLAIN_ATTN["mode"] in ("naive", "blockwise")
