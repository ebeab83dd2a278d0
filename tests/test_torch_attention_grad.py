"""The attention Function's CPU path against ``jax.vjp`` of the JAX
package's plain attention, in fp32 within 1e-5.

On CPU tensors ``ops.attention`` runs the same ``torch.autograd.Function``
that launches the flash kernels on the card, with its plain passes:
``ref.attention_lse`` forward and ``ref.attention_bwd`` backward.  Cases:
GQA 4/2 and MQA 4/1; causal, a window of 8 and not causal; ``q_offset``
0 and 5; a fully masked row gives zero gradients.  Also: the kernels
that have no backward refuse a gradient on a non-CPU tensor.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import (  # noqa: E402
    flash_attention, fused_mlp, gemm, gemm_act, mlstm, ops, ref, rg_lru)

TOL = dict(rtol=1e-5, atol=1e-5)
MASKS = {"causal": dict(causal=True, window=None),
         "window8": dict(causal=True, window=8),
         "not_causal": dict(causal=False, window=None)}


def _inputs(hq, hk, tq, tk, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, hq, tq, dh)).astype(np.float32)
    k = rng.standard_normal((2, hk, tk, dh)).astype(np.float32)
    v = rng.standard_normal((2, hk, tk, dh)).astype(np.float32)
    do = rng.standard_normal((2, hq, tq, dh)).astype(np.float32)
    return q, k, v, do


def _jax_vjp(q, k, v, do, **kw):
    o, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(o), *(np.asarray(g) for g in vjp(jnp.asarray(do))))


def _torch_grad(q, k, v, do, **kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = ops.attention(*ts, **kw)
    grads = torch.autograd.grad(o, ts, torch.from_numpy(do))
    return (o.detach().numpy(), *(g.numpy() for g in grads))


@pytest.mark.parametrize("q_offset", [0, 5])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("heads", [(4, 2), (4, 1)], ids=["gqa", "mqa"])
def test_function_matches_jax_vjp(heads, mask, q_offset):
    kw = dict(MASKS[mask], q_offset=q_offset)
    q, k, v, do = _inputs(*heads, 20, 20 + q_offset)
    want = _jax_vjp(q, k, v, do, **kw)
    got = _torch_grad(q, k, v, do, **kw)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=name)


def test_fully_masked_rows_give_zero_gradients():
    # window 2 at q_offset 5 over 10 keys: query rows 7, 8, 9 (positions
    # 12-14) see no key
    kw = dict(causal=True, window=2, q_offset=5)
    q, k, v, do = _inputs(4, 2, 10, 10, seed=3)
    o, dq, dk, dv = _torch_grad(q, k, v, do, **kw)
    want = _jax_vjp(q, k, v, do, **kw)
    for g, w in zip((o, dq, dk, dv), want):
        np.testing.assert_allclose(g, w, **TOL)
    assert np.all(o[:, :, 7:] == 0) and np.all(dq[:, :, 7:] == 0)
    assert np.isfinite(dk).all() and np.isfinite(dv).all()


def test_lse_matches_logsumexp_and_is_inf_on_empty_rows():
    q, k, v, _ = _inputs(4, 2, 10, 10, seed=4)
    kw = dict(causal=True, window=2, q_offset=5)
    o, lse = ref.attention_lse(*(torch.from_numpy(a) for a in (q, k, v)),
                               **kw)
    assert lse.shape == (2, 4, 10) and lse.dtype == torch.float32
    assert torch.equal(o, ref.attention(*(torch.from_numpy(a)
                                          for a in (q, k, v)), **kw))
    s = np.einsum("bhgqd,bhkd->bhgqk", q.reshape(2, 2, 2, 10, 16), k) \
        * 16 ** -0.5
    qpos, kpos = np.arange(10)[:, None] + 5, np.arange(10)[None, :]
    vis = (kpos <= qpos) & (kpos > qpos - 2)
    s = np.where(vis, s, -np.inf)
    with np.errstate(divide="ignore"):
        want = np.log(np.exp(s - s.max(-1, keepdims=True,
                                       initial=-1e30)).sum(-1)) \
            + np.maximum(s.max(-1), -1e30)
    want = np.where(vis.any(-1), want, np.inf).reshape(2, 4, 10)
    np.testing.assert_allclose(lse.numpy(), want, **TOL)
    assert np.isinf(lse.numpy()[:, :, 7:]).all()


def test_plain_backend_runs_the_same_function():
    q, k, v, do = _inputs(4, 2, 12, 12, seed=5)
    a = _torch_grad(q, k, v, do, causal=True)
    b = _torch_grad(q, k, v, do, causal=True, backend="ref")
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    with pytest.raises(ValueError):
        _torch_grad(q, k, v, do, backend="pallas")


def test_no_input_needing_a_gradient_keeps_no_graph():
    q, k, v, _ = _inputs(4, 2, 8, 8)
    o = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert o.grad_fn is None


# ---------------------------------------------------------------------------
# the kernels without a backward: a non-CPU tensor needing a gradient
# raises instead of returning an output with no grad_fn.  ``meta`` tensors
# are not CPU tensors, so they take the kernel's side of each wrapper
# without a card.
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16, grad=True):
    return torch.empty(shape, device="meta", dtype=dtype).requires_grad_(
        grad)


CALLS = {
    "gemm": lambda g: gemm.gemm(_meta(64, 64, grad=g), _meta(64, 64)),
    "gemm_act": lambda g: gemm_act.gemm_act(_meta(64, 64, grad=g),
                                            _meta(64, 64, grad=g)),
    "fused_mlp": lambda g: fused_mlp.fused_mlp(
        _meta(64, 64, grad=g), _meta(64, 128), _meta(128, 64)),
    "rg_lru_scan": lambda g: rg_lru.rg_lru_scan(
        _meta(1, 8, 64, grad=g), _meta(1, 8, 64, grad=g)),
    "mlstm_scan": lambda g: mlstm.mlstm_scan(
        _meta(1, 2, 8, 64, grad=g), _meta(1, 2, 8, 64), _meta(1, 2, 8, 64),
        _meta(1, 2, 8, dtype=torch.float32),
        _meta(1, 2, 8, dtype=torch.float32)),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_kernels_without_backward_refuse_a_gradient(name):
    with pytest.raises(NotImplementedError,
                       match=f"^{name}: no backward kernel yet; train with "
                             f"ftl_mode='off'$"):
        CALLS[name](True)


@pytest.mark.parametrize("name", list(CALLS))
def test_kernels_without_backward_serve_under_no_grad(name):
    """Under ``no_grad`` the guard stays out of the way: the wrapper goes
    on to its device checks (which a meta tensor fails)."""
    with torch.no_grad(), pytest.raises(ValueError):
        CALLS[name](True)
    if name == "gemm":          # and a gemm whose weight needs no gradient
        with pytest.raises(NotImplementedError):
            gemm.gemm(_meta(64, 64, grad=False), _meta(64, 64, grad=True))


def test_flash_backward_refuses_head_dim_256():
    q = _meta(1, 2, 8, 256)
    with pytest.raises(NotImplementedError,
                       match="flash_attention backward: head_dim 256"):
        flash_attention.flash_attention(q, _meta(1, 1, 8, 256),
                                        _meta(1, 1, 8, 256))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, _meta(1, 1, 8, 256),
                                        _meta(1, 1, 8, 256))


def test_flash_backward_wrapper_checks_its_operands():
    t = _meta(1, 2, 8, 128, grad=False)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_bwd(
            t, t, t, t, torch.empty(1, 2, 8), t)
