"""The attention Function's CPU path against ``jax.vjp`` of the JAX
package's plain attention, in fp32 within 1e-5.

On CPU tensors ``ops.attention`` runs the same ``torch.autograd.Function``
that launches the flash kernels on the card, with its plain passes:
``ref.attention_lse`` forward and ``ref.attention_bwd`` backward.  Cases:
GQA 4/2 and MQA 4/1; causal, a window of 8 and not causal; ``q_offset``
0 and 5; a fully masked row gives zero gradients; head dim 256 with MQA
16/1 and a window, recurrentgemma-9b's local attention.  Also: the
kernels that have no backward refuse a gradient on a non-CPU tensor, the
two that have one (flash attention at every head dim, the RG-LRU scan)
take it, and the backward's split of a group's q heads across blocks.
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


@pytest.mark.parametrize("mask", ["causal", "window8"])
@pytest.mark.parametrize("heads", [(16, 1), (4, 2)], ids=["mqa16", "gqa"])
def test_function_matches_jax_vjp_at_head_dim_256(heads, mask):
    """recurrentgemma-9b's head dim, its MQA and a window shorter than T
    (the window's lower edge binds for the later queries)."""
    kw = dict(MASKS[mask], q_offset=0)
    q, k, v, do = _inputs(*heads, 24, 24, dh=256, seed=9)
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
    "flash_attention_256": lambda g: flash_attention.flash_attention(
        _meta(1, 2, 8, 256, grad=g), _meta(1, 1, 8, 256),
        _meta(1, 1, 8, 256)),
    "mlstm_scan": lambda g: mlstm.mlstm_scan(
        _meta(1, 2, 8, 64, grad=g), _meta(1, 2, 8, 64), _meta(1, 2, 8, 64),
        _meta(1, 2, 8, dtype=torch.float32),
        _meta(1, 2, 8, dtype=torch.float32)),
}


# the kernels with a backward kernel: a gradient goes through their
# autograd Function, which on a ``meta`` tensor stops at the device check
WITH_BACKWARD = ("rg_lru_scan", "flash_attention_256", "mlstm_scan")


@pytest.mark.parametrize("name", [n for n in CALLS
                                  if n not in WITH_BACKWARD])
def test_kernels_without_backward_refuse_a_gradient(name):
    with pytest.raises(NotImplementedError,
                       match=f"^{name}: no backward kernel yet; train with "
                             f"ftl_mode='off'$"):
        CALLS[name](True)


@pytest.mark.parametrize("name", WITH_BACKWARD)
def test_the_scan_and_flash_at_256_no_longer_refuse_a_gradient(name):
    """The RG-LRU and mLSTM scans (since their backward kernels) and flash
    attention at head dim 256 (since the backward takes it) no longer
    raise ``NotImplementedError`` under grad: the call reaches the
    Function's forward, whose kernel side asks for a CUDA tensor."""
    with pytest.raises(ValueError, match="CUDA"):
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


def test_flash_backward_takes_head_dim_256():
    """Head dim 256 under grad goes through the autograd Function: on a
    CPU tensor its plain passes give a gradient, on a ``meta`` one its
    kernel side asks for a CUDA tensor, as it does under no_grad."""
    q = _meta(1, 2, 8, 256)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, _meta(1, 1, 8, 256),
                                        _meta(1, 1, 8, 256))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, _meta(1, 1, 8, 256),
                                        _meta(1, 1, 8, 256))
    qc = torch.zeros(1, 2, 8, 256).requires_grad_()
    o = flash_attention.flash_attention(qc, torch.zeros(1, 1, 8, 256),
                                        torch.zeros(1, 1, 8, 256))
    assert type(o.grad_fn).__name__ == "_AttentionBackward"


@pytest.mark.parametrize("b,hq,hk,tk,dh,want", [
    (1, 16, 1, 3072, 256, 4),   # recurrentgemma-9b's train path: 48 tiles
    (1, 16, 1, 4096, 256, 4),
    (1, 16, 1, 1000, 256, 16),  # 16 tiles: the whole group
    (1, 48, 1, 2048, 128, 12),  # granite-20b's MQA: 16 tiles
    (2, 24, 8, 1024, 128, 3),   # llama's GQA: 128 blocks without a split
    (1, 8, 8, 1500, 64, 1),     # one q head a kv head
])
def test_backward_splits_fill_the_card(b, hq, hk, tk, dh, want):
    """The fewest splits of a group's q heads (a divisor of the group)
    whose dK/dV grid, at the key tile the schedule runs, reaches the
    card's 132 SMs, else the whole group."""
    sched = flash_attention.bwd_schedule(b, hq, hk, tk, tk, dh, True, None,
                                         0)
    s = flash_attention.bwd_splits(b, hq, hk, tk, sched.block_k)
    assert s == sched.splits == want and (hq // hk) % s == 0
    blocks = -(-tk // sched.block_k) * hk * b
    assert blocks * s >= 132 or s == hq // hk
    assert s == 1 or blocks * [d for d in range(1, s)
                               if (hq // hk) % d == 0][-1] < 132


def test_flash_backward_wrapper_checks_its_operands():
    t = _meta(1, 2, 8, 128, grad=False)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_bwd(
            t, t, t, t, torch.empty(1, 2, 8), t)
