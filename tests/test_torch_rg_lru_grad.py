"""The RG-LRU scan's gradient in the port against ``jax.vjp`` of the JAX
package's plain scan (``repro.kernels.ref.rg_lru_scan``), on the CPU.

Two things are held: ``ops.rg_lru``'s autograd Function, whose passes on
CPU tensors are the plain ones (``ref.rg_lru_scan`` forward,
``ref.rg_lru_bwd`` backward, which recomputes the fp32 carry), and
``rg_lru.chunked_bwd_model``, the backward kernel's arithmetic (16-step
segments and 64-step units folded from the end, h_{t-1} recomputed from
the forward's unit anchors).  Same numpy-seeded inputs and cotangents on
both sides, on h and on h_T, with h0 given and not, at T = 1, 63, 64, 65
and 200.  Tolerances: fp32 within 1e-5 + 1e-5·|reference| (the same
recurrence, its sums grouped otherwise); bf16 dx and da within one bf16
step of the reference's, 2^-7·|reference| (both round an fp32 value
that may differ in its last bits once to bf16), dh0 in fp32 as in fp32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import ops, ref, rg_lru  # noqa: E402

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16_STEP = dict(rtol=2.0 ** -7, atol=1e-6)
TS = [1, 63, 64, 65, 200]


def _inputs(b, t, w, seed):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, t, w))).astype(np.float32)
    a = (0.79 + 0.2 / (1 + np.exp(-rng.standard_normal((b, t, w))))
         ).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    dh = rng.standard_normal((b, t, w)).astype(np.float32)
    dh_t = rng.standard_normal((b, w)).astype(np.float32)
    return x, a, h0, dh, dh_t


def _jax_vjp(x, a, h0, dh, dh_t, dtype):
    """(dx, da, dh0) of the reference scan; x, a and dh in ``dtype``."""
    cast = (lambda v: jnp.asarray(v).astype(dtype))
    args = (cast(x), cast(a)) + (() if h0 is None else (jnp.asarray(h0),))
    (h, h_t), vjp = jax.vjp(lambda *v: jref.rg_lru_scan(*v), *args)
    grads = vjp((cast(dh), jnp.asarray(dh_t)))
    return [np.asarray(g.astype(jnp.float32)) for g in grads] + (
        [None] if h0 is None else [])


def _torch(v, dtype=torch.float32):
    return None if v is None else torch.from_numpy(v).to(dtype)


def _close(got, want, tol):
    if want is None:
        assert got is None
        return
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("t", TS)
def test_function_matches_jax_vjp_in_fp32(t, with_h0):
    x, a, h0, dh, dh_t = _inputs(2, t, 24, seed=t)
    h0 = h0 if with_h0 else None
    want = _jax_vjp(x, a, h0, dh, dh_t, jnp.float32)
    ts = [_torch(v).requires_grad_() for v in (x, a, h0) if v is not None]
    h, h_t = ops.rg_lru(*ts)
    assert type(h.grad_fn).__name__ == "_ScanBackward"
    got = torch.autograd.grad((h, h_t), ts, (_torch(dh), _torch(dh_t)))
    for g, w_ in zip(got, want):
        _close(g, w_, FP32)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("t", TS)
def test_function_matches_jax_vjp_in_bf16(t, with_h0):
    x, a, h0, dh, dh_t = _inputs(1, t, 16, seed=10 + t)
    h0 = h0 if with_h0 else None
    want = _jax_vjp(x, a, h0, dh, dh_t, jnp.bfloat16)
    ts = [_torch(x, torch.bfloat16).requires_grad_(),
          _torch(a, torch.bfloat16).requires_grad_()]
    if h0 is not None:
        ts.append(_torch(h0).requires_grad_())
    h, h_t = ops.rg_lru(*ts)
    got = torch.autograd.grad((h, h_t), ts,
                              (_torch(dh, torch.bfloat16), _torch(dh_t)))
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    _close(got[0], want[0], BF16_STEP)
    _close(got[1], want[1], BF16_STEP)
    if h0 is not None:
        assert got[2].dtype == torch.float32
        _close(got[2], want[2], FP32)


@pytest.mark.parametrize("t", TS)
def test_unused_final_state_means_a_zero_cotangent(t):
    """Training drops h_T: autograd passes no cotangent for it, and the
    gradient is the reference's with dh_t = 0."""
    x, a, _, dh, _ = _inputs(2, t, 8, seed=20 + t)
    want = _jax_vjp(x, a, None, dh, np.zeros((2, 8), np.float32),
                    jnp.float32)
    ts = [_torch(v).requires_grad_() for v in (x, a)]
    h, _ = ops.rg_lru(*ts)
    got = torch.autograd.grad(h, ts, _torch(dh))
    for g, w_ in zip(got, want):
        _close(g, w_, FP32)


SCHEDULES = [(64, 8), (128, 8), (256, 16), (64, 32), (512, 8)]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("t", TS + [1000])
def test_chunked_bwd_model_matches_jax_vjp(t, with_h0):
    """The kernel's arithmetic against the reference in fp32, and the
    same bits at every tile and chunk the backward kernel takes."""
    b, w = 2, 16
    x, a, h0, dh, dh_t = _inputs(b, t, w, seed=30 + t)
    h0 = h0 if with_h0 else None
    want = _jax_vjp(x, a, h0, dh, dh_t, jnp.float32)
    args = (_torch(x), _torch(a), _torch(dh), _torch(dh_t), _torch(h0))
    runs = [rg_lru.chunked_bwd_model(
        *args, sched=rg_lru.schedule(b, t, w, ck, ct, backward=True))
        for ck, ct in SCHEDULES]
    for g, w_ in zip(runs[0][:2], want[:2]):
        _close(g, w_, FP32)
    if with_h0:
        _close(runs[0][2], want[2], FP32)
    for other in runs[1:]:
        assert all(torch.equal(p, q) for p, q in zip(runs[0], other))


@pytest.mark.parametrize("t", TS)
def test_chunked_bwd_model_in_bf16_within_one_step(t):
    x, a, h0, dh, dh_t = _inputs(1, t, 24, seed=40 + t)
    want = _jax_vjp(x, a, h0, dh, dh_t, jnp.bfloat16)
    bf = torch.bfloat16
    dx, da, dh0 = rg_lru.chunked_bwd_model(
        _torch(x, bf), _torch(a, bf), _torch(dh, bf), _torch(dh_t),
        _torch(h0), sched=rg_lru.schedule(1, t, 24, backward=True))
    assert dx.dtype == da.dtype == bf and dh0.dtype == torch.float32
    _close(dx, want[0], BF16_STEP)
    _close(da, want[1], BF16_STEP)
    _close(dh0, want[2], FP32)


def test_chunked_bwd_model_reads_h_from_the_forward_kernels_carry():
    """da_t = g_t·h_{t-1} with h_{t-1} the forward kernel's fp32 carry
    (``chunked_model``'s), not the bf16 h: with dh zero but at one step,
    da there is g·h_{t-1} exactly."""
    b, t, w = 1, 150, 8
    x, a, h0, _, _ = _inputs(b, t, w, seed=50)
    bf = torch.bfloat16
    xt, at = _torch(x, bf), _torch(a, bf)
    sched = rg_lru.schedule(b, t, w)
    dh = torch.zeros((b, t, w), dtype=bf)
    dh[:, 100] = 1.0
    _, da, _ = rg_lru.chunked_bwd_model(xt, at, dh, None, _torch(h0),
                                        sched=sched)
    # the forward kernel's h_99 in fp32: its h_T over the first 100 steps
    _, h99 = rg_lru.chunked_model(xt[:, :100].contiguous(),
                                  at[:, :100].contiguous(), _torch(h0),
                                  sched=rg_lru.schedule(b, 100, w))
    assert torch.equal(da[:, 100], h99.to(bf))
    assert torch.equal(da[:, 101:], torch.zeros_like(da[:, 101:]))


def test_plain_backward_takes_none_for_zero_cotangents():
    x, a, h0, dh, _ = _inputs(2, 30, 8, seed=60)
    args = [_torch(v) for v in (x, a, h0)]
    got = ref.rg_lru_bwd(*args, None, None)
    want = ref.rg_lru_bwd(*args, torch.zeros(2, 30, 8), torch.zeros(2, 8))
    assert all(torch.equal(p, q) for p, q in zip(got, want))
    assert all(float(g.abs().max()) == 0.0 for g in got)
    dx, _, _ = ref.rg_lru_bwd(*args, _torch(dh), None)
    assert torch.equal(dx[:, -1], _torch(dh)[:, -1])


def test_ref_backend_runs_the_same_function():
    x, a, h0, dh, dh_t = _inputs(2, 70, 8, seed=70)
    out = []
    for backend in ("auto", "ref"):
        ts = [_torch(v).requires_grad_() for v in (x, a, h0)]
        h, h_t = ops.rg_lru(*ts, backend=backend)
        out.append(torch.autograd.grad((h, h_t), ts,
                                       (_torch(dh), _torch(dh_t))))
    assert all(torch.equal(p, q) for p, q in zip(*out))
    with pytest.raises(ValueError):
        ops.rg_lru(_torch(x), _torch(a), backend="pallas")


def test_no_input_needing_a_gradient_keeps_no_graph():
    x, a, _, _, _ = _inputs(1, 10, 8, seed=80)
    h, h_t = ops.rg_lru(_torch(x), _torch(a))
    assert h.grad_fn is None and h_t.grad_fn is None
    with torch.no_grad():
        h, _ = ops.rg_lru(_torch(x).requires_grad_(), _torch(a))
    assert h.grad_fn is None


@pytest.mark.parametrize("b,t,w", [(1, 3072, 4096), (4, 1024, 4096),
                                   (2, 1000, 4000), (1, 1, 8)])
def test_backward_schedule_is_the_forwards_tile_and_chunk(b, t, w):
    """The backward kernel's launch: the forward's tile, chunk, grid,
    threads and scratch, its own shared memory (x, a and dh in bf16, the
    recomputed h_{t-1} in fp32, two aggregates a segment, a unit's
    aggregate and anchor), within a block's limit."""
    f = rg_lru.schedule(b, t, w)
    s = rg_lru.schedule(b, t, w, backward=True)
    assert s.backward and not f.backward
    assert (s.channel_tile, s.chunk, s.grid, s.threads, s.scratch_bytes,
            s.sync_words) == (f.channel_tile, f.chunk, f.grid, f.threads,
                              f.scratch_bytes, f.sync_words)
    ct, ck = s.channel_tile, s.chunk
    assert s.smem_bytes == (128 + 10 * ck * ct + 2 * (ck // 16) * ct * 8
                            + (ck // 64) * ct * 12 + ct * 4)
    assert s.smem_bytes <= rg_lru.SMEM_LIMIT
    assert rg_lru.anchor_shape(b, t, w) == (b, -(-t // 64), w)


def test_every_ladder_step_fits_the_backward():
    for ct, ck in rg_lru.LADDER:
        assert rg_lru.takes(ct, ck, backward=True)
    assert not rg_lru.takes(128, 256, backward=True)      # 332 KB
    assert rg_lru.takes(128, 256)
