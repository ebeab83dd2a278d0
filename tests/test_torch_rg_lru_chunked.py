"""The RG-LRU kernel's arithmetic (``rg_lru.chunked_model``) against the
JAX package and the port's plain scan, on the CPU.

``chunked_model`` runs ``csrc/rg_lru.cu``'s decomposition: 16-step
segments and 64-step units anchored at t = 0, each folded from (1, 0);
the carry at each unit's start folded from h0 over every earlier unit;
each step re-scanned from its segment's carry; every product and sum
rounded on its own.  Same numpy-seeded inputs on both sides.
Tolerances: fp32, |model - reference| <= 1e-5 + 1e-5·|reference| (the
same recurrence, its sums grouped by segment and unit); bf16 h, 1e-2 +
1e-2·|reference| (both round an fp32 carry that differs in its last bits
once to bf16: at most one bf16 step, 2^-8 relative, apart), h_T in fp32
as in fp32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rg_lru import rg_lru_scan as jkernel  # noqa: E402

from repro_torch.kernels import ref, rg_lru  # noqa: E402

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _inputs(b, t, w, seed=0):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, t, w))).astype(np.float32)
    a = (0.79 + 0.2 / (1 + np.exp(-rng.standard_normal((b, t, w))))
         ).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return x, a, h0


def _model(x, a, h0, dtype):
    b, t, w = x.shape
    return rg_lru.chunked_model(
        torch.from_numpy(x).to(dtype), torch.from_numpy(a).to(dtype),
        None if h0 is None else torch.from_numpy(h0),
        sched=rg_lru.schedule(b, t, w))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


SHAPES = [(2, 200, 24), (1, 1, 8), (3, 131, 13), (2, 1000, 40),
          (1, 64, 16), (2, 65, 9), (1, 333, 128)]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,t,w", SHAPES)
def test_model_matches_the_jax_reference_in_fp32(b, t, w, with_h0):
    x, a, h0 = _inputs(b, t, w, seed=t)
    h0 = h0 if with_h0 else None
    h, h_t = _model(x, a, h0, torch.float32)
    jh, jh_t = jref.rg_lru_scan(jnp.asarray(x), jnp.asarray(a),
                                None if h0 is None else jnp.asarray(h0))
    assert h.dtype == torch.float32 and h_t.dtype == torch.float32
    _close(h, jh, FP32)
    _close(h_t, jh_t, FP32)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,t,w", SHAPES)
def test_model_matches_the_jax_reference_in_bf16(b, t, w, with_h0):
    x, a, h0 = _inputs(b, t, w, seed=t + 1)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    ab = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    h0 = h0 if with_h0 else None
    h, h_t = _model(xb, ab, h0, torch.bfloat16)
    jh, jh_t = jref.rg_lru_scan(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(a, jnp.bfloat16),
                                None if h0 is None else jnp.asarray(h0))
    assert h.dtype == torch.bfloat16 and h_t.dtype == torch.float32
    _close(h, np.asarray(jh.astype(jnp.float32)), BF16)
    _close(h_t, jh_t, FP32)


@pytest.mark.parametrize("with_h0", [False, True])
def test_model_matches_the_pallas_kernel_in_interpret_mode(with_h0):
    """T and W multiples of the Pallas kernel's blocks: the TPU kernel
    itself, run as the JAX package's tests run it on the CPU."""
    x, a, h0 = _inputs(2, 256, 128, seed=5)
    h0 = h0 if with_h0 else None
    h, h_t = _model(x, a, h0, torch.float32)
    kh, kh_t = jkernel(jnp.asarray(x), jnp.asarray(a),
                       None if h0 is None else jnp.asarray(h0),
                       block_t=64, block_d=128, interpret=True)
    _close(h, kh, FP32)
    _close(h_t, kh_t, FP32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,w", SHAPES)
def test_model_matches_the_ports_plain_scan(b, t, w, dtype):
    x, a, h0 = _inputs(b, t, w, seed=t + 2)
    xt, at = torch.from_numpy(x).to(dtype), torch.from_numpy(a).to(dtype)
    h0t = torch.from_numpy(h0)
    h, h_t = rg_lru.chunked_model(xt, at, h0t,
                                  sched=rg_lru.schedule(b, t, w))
    want, want_t = ref.rg_lru_scan(xt, at, h0t)
    _close(h, want.float().numpy(),
           FP32 if dtype == torch.float32 else BF16)
    _close(h_t, want_t.numpy(), FP32)


@pytest.mark.parametrize("t,n", [(200, 131), (128, 64), (64, 7),
                                 (1000, 513), (300, 1)])
def test_padded_steps_leave_h_and_h_t_bit_for_bit(t, n):
    """Steps past ``n`` with a = 1 and x = 0 (a bucket's padding): h_T
    and the first n steps of h equal the unpadded scan's, bit for bit,
    whatever the two shapes' schedules."""
    x, a, _ = _inputs(2, t, 48, seed=n)
    xt = torch.from_numpy(x).bfloat16()
    at = torch.from_numpy(a).bfloat16()
    xt[:, n:] = 0
    at[:, n:] = 1
    h, h_t = rg_lru.chunked_model(xt, at,
                                  sched=rg_lru.schedule(2, t, 48))
    h_n, h_t_n = rg_lru.chunked_model(
        xt[:, :n].contiguous(), at[:, :n].contiguous(),
        sched=rg_lru.schedule(2, n, 48))
    assert torch.equal(h_t, h_t_n)
    assert torch.equal(h[:, :n], h_n)


def test_a_ragged_t_and_pads_give_exact_identity_aggregates():
    """T = 131 stages steps 131..191 as a = 1, x = 0: its third unit's
    aggregate equals that of a T = 200 scan padded from 131, and every
    unit of pads alone is exactly (A, X) = (1, 0)."""
    x, a, _ = _inputs(1, 200, 32, seed=9)
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    xt[:, 131:] = 0
    at[:, 131:] = 1
    (_, _), (uA, uX) = rg_lru.aggregates(xt, at,
                                         sched=rg_lru.schedule(1, 200, 32))
    (_, _), (nA, nX) = rg_lru.aggregates(
        xt[:, :131].contiguous(), at[:, :131].contiguous(),
        sched=rg_lru.schedule(1, 131, 32))
    assert uA.shape[1] == 4 and nA.shape[1] == 3
    assert torch.equal(uA[:, :3], nA) and torch.equal(uX[:, :3], nX)
    assert torch.equal(uA[:, 3], torch.ones_like(uA[:, 3]))
    assert torch.equal(uX[:, 3], torch.zeros_like(uX[:, 3]))
    # a unit whose steps are all pads, past a longer T of pads
    xp = torch.zeros((1, 128, 32))
    ap = torch.ones((1, 128, 32))
    (sA, sX), (pA, pX) = rg_lru.aggregates(
        xp, ap, sched=rg_lru.schedule(1, 128, 32))
    assert bool((pA == 1).all() and (pX == 0).all())
    assert bool((sA == 1).all() and (sX == 0).all())


def test_a_long_unit_may_underflow_its_weight_to_zero():
    """Π a over 64 steps of a = 0.25 is 2^-128, a denormal in fp32, and
    over 128 steps 0: the carry's weight, which the fold multiplies and
    never divides by, so h stays the plain scan's."""
    t, w = 256, 8
    x = torch.full((1, t, w), 0.5)
    a = torch.full((1, t, w), 0.25)
    (_, _), (uA, _) = rg_lru.aggregates(x, a,
                                        sched=rg_lru.schedule(1, t, w))
    assert float(uA[0, 0, 0]) == 2.0 ** -128
    h0 = torch.full((1, w), 1e30)
    h, h_t = rg_lru.chunked_model(x, a, h0, sched=rg_lru.schedule(1, t, w))
    want, want_t = ref.rg_lru_scan(x, a, h0)
    assert bool(torch.isfinite(h).all())
    torch.testing.assert_close(h, want, **FP32)
    torch.testing.assert_close(h_t, want_t, **FP32)


def test_the_model_ignores_the_tile_and_the_chunk():
    """Its values are fixed by the segment and the unit alone: every
    tile and chunk the kernel takes gives the same bits, so a padded
    bucket and the unpadded prompt, scheduled differently, agree."""
    x, a, h0 = _inputs(2, 700, 40, seed=4)
    xt, at = torch.from_numpy(x).bfloat16(), torch.from_numpy(a).bfloat16()
    h0t = torch.from_numpy(h0)
    want = rg_lru.chunked_model(xt, at, h0t,
                                sched=rg_lru.schedule(2, 700, 40))
    for ct, ck in [(64, 256), (8, 64), (128, 128), (32, 512)]:
        got = rg_lru.chunked_model(
            xt, at, h0t, sched=rg_lru.schedule(2, 700, 40, ck, ct))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
