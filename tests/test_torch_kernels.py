"""The port's kernel modules on CPU tensors against the JAX kernels.

On a CPU tensor every kernel wrapper (and ``ops``) runs its plain PyTorch
version; these tests hold that plain version to the JAX package's Pallas
kernels in interpret mode and to ``repro.kernels.ref``, on the same inputs
made with numpy: fp32 within rtol=atol=2e-5 (the block-execution
tolerance of the JAX tests), bf16 within 2e-2 (the JAX kernel tests' bf16
tolerance).  The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.fused_mlp import fused_mlp as jfused  # noqa: E402
from repro.kernels.gemm import gemm as jgemm  # noqa: E402

from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import fused_mlp as tfused  # noqa: E402
from repro_torch.kernels import gemm as tgemm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def rnd(seed, shape, dtype, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale)
    return a.astype(np.float32).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)


def both(a):
    """(jax array, CPU tensor) of one numpy array."""
    return jnp.asarray(a), tensor_from_numpy(a, "cpu")


def close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j).astype(np.float32),
                               **tol(dtype))


# ---------------------------------------------------------------------------
# gemm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(64, 96, 80), (7, 40, 24),
                                   (130, 72, 129)])
def test_gemm_matches_pallas_and_ref(m, k, n, dtype):
    (jx, tx), (jw, tw) = both(rnd(0, (m, k), dtype, 0.3)), \
        both(rnd(1, (k, n), dtype, 0.3))
    out = ops.gemm(tx, tw)
    assert out.dtype == tx.dtype and out.shape == (m, n)
    close(out, jgemm(jx, jw, block_m=m, block_n=n, block_k=k,
                     interpret=True), dtype)
    close(out, jref.gemm(jx, jw), dtype)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # b, hq, hk, tq, tk, dh, causal, window, q_offset
    (1, 4, 2, 16, 16, 32, True, None, 0),      # GQA, causal
    (2, 4, 4, 24, 24, 16, False, None, 0),     # MHA, bidirectional
    (1, 6, 2, 40, 40, 32, True, 8, 0),         # local window
    (1, 2, 1, 8, 40, 16, True, None, 32),      # q_offset (chunked decode)
    (1, 2, 2, 9, 9, 16, False, 1, 0),          # window 1: the diagonal
    (1, 4, 2, 13, 13, 32, True, None, 0),      # ragged T
]


def _attn_inputs(case, dtype):
    b, hq, hk, tq, tk, dh = case[:6]
    return (both(rnd(2, (b, hq, tq, dh), dtype)),
            both(rnd(3, (b, hk, tk, dh), dtype)),
            both(rnd(4, (b, hk, tk, dh), dtype)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_matches_pallas_and_ref(case, dtype):
    causal, window, q_offset = case[6:]
    (jq, tq_), (jk, tk_), (jv, tv_) = _attn_inputs(case, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = ops.attention(tq_, tk_, tv_, **kw)
    assert out.shape == tq_.shape and out.dtype == tq_.dtype
    close(out, jflash(jq, jk, jv, block_q=case[3], block_k=case[4],
                      interpret=True, **kw), dtype)
    close(out, jref.attention(jq, jk, jv, **kw), dtype)


def test_fully_masked_rows_give_zeros():
    """Queries at positions 10..13 over keys 0..2 with a window of 2 see
    no key: every row is fully masked and gives zeros, not NaN."""
    q = torch.randn(1, 2, 4, 16, generator=torch.Generator().manual_seed(0))
    k = torch.randn(1, 2, 3, 16, generator=torch.Generator().manual_seed(1))
    v = torch.randn(1, 2, 3, 16, generator=torch.Generator().manual_seed(2))
    out = ops.attention(q, k, v, causal=True, window=2, q_offset=10)
    assert torch.equal(out, torch.zeros_like(out))
    jout = jref.attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                          jnp.asarray(v.numpy()), causal=True, window=2,
                          q_offset=10)
    np.testing.assert_array_equal(np.asarray(jout), 0.0)


# ---------------------------------------------------------------------------
# fused MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,f,n,gated,bias,act", [
    (32, 64, 128, 64, True, False, "silu"),    # llama-style gated SwiGLU
    (16, 48, 96, 40, False, True, "gelu"),     # biased tanh-gelu
    (4, 64, 128, 64, True, True, "relu"),      # decode-sized M
    (24, 32, 64, 32, False, False, "gelu_exact"),
])
def test_fused_mlp_matches_pallas_and_ref(m, k, f, n, gated, bias, act,
                                          dtype):
    (jx, tx) = both(rnd(5, (m, k), dtype, 0.5))
    (jw1, tw1) = both(rnd(6, (k, f), dtype, k ** -0.5))
    (jw2, tw2) = both(rnd(7, (f, n), dtype, f ** -0.5))
    (jwg, twg) = both(rnd(8, (k, f), dtype, k ** -0.5)) if gated \
        else (None, None)
    (jb1, tb1) = both(rnd(9, (f,), dtype, 0.1)) if bias else (None, None)
    (jb2, tb2) = both(rnd(10, (n,), dtype, 0.1)) if bias else (None, None)
    out = ops.fused_mlp(tx, tw1, tw2, twg, tb1, tb2, act=act)
    assert out.shape == (m, n) and out.dtype == tx.dtype
    close(out, jfused(jx, jw1, jw2, jwg, jb1, jb2, act=act, block_m=m,
                      block_f=f // 2, interpret=True), dtype)
    close(out, jref.mlp(jx, jw1, jw2, jwg, jb1, jb2, act=act), dtype)


def test_fused_mlp_leading_dims_flatten():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 16, generator=g)
    w1, wg = torch.randn(16, 32, generator=g), torch.randn(16, 32,
                                                           generator=g)
    w2 = torch.randn(32, 16, generator=g)
    out = ops.fused_mlp(x, w1, w2, wg, act="silu")
    want = ref.mlp(x.reshape(10, 16), w1, w2, wg, act="silu")
    torch.testing.assert_close(out.reshape(10, 16), want)


def test_ref_backend_is_the_plain_version():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(8, 16, generator=g), torch.randn(16, 4, generator=g)
    assert torch.equal(ops.gemm(x, w, backend="ref"), ref.gemm(x, w))
    with pytest.raises(ValueError):
        ops.gemm(x, w, backend="pallas")


# ---------------------------------------------------------------------------
# dispatch: the device decides, and nothing falls back
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_without_counting():
    before = (tgemm.launches, tflash.launches, tfused.launches)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 16, generator=g)
    ops.gemm(x, torch.randn(16, 8, generator=g))
    q = torch.randn(1, 2, 8, 16, generator=g)
    ops.attention(q, q, q)
    ops.fused_mlp(x, torch.randn(16, 32, generator=g),
                  torch.randn(32, 16, generator=g))
    assert (tgemm.launches, tflash.launches, tfused.launches) == before


@pytest.mark.parametrize("call", ["gemm", "attention", "fused_mlp"])
def test_non_cpu_non_cuda_tensors_raise(call):
    """A tensor that is not on the CPU must reach the kernel or raise;
    the wrappers never run the plain version for it."""
    x = torch.empty(64, 64, device="meta", dtype=torch.bfloat16)
    q = torch.empty(1, 2, 64, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        if call == "gemm":
            tgemm.gemm(x, x)
        elif call == "attention":
            tflash.flash_attention(q, q, q)
        else:
            tfused.fused_mlp(x, x, x)


def test_act_codes_cover_every_activation():
    assert set(ref.ACT_CODES) == set(ref._ACTS)
