"""The port's ``gemm_act`` and partial-MLP executor on CPU tensors against
the JAX package.

On a CPU tensor the ``gemm_act`` wrapper (and ``ops``) runs its plain
PyTorch version; these tests hold it to the JAX package's Pallas kernel
``repro.kernels.gemm_gelu.gemm_act`` in interpret mode and to
``repro.kernels.ref``, and the port's ``cuda_partial_mlp`` executor to the
reference's ``pallas_partial_mlp`` (its Pallas kernels in interpret mode),
on the same inputs made with numpy: fp32 within rtol=atol=2e-5, bf16
within 2e-2 (the JAX kernel tests' tolerances).  The CUDA kernel itself
runs only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import hw as jhw  # noqa: E402
from repro.core.ftl import registry as jregistry  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gemm_gelu import gemm_act as jgemm_act  # noqa: E402

from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.core.ftl import registry as tregistry  # noqa: E402
from repro_torch.kernels import gemm as tgemm  # noqa: E402
from repro_torch.kernels import gemm_act as tgemm_act  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DTYPES = ["float32", "bfloat16"]
ACTS = ["gelu", "gelu_exact", "silu", "relu"]


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("bias", [False, True])
def test_gemm_act_matches_pallas_and_ref(act, bias, dtype):
    """The paper's benchmark op at the JAX kernel tests' shapes."""
    m, k, n = 256, 384, 512
    (jx, tx), (jw, tw) = both(rnd(0, (m, k), dtype, 0.1)), \
        both(rnd(1, (k, n), dtype, 0.1))
    jb, tb = both(rnd(2, (n,), dtype)) if bias else (None, None)
    out = ops.gemm_act(tx, tw, tb, act=act)
    assert out.dtype == tx.dtype and out.shape == (m, n)
    close(out, jgemm_act(jx, jw, jb, act=act, block_m=128, block_n=128,
                         block_k=128, interpret=True), dtype)
    close(out, jref.gemm_act(jx, jw, jb, act=act), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["gelu", "identity"])
@pytest.mark.parametrize("m,k,n", [(7, 40, 24), (130, 72, 129)])
def test_gemm_act_ragged_matches_ref(m, k, n, act, dtype):
    """Shapes no block divides (the CUDA kernel masks its edges)."""
    (jx, tx), (jw, tw) = both(rnd(3, (m, k), dtype, 0.3)), \
        both(rnd(4, (k, n), dtype, 0.3))
    jb, tb = both(rnd(5, (n,), dtype))
    close(tgemm_act.gemm_act(tx, tw, tb, act=act),
          jref.gemm_act(jx, jw, jb, act=act), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("lead,k,f,n", [((2, 64), 128, 256, 128),
                                        ((256,), 384, 512, 256)])
def test_partial_mlp_executor_matches_pallas(lead, k, f, n, bias, dtype):
    """``cuda_partial_mlp`` on CPU tensors (its kernels' plain versions)
    against ``pallas_partial_mlp`` (gemm_act, then gemm, in interpret
    mode): the same roundings of h and of y."""
    (jx, tx) = both(rnd(6, (*lead, k), dtype, 0.5))
    (jw1, tw1), (jw2, tw2) = both(rnd(7, (k, f), dtype, k ** -0.5)), \
        both(rnd(8, (f, n), dtype, f ** -0.5))
    (jb1, tb1), (jb2, tb2) = ((both(rnd(9, (f,), dtype, 0.1)),
                               both(rnd(10, (n,), dtype, 0.1))) if bias
                              else ((None, None), (None, None)))
    want = jregistry.get("pallas_partial_mlp").run(
        jx, jw1, jw2, None, jb1, jb2, act="gelu", target=jhw.TPU_V5E)
    got = tregistry.get("cuda_partial_mlp").run(
        tx, tw1, tw2, None, tb1, tb2, act="gelu")
    assert got.shape == (*lead, n) and got.dtype == tx.dtype
    close(got, want, dtype)
    close(got, jref.mlp(jx, jw1, jw2, None, jb1, jb2, act="gelu"), dtype)


def test_partial_mlp_executor_refuses_a_gate():
    x = torch.zeros(4, 8)
    w = torch.zeros(8, 8)
    with pytest.raises(ValueError):
        tregistry.get("cuda_partial_mlp").run(x, w, w, w, None, None,
                                              act="silu")


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = (tgemm_act.launches, tgemm.launches)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 16, generator=g)
    ops.gemm_act(x[0], torch.randn(16, 8, generator=g))
    tregistry.get("cuda_partial_mlp").run(
        x, torch.randn(16, 32, generator=g), torch.randn(32, 16, generator=g),
        None, None, None, act="gelu")
    assert (tgemm_act.launches, tgemm.launches) == before


def test_non_cpu_non_cuda_tensors_raise():
    """A tensor that is not on the CPU must reach the kernel or raise;
    the wrapper never runs the plain version for it."""
    x = torch.empty(64, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tgemm_act.gemm_act(x, x)
    c = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tgemm_act.gemm_act(c, c, x[0])               # bias elsewhere

