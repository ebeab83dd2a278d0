"""The chunkwise mLSTM kernel's arithmetic (``repro_torch.kernels.mlstm.
chunkwise_model``) against the JAX package's scan, on the CPU.

The model follows ``csrc/mlstm.cu`` step for step: chunks anchored at
t = 0, the stabiliser m step by step, b the in-chunk cumulative sum of
log σ(f), ``Q Kᵀ`` on the bf16 inputs, and every fp32 operand of a
product (the state, ``S∘D``, ``w∘V`` and n's weights w) split into a
bf16 hi/lo pair.  Same
numpy-seeded inputs as the card draws them (q, k, v from N(0, 1) rounded
to bf16, i from N(0, 1), f from N(3, 1)), held at the card's tolerances:
h within 0.02 + 0.02·|h| (bf16 output) and the fp32 state within 1e-3 +
1e-3·|state| (``chip_smoke.py``, ``tests/test_torch_cuda.py``).  One case
pins why the pairs are there: rounded once to bf16, the state misses its
tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mlstm import mlstm_scan as jkernel  # noqa: E402

from repro_torch.kernels import mlstm  # noqa: E402

H_TOL = (2e-2, 2e-2)
STATE_TOL = (1e-3, 1e-3)


def _inputs(b, h, t, dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, dh)).astype(np.float32)
               for _ in range(3))
    i_pre = rng.standard_normal((b, h, t)).astype(np.float32)
    f_pre = (rng.standard_normal((b, h, t)) + 3.0).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    targs = [tq, tk, tv, torch.from_numpy(i_pre), torch.from_numpy(f_pre)]
    # the JAX side gets the same bf16 values, in fp32
    jargs = [jnp.asarray(x.float().numpy()) for x in targs]
    return targs, jargs


def _share(got, want, tol) -> float:
    """Largest share of the tolerance atol + rtol·|want| that |got - want|
    uses (> 1: outside it)."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    assert np.isfinite(g).all()
    return float((np.abs(g - w) / (tol[0] + tol[1] * np.abs(w))).max())


# (b, h, t, dh, chunk): T below, equal to and off a multiple of the chunk,
# head dims 32, 96, 128, 256
CASES = [
    (1, 2, 37, 32, 64),
    (1, 1, 64, 96, 64),
    (2, 1, 150, 128, 64),
    (1, 1, 150, 256, 64),
    (1, 2, 128, 96, 64),
    (1, 1, 200, 128, 64),
]


@pytest.mark.parametrize("b,h,t,dh,chunk", CASES)
def test_model_matches_the_reference_scan(b, h, t, dh, chunk):
    targs, jargs = _inputs(b, h, t, dh, seed=t + dh)
    got, st = mlstm.chunkwise_model(*targs, chunk=chunk, return_state=True)
    want, jst = jref.mlstm_scan(*jargs, return_state=True)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, t, dh)
    assert _share(got, want, H_TOL) <= 1.0
    for name in ("C", "n", "m"):
        assert st[name].dtype == torch.float32
        assert _share(st[name], jst[name], STATE_TOL) <= 1.0


def test_model_matches_the_pallas_kernel_in_interpret_mode():
    """T a multiple of the Pallas kernel's block_t: h against the TPU
    kernel itself, run as the JAX package's tests run it on the CPU."""
    targs, jargs = _inputs(1, 2, 128, 64, seed=3)
    got = mlstm.chunkwise_model(*targs, chunk=64)
    want = jkernel(*jargs, block_t=64, interpret=True)
    assert _share(got, want, H_TOL) <= 1.0


@pytest.mark.parametrize("t,n", [(150, 101), (128, 64), (64, 7)])
def test_padded_steps_leave_the_state_bit_for_bit(t, n):
    """Steps past ``n`` with gates i = -inf, f = +inf (a bucket's
    padding) and nonzero q, k, v: the state and h of the first n steps
    equal the model's on the unpadded n steps, bit for bit, and h stays
    finite on the padded steps."""
    targs, _ = _inputs(1, 2, t, 96, seed=n)
    q, k, v, i_pre, f_pre = targs
    i_pad, f_pad = i_pre.clone(), f_pre.clone()
    i_pad[..., n:] = float("-inf")
    f_pad[..., n:] = float("inf")
    out, st = mlstm.chunkwise_model(q, k, v, i_pad, f_pad, chunk=64,
                                    return_state=True)
    cut = [x[:, :, :n].contiguous() for x in targs]
    out_n, st_n = mlstm.chunkwise_model(*cut, chunk=64, return_state=True)
    for name in ("C", "n", "m"):
        assert torch.equal(st[name], st_n[name])
    assert torch.equal(out[:, :, :n], out_n)
    assert bool(torch.isfinite(out.float()).all())


def test_unsplit_operands_miss_the_state_tolerance():
    """Why the kernel feeds its fp32 operands as bf16 pairs: rounded once
    to bf16 instead, the state leaves 1e-3 + 1e-3·|state|, while the
    pairs stay far inside it on the same input."""
    targs, jargs = _inputs(1, 1, 128, 64, seed=11)
    _, jst = jref.mlstm_scan(*jargs, return_state=True)
    _, pair = mlstm.chunkwise_model(*targs, chunk=64, return_state=True)
    _, once = mlstm.chunkwise_model(*targs, chunk=64, split=False,
                                    return_state=True)
    assert _share(pair["C"], jst["C"], STATE_TOL) < 0.1
    assert _share(once["C"], jst["C"], STATE_TOL) > 2.0
