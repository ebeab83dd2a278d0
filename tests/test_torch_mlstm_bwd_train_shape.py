"""The mLSTM backward kernel's CPU model at the train path's shape.

``kernels/mlstm.py:chunkwise_bwd_model`` (the backward kernel's
decomposition and rounding points, fp32 products split into bf16 pairs)
against ``ref.mlstm_bwd`` (autograd through the plain recurrence), on
the distribution ``chip_smoke.py`` phase 2 draws for its rows: q, k, v
and the cotangent N(0, 1) in bf16, the input gate N(0, 1), the forget
gate N(0, 1) + 3 as the model shifts it.

xlstm-1.3b's train path runs the scan at (B, H, T, Dh) = (16, 4, 128,
1024).  The plain gradient and the model take about half a minute a
sequence on the CPU (the plain recurrence forms every step's product
elementwise), so the test holds one of the microbatch's 16 sequences,
all four heads, at the train path's T and Dh: (1, 4, 128, 1024), two
chunks of 64.  dq, dk, dv must
stay within phase 2's bf16 rule (0.02 + 0.02·|g|), di and df within the
gates' (1e-3·max|g| + 1e-3·|g|).  The test prints each gradient's share
of its rule (``pytest -s``).

Run as a script, it holds the whole train shape (16, 4, 128, 1024), one
sequence at a time, under the same rules over all 16 sequences, prints
the shares and exits 1 if one is over 1 (about 8 minutes on the CPU)::

    PYTHONPATH=src python tests/test_torch_mlstm_bwd_train_shape.py
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import mlstm, ref  # noqa: E402

TRAIN_SHAPE = (16, 4, 128, 1024)
SHAPE = (1, *TRAIN_SHAPE[1:])


def _draw(shape, seed: int = 0):
    """q, k, v, the cotangent (bf16) and the two gates, phase 2's way."""
    rng = np.random.default_rng(seed)

    def draw(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    q, k, v, dh = (draw(*shape).to(torch.bfloat16) for _ in range(4))
    return q, k, v, draw(*shape[:3]), draw(*shape[:3]) + 3.0, dh


def _share(got, want, atol, rtol) -> float:
    g, w = got.float(), want.float()
    assert g.shape == w.shape and bool(torch.isfinite(g).all())
    return float(((g - w).abs() / (atol + rtol * w.abs())).max())


def _shares(got, want) -> dict[str, float]:
    """Each gradient's largest share of its rule: dq, dk, dv (bf16) by
    0.02 + 0.02·|g|, di and df (fp32) by 1e-3·max|g| + 1e-3·|g|."""
    shares = {}
    for n, g, w in zip("qkvif", got, want):
        if n in "qkv":
            assert g.dtype == torch.bfloat16
            shares[n] = _share(g, w, 2e-2, 2e-2)
        else:
            assert g.dtype == torch.float32
            shares[n] = _share(g, w, 1e-3 * float(w.abs().max()), 1e-3)
    return shares


def test_bwd_model_within_the_rules_at_the_train_shape():
    inputs = _draw(SHAPE)
    got = mlstm.chunkwise_bwd_model(*inputs)
    want = ref.mlstm_bwd(*inputs)
    shares = _shares(got, want)
    print(f"{SHAPE}: share of the rule by gradient {shares}")
    assert all(s <= 1.0 for s in shares.values()), shares


def main() -> int:
    """The whole train shape, one sequence at a time (each sequence's
    gradient is its own), the shares taken over all of them at once."""
    inputs = _draw(TRAIN_SHAPE)
    got, want = [], []
    for b in range(TRAIN_SHAPE[0]):
        seq = [t[b:b + 1] for t in inputs]
        got.append(mlstm.chunkwise_bwd_model(*seq))
        want.append(ref.mlstm_bwd(*seq))
        print(f"sequence {b}: {_shares(got[-1], want[-1])}", flush=True)
    shares = _shares([torch.cat(g) for g in zip(*got)],
                     [torch.cat(w) for w in zip(*want)])
    print(f"{TRAIN_SHAPE}: share of the rule by gradient {shares}")
    return 0 if all(s <= 1.0 for s in shares.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
