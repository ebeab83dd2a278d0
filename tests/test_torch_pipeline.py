"""The port's GPipe pipeline against the JAX package's, on the CPU.

* ``pipeline_forward`` over a 4-rank gloo ``pipe`` group (8 layers of
  ``tanh(a @ w)`` at d = 16 in 4 stages of 2, M = 8 microbatches of 4)
  against the reference's on 4 host devices, run under ``jax.set_mesh``
  in a subprocess (``tests/util.py:run_with_devices``; jax 0.9.0 needs
  the mesh context), and against the sequential chain, within 1e-5;
  every rank gets the whole output, the same from whole staged params
  as from a DTensor holding each rank's own stage.
* ``stage_params`` and ``bubble_fraction`` equal the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.distributed import pipeline as JPL  # noqa: E402

import torch_dist_workers as W  # noqa: E402
from repro_torch.distributed import pipeline as TPL  # noqa: E402
from torch_spawn import run_ranks  # noqa: E402
from util import check, run_with_devices  # noqa: E402

_REF = """
import numpy as np, jax, jax.numpy as jnp
from repro.distributed.pipeline import pipeline_forward, stage_params
d = np.load({inp!r})
staged = stage_params([{{"w": jnp.asarray(w)}} for w in d["ws"]], 4)
mesh = jax.make_mesh((4,), ("pipe",))

def stage_fn(p, a):
    for i in range(p["w"].shape[0]):
        a = jnp.tanh(a @ p["w"][i])
    return a

with jax.set_mesh(mesh):
    out = pipeline_forward(stage_fn, staged, jnp.asarray(d["x"]), mesh=mesh)
np.save({out!r}, np.asarray(out))
"""


def _inputs(d=16, layers=8, m=8, mb=4):
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((layers, d, d)) / np.sqrt(d)).astype(
        np.float32)
    x = rng.standard_normal((m, mb, d)).astype(np.float32)
    return ws, x


def test_pipeline_on_four_ranks_matches_reference_and_chain(tmp_path):
    ws, x = _inputs()
    inp, out = str(tmp_path / "in.npz"), str(tmp_path / "out.npy")
    np.savez(inp, ws=ws, x=x)
    check(run_with_devices(_REF.format(inp=inp, out=out), 4, timeout=300))
    want = np.load(out)
    chain = torch.from_numpy(x)
    for w in ws:
        chain = torch.tanh(chain @ torch.from_numpy(w))
    ranks = run_ranks(W.pipeline, 4, tmp_path, ws, x)
    for whole, sharded in ranks:
        np.testing.assert_array_equal(sharded, whole)
        assert whole.shape == x.shape
        np.testing.assert_allclose(whole, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(whole, chain.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_stage_params_and_bubble_fraction_match_reference():
    ws, _ = _inputs()
    layers = [{"w": w, "b": {"c": w[0]}} for w in ws]
    want = JPL.stage_params([{"w": jnp.asarray(p["w"]),
                              "b": {"c": jnp.asarray(p["b"]["c"])}}
                             for p in layers], 4)
    got = TPL.stage_params([{"w": torch.from_numpy(p["w"]),
                             "b": {"c": torch.from_numpy(p["b"]["c"])}}
                            for p in layers], 4)
    assert got["w"].shape == (4, 2, 16, 16)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"]["c"].numpy(),
                                  np.asarray(want["b"]["c"]))
    for s, m in ((1, 4), (4, 8), (8, 8), (3, 1)):
        assert TPL.bubble_fraction(s, m) == JPL.bubble_fraction(s, m)
    with pytest.raises(ValueError, match="stages"):
        TPL.stage_params(layers[:6], 4)
