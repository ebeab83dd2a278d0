"""The port's gradient compression against the JAX package's, on the CPU.

* ``quantize``, ``dequantize`` and ``ef_compress`` bit for bit against
  the reference on seeded fp32 and bf16 trees, a zero tensor among them
  (its scale is 1); ``ef_compress_`` (in place, as the train step runs
  it) gives the same bits as ``ef_compress``.
* The ``compress=True`` train step without a mesh, 3 steps of reduced
  llama3.2-3b (accum 1 and 2), against the reference's
  ``make_train_step(..., compress=True)``: loss within 1e-5 relative,
  ``grad_norm`` within 1e-4, params by the flip-aware rule of
  ``tests/test_torch_distributed.py`` (the int8 rounding moves an
  element by a whole level where the two sums round a gradient
  differently near a half-integer of the scale).
* ``compressed_psum_tree`` over a 4-rank gloo group against the
  reference's under ``shard_map`` on 4 host devices
  (``tests/util.py:run_with_devices``): each rank's error within four
  ulps of its target (under ``jit`` XLA fuses ``target - q * scale``
  into one multiply-add, so the reference's own jitted bits differ from
  its eager ones), the averaged gradients within 1e-6 of their largest
  (four fp32 addends summed in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.distributed import compression as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.train import steps as JS  # noqa: E402

import torch_dist_workers as W  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.distributed import compression as TC  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402
from torch_spawn import run_ranks  # noqa: E402
from util import check, run_with_devices  # noqa: E402

FLIP_SHARE = 5e-3


@pytest.fixture(autouse=True)
def same_target():
    jhw.set_default_target("cpu_cache")
    thw.set_default_target("cpu_cache")
    with jax.default_matmul_precision("highest"):
        yield
    jhw.set_default_target(None)
    thw.set_default_target(None)


def _flat(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + k + "/")
        else:
            yield pre + k, v


def _tree(seed, dtype):
    rng = np.random.default_rng(seed)
    t = {"w": rng.standard_normal((33, 17)) * 3,
         "b": {"small": rng.standard_normal(5) * 1e-6,
               "zero": np.zeros((4, 4)),
               "wide": rng.standard_normal((2, 3, 129)) * 40}}
    return jax.tree.map(lambda a: a.astype(dtype), t)


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["fp32", "bf16"])
def test_quantize_and_dequantize_bit_for_bit(dtype):
    for name, a in _flat(_tree(0, dtype)):
        jq, js = JC.quantize(jnp.asarray(a))
        tq, ts = TC.quantize(params_from_numpy({"x": a}, "cpu")["x"])
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq), name)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js), name)
        np.testing.assert_array_equal(
            TC.dequantize(tq, ts).numpy(),
            np.asarray(JC.dequantize(jq, js)), name)
        if name == "b/zero":
            assert float(ts) == 1.0


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["fp32", "bf16"])
def test_ef_compress_bit_for_bit(dtype):
    grads, error = _tree(1, dtype), jax.tree.map(
        lambda a: a.astype(np.float32), _tree(2, np.float32))
    jg, je = JC.ef_compress(jax.tree.map(jnp.asarray, grads),
                            jax.tree.map(jnp.asarray, error))
    tg, te = TC.ef_compress(params_from_numpy(grads, "cpu"),
                            params_from_numpy(error, "cpu"))
    for (name, g), (_, e) in zip(_flat(tg), _flat(te)):
        np.testing.assert_array_equal(_bits(g),
                                      _jbits(dict(_flat(jg))[name]), name)
        np.testing.assert_array_equal(e.numpy(),
                                      np.asarray(dict(_flat(je))[name]), name)
    if dtype is np.float32:     # the in-place form the train step runs
        g2 = [v for _, v in _flat(params_from_numpy(grads, "cpu"))]
        e2 = [v for _, v in _flat(params_from_numpy(error, "cpu"))]
        TC.ef_compress_(g2, e2)
        for (name, g), a, b in zip(_flat(tg), g2, e2):
            assert torch.equal(a, g) and torch.equal(
                b, dict(_flat(te))[name]), name


def test_init_error_is_fp32_zeros():
    e = TC.init_error({"a": torch.ones(3, dtype=torch.bfloat16),
                       "b": {"c": torch.ones(2, 2)}})
    assert e["a"].dtype == torch.float32 and not e["a"].any()
    assert e["b"]["c"].shape == (2, 2)


@pytest.mark.parametrize("accum", [1, 2])
def test_compressed_train_step_matches_reference(accum):
    jcfg = jconfigs.get_config("llama3.2-3b").reduced()
    tcfg = tconfigs.get_config("llama3.2-3b").reduced()
    opt = dict(peak_lr=1e-2, warmup_steps=1, decay_steps=3)
    weights = jax.tree.map(np.asarray,
                           JM.init_params(jcfg, jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, weights)
    jstate = JS.TrainState(jp, JS.init_opt_state(jp),
                           jnp.zeros((), jnp.int32), JC.init_error(jp))
    jstep = jax.jit(JS.make_train_step(jcfg, None, JOptConfig(**opt),
                                       accum=accum, compress=True))
    tp = params_from_numpy(weights, "cpu")
    tstate = TS.TrainState(tp, TS.init_opt_state(tp),
                           torch.zeros((), dtype=torch.int32),
                           TC.init_error(tp))
    tstep = TS.make_train_step(tcfg, None, OptConfig(**opt), accum=accum,
                               compress=True)
    from repro.data.pipeline import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(vocab_size=jcfg.vocab_size,
                                  global_batch=4, seq_len=24, seed=3),
                       process_index=0, process_count=1)
    for i in range(3):
        b = data.batch_at(i)["tokens"]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(b)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(b)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    lr = float(jm["lr"])
    tol = 1e-5 + 1e-4 * lr * 3
    jflat = dict(_flat(jax.tree.map(np.asarray, jstate.params)))
    flips = total = 0
    for name, t in _flat(tstate.params):
        d = np.abs(t.detach().numpy() - jflat[name])
        assert d.max() <= tol + 2 * opt["peak_lr"] * 3, name
        flips += int((d > tol).sum())
        total += d.size
    assert flips <= FLIP_SHARE * total, (flips, total)
    # the error state is carried: nonzero, and as large as the reference's
    te = sum(float(torch.sum(e ** 2)) for _, e in _flat(tstate.ef_error))
    je = sum(float(np.sum(np.asarray(e) ** 2))
             for e in jax.tree.leaves(jstate.ef_error))
    assert te > 0
    np.testing.assert_allclose(te, je, rtol=1e-2)


def test_compressed_train_step_needs_an_error_state():
    tcfg = tconfigs.get_config("llama3.2-3b").reduced()
    state = TS.init_train_state(tcfg, 0, device="cpu")
    step = TS.make_train_step(tcfg, None, OptConfig(), compress=True)
    with pytest.raises(ValueError, match="error-feedback"):
        step(state, {"tokens": torch.zeros((2, 8), dtype=torch.int64)})


_REF_PSUM = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.distributed import shard_map
from repro.distributed.compression import compressed_psum_tree
d = dict(np.load({inp!r}, allow_pickle=True))
g = {{k[2:]: jnp.asarray(v) for k, v in d.items() if k.startswith("g_")}}
e = {{k[2:]: jnp.asarray(v) for k, v in d.items() if k.startswith("e_")}}
mesh = jax.make_mesh((4,), ("data",))

def body(g, e):
    g = jax.tree.map(lambda x: x[0], g)
    e = jax.tree.map(lambda x: x[0], e)
    avg, err = compressed_psum_tree(g, "data", e)
    return (jax.tree.map(lambda x: x[None], avg),
            jax.tree.map(lambda x: x[None], err))

with jax.set_mesh(mesh):
    avg, err = jax.jit(shard_map(body, mesh=mesh,
                                 in_specs=(P("data"), P("data")),
                                 out_specs=(P("data"), P("data"))))(g, e)
np.savez({out!r}, **{{"g_" + k: np.asarray(v, np.float32)
                     for k, v in avg.items()}},
         **{{"e_" + k: np.asarray(v) for k, v in err.items()}})
"""


def test_compressed_psum_tree_on_four_ranks_matches_reference(tmp_path):
    rng = np.random.default_rng(5)
    shapes = {"w": (9, 31), "v": (4, 130), "z": (3, 3)}
    grads = [{k: (rng.standard_normal(s) * (0 if k == "z" else 1 + r)
                  ).astype(np.float32) for k, s in shapes.items()}
             for r in range(4)]
    errors = [{k: (rng.standard_normal(s) * 0.01).astype(np.float32)
               for k, s in shapes.items()} for r in range(4)]
    inp, out = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(inp, **{f"g_{k}": np.stack([g[k] for g in grads])
                     for k in shapes},
             **{f"e_{k}": np.stack([e[k] for e in errors]) for k in shapes})
    check(run_with_devices(_REF_PSUM.format(inp=inp, out=out), 4,
                           timeout=300))
    want = dict(np.load(out))
    ranks = run_ranks(W.compressed_psum_tree, 4, tmp_path, grads, errors)
    for r, (g, e) in enumerate(ranks):
        for k in shapes:
            # under jit XLA fuses target - q * scale into one multiply-add
            ulp = np.finfo(np.float32).eps * (np.abs(grads[r][k]).max()
                                              + np.abs(errors[r][k]).max())
            np.testing.assert_allclose(e[k], want[f"e_{k}"][r], rtol=0,
                                       atol=4 * ulp, err_msg=k)
            np.testing.assert_allclose(g[k], want[f"g_{k}"][r], rtol=1e-6,
                                       atol=1e-6 * np.abs(
                                           want[f"g_{k}"]).max(), err_msg=k)


def test_compressed_psum_over_a_mesh_dim_needs_the_mesh():
    with pytest.raises(ValueError, match="mesh="):
        TC.compressed_psum(torch.ones(3), "data")

