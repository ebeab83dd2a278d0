"""The port's distributed layer on gloo process groups, against the JAX
package on one device.

Three module fixtures each spawn one group, one CPU process a rank
(``torch_spawn.run_ranks``: a ``FileStore`` under the fixture's
directory, a 120 s join timeout), running bodies from
``torch_dist_workers``: the train steps (4 ranks), MoE (2 ranks), and
serving, the sharded init and the CLI (4 ranks, 2x2).  The reference
runs here, on the global batch, as the reference's own
``test_pjit_vs_single_device_loss_parity`` holds GSPMD to the
single-device step.

* Train steps of reduced llama3.2-3b (fp32, remat on, 3 steps of 8 x 24
  bigram tokens, ``accum=2``) on
  2x2 and 4x1 ``data x model`` meshes, with and without ``compress``,
  every rank on its dp rows, against the reference's single-device
  ``make_train_step``: loss, ``grad_norm`` and lr within 1e-5 relative,
  the gathered params within 1e-5 + 1e-4 lr (step + 1) absolute (the
  tolerances of ``tests/test_torch_train.py``).  With ``compress`` the
  int8 rounding is discontinuous: a gradient that differs from the
  reference's in its last bits (the sums run in another order) can round
  to the next level where ``target / scale`` lies within about 1e-4 of a
  half-integer, and AdamW then moves that element by up to the step's
  lr, and the next steps' gradients carry it on.  So with ``compress``
  at most 0.5% of the elements may leave the
  tolerance, each by at most 2 peak_lr (step + 1), and ``grad_norm``,
  taken after the compression, is held within 1e-4 relative; the
  rounding itself is held bit for bit in
  ``tests/test_torch_compression.py``.
* Reduced qwen2-moe-a2.7b (``capacity_factor`` 0.5, tokens drop) on a
  2x1 mesh, scatter and grouped dispatch: loss, ``moe_aux`` and the
  mean gradient (the first AdamW moment at lr 0) against the reference's.
* Prefill and 4 decode steps on 2x2 for reduced llama3.2-3b and
  recurrentgemma-9b: each rank's logits against the reference's rows;
  the cache held as DTensors in ``cache_pspecs``' layout.
* The train CLI with ``--mesh 2x2 --compress --device cpu``: a run
  checkpointed at step 2 and resumed ends with the params of an
  unbroken run, bit for bit.
* ``init_train_state(..., mesh=)`` on 2x2 for five reduced families:
  the gathered params are the unsharded init's bits, and each rank's
  shard shapes (params and error state) are the reference's
  ``NamedSharding(...).shard_shape``; one compressed mesh step of each
  gives the single-device step's loss and gradient norm; a batch whose
  rows do not split over the dp ranks raises.
* A CUDA mesh without NCCL raises, and a mesh larger than the world.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.train import steps as JS  # noqa: E402

import torch_dist_workers as W  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402
from torch_spawn import run_ranks  # noqa: E402

OPT = dict(peak_lr=1e-2, warmup_steps=1, decay_steps=3)
TRAIN_RUNS = [((2, 2), 2, False), ((4, 1), 2, False),
              ((2, 2), 2, True), ((4, 1), 2, True),
              ((1, 4), 2, False), ((1, 4), 2, True)]
# the share of elements a compressed run may carry off by rounding flips
# (the port's single-device compressed step is held to the same share,
# tests/test_torch_compression.py)
FLIP_SHARE = 5e-3


@pytest.fixture(autouse=True)
def same_target():
    jhw.set_default_target("cpu_cache")
    with jax.default_matmul_precision("highest"):
        yield
    jhw.set_default_target(None)


def _jcfg(arch, **kw):
    return dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + k + "/")
        else:
            yield pre + k, v


def _batches(vocab, n=3, b=8, s=24, seed=3):
    """The bigram batches ``tests/test_torch_train.py`` trains on (with
    uniform random tokens AdamW's first steps carry the sums' rounding
    past the tolerance in a few ``wg`` elements even on one device)."""
    data = JSyntheticLM(JDataConfig(vocab_size=vocab, global_batch=b,
                                    seq_len=s, seed=seed),
                        process_index=0, process_count=1)
    return [data.batch_at(i)["tokens"] for i in range(n)]


# ---------------------------------------------------------------------------
# train steps on 2x2 and 4x1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_weights():
    return _np(JM.init_params(_jcfg("llama3.2-3b"), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def mesh_train(tmp_path_factory, llama_weights):
    batches = _batches(_jcfg("llama3.2-3b").vocab_size)
    ranks = run_ranks(W.train_steps, 4, tmp_path_factory.mktemp("train"),
                      TRAIN_RUNS, llama_weights, batches, OPT)
    return batches, ranks


def _reference_train(weights, batches, compress):
    jcfg = _jcfg("llama3.2-3b", remat=True)
    step = jax.jit(JS.make_train_step(jcfg, None, JOptConfig(**OPT),
                                      accum=2, compress=compress))
    jp = jax.tree.map(jnp.asarray, weights)
    state = JS.TrainState(
        jp, JS.init_opt_state(jp), jnp.zeros((), jnp.int32),
        JS.compression.init_error(jp) if compress else None)
    log = []
    for b in batches:
        state, m = step(state, {"tokens": jnp.asarray(b)})
        log.append({k: float(v) for k, v in m.items()})
    return log, dict(_flat(_np(state.params))), state


@pytest.mark.parametrize("run", TRAIN_RUNS,
                         ids=lambda r: f"{r[0][0]}x{r[0][1]}-accum{r[1]}"
                         f"{'-compress' if r[2] else ''}")
def test_mesh_train_step_matches_single_device_reference(
        mesh_train, llama_weights, run):
    batches, ranks = mesh_train
    (shape, accum, compress) = run
    jlog, jparams, jstate = _reference_train(llama_weights, batches,
                                             compress)
    first = ranks[0][run]
    for r in ranks:             # every rank ends with the same whole state
        log, params, _ = r[run]
        assert log == first[0]
        for name, t in _flat(params):
            np.testing.assert_array_equal(t, dict(_flat(first[1]))[name])
    log, params, ef_sq = first
    flips = total = 0
    for i, (tm, jm) in enumerate(zip(log, jlog)):
        for k in ("loss", "grad_norm", "lr"):
            # a compressed gradient's norm counts its flipped levels
            rtol = 1e-4 if compress and k == "grad_norm" else 1e-5
            np.testing.assert_allclose(tm[k], jm[k], rtol=rtol,
                                       err_msg=f"step {i} {k}")
    lr = jlog[-1]["lr"]
    steps = len(batches)
    tol = 1e-5 + 1e-4 * lr * steps
    for name, t in _flat(params):
        d = np.abs(t - jparams[name])
        if compress:
            flips += int((d > tol).sum())
            total += d.size
            assert d.max() <= tol + 2 * OPT["peak_lr"] * steps, name
        else:
            assert d.max() <= tol, (name, float(d.max()))
    if compress:
        assert flips <= FLIP_SHARE * total, (flips, total)
        jef = sum(float(np.sum(np.asarray(e) ** 2))
                  for e in jax.tree.leaves(jstate.ef_error))
        assert np.isfinite(ef_sq) and ef_sq > 0
        np.testing.assert_allclose(ef_sq, jef, rtol=1e-2)


# ---------------------------------------------------------------------------
# MoE on 2x1
# ---------------------------------------------------------------------------

MOE_KW = dict(ftl_mode="off", capacity_factor=0.5, remat=False)


@pytest.fixture(scope="module")
def moe_mesh(tmp_path_factory):
    """Both dispatches on one 2-rank group: the reference's weights and
    tokens, and each rank's metrics and first moment."""
    runs = {}
    for dispatch in ("scatter", "grouped"):
        kw = dict(MOE_KW, moe_dispatch=dispatch)
        jcfg = _jcfg("qwen2-moe-a2.7b", **kw)
        weights = _np(JM.init_params(jcfg, jax.random.PRNGKey(0)))
        toks = np.random.default_rng(2).integers(
            0, jcfg.vocab_size, (2, 24)).astype(np.int32)
        runs[dispatch] = (weights, toks, kw)
    return runs, run_ranks(W.moe_loss, 2, tmp_path_factory.mktemp("moe"),
                           runs)


@pytest.mark.parametrize("dispatch", ["scatter", "grouped"])
def test_moe_loss_aux_and_gradient_on_mesh_match_reference(moe_mesh,
                                                           dispatch):
    """Scatter dispatch gathers the dp group's tokens; grouped dispatch
    (G = 16 groups of 3 tokens from the global 48) runs each rank's 8
    groups and averages the aux over the group."""
    runs, ranks = moe_mesh
    weights, toks, kw = runs[dispatch]
    jcfg = _jcfg("qwen2-moe-a2.7b", **kw)
    opt = dict(peak_lr=0.0, warmup_steps=0)
    jp = jax.tree.map(jnp.asarray, weights)
    jstate = JS.TrainState(jp, JS.init_opt_state(jp),
                           jnp.zeros((), jnp.int32))
    jstate, jm = jax.jit(JS.make_train_step(jcfg, None, JOptConfig(**opt)))(
        jstate, {"tokens": jnp.asarray(toks)})
    jm_ = dict(_flat(_np(jstate.opt["m"])))
    for metrics, m in (r[dispatch] for r in ranks):
        for k in ("loss", "moe_aux", "grad_norm"):
            np.testing.assert_allclose(metrics[k], float(jm[k]), rtol=2e-5,
                                       atol=2e-5, err_msg=k)
        for name, t in _flat(m):
            scale = max(float(np.abs(jm_[name]).max()), 1e-30)
            assert float(np.abs(t - jm_[name]).max()) <= 2e-5 * scale, name
    assert float(np.abs(jm_["layers/pos0/moe/router/w"]).max()) > 0


# ---------------------------------------------------------------------------
# serving steps on 2x2
# ---------------------------------------------------------------------------

SERVE = {"llama3.2-3b": 2e-5, "recurrentgemma-9b": 1e-4}
CLI_ARGV = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
            "--mesh", "2x2", "--compress", "--batch", "4", "--seq", "16",
            "--accum", "2", "--ckpt-every", "2", "--log-every", "1"]
INIT_ARCHS = ["llama3.2-3b", "recurrentgemma-9b", "qwen2-moe-a2.7b",
              "xlstm-1.3b", "whisper-base"]


def _init_batch(tcfg, seed):
    """2 rows of 8 tokens (one a dp rank), and a stub frontend's inputs
    where the family takes them."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (2, 8))}
    if tcfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (2, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory):
    """One 4-rank group on a 2x2 mesh for the serving, init and CLI
    tests: their inputs, each rank's results, and the CLI's directory."""
    serve = {}
    for arch in SERVE:
        jcfg = _jcfg(arch)
        weights = _np(JM.init_params(jcfg, jax.random.PRNGKey(1)))
        toks = np.random.default_rng(4).integers(
            0, jcfg.vocab_size, (2, 12)).astype(np.int32)
        serve[arch] = (weights, toks, 8, 16)
    batches = {a: _init_batch(tconfigs.get_config(a).reduced(), i)
               for i, a in enumerate(INIT_ARCHS)}
    root = tmp_path_factory.mktemp("mesh2x2")
    ranks = run_ranks(W.two_by_two, 4, root, serve, INIT_ARCHS, batches,
                      str(root), CLI_ARGV)
    return serve, batches, root, ranks


@pytest.mark.parametrize("arch", list(SERVE))
def test_mesh_prefill_and_decode_match_reference(mesh_2x2, arch):
    serve, _, _, ranks = mesh_2x2
    weights, toks, n, max_seq = serve[arch]
    jcfg, tol = _jcfg(arch), SERVE[arch]
    jp = jax.tree.map(jnp.asarray, weights)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :n])},
                        max_seq=max_seq)
    want = [np.asarray(jl)]
    for i in range(n, toks.shape[1]):
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(toks[:, i:i + 1]), jc,
                                jnp.int32(i))
        want.append(np.asarray(jl))
    seen = set()
    for dp, logits, steps, specs in (r["serve"][arch] for r in ranks):
        seen.add(dp)
        for got, ref in zip([logits, *steps], want):
            np.testing.assert_allclose(got, ref[dp:dp + 1], rtol=tol,
                                       atol=tol)
        # a stacked KV cache (L, B, S, Hk, Dh): B over data, S over model
        k = next(v for p, v in specs.items()
                 if p.startswith("layers/") and p.endswith("/k"))
        assert k == ("S(1)", "S(2)"), k
    assert seen == {0, 1}


# ---------------------------------------------------------------------------
# the train CLI: checkpoint and resume on a mesh
# ---------------------------------------------------------------------------

def test_train_cli_on_mesh_resumes_to_the_unbroken_params(mesh_2x2):
    root, ranks = mesh_2x2[2], mesh_2x2[3]
    for (unbroken, s1, n1), (resumed, s2, n2) in (r["cli"] for r in ranks):
        assert s1 == s2 == 4 and n1 == 4 and n2 == 2
        for name, t in _flat(unbroken):
            np.testing.assert_array_equal(t, dict(_flat(resumed))[name],
                                          err_msg=name)
    assert (root / "resumed" / "step_2" / "proc_0.npz").exists()
    assert not (root / "resumed" / "step_2" / "proc_1.npz").exists()


# ---------------------------------------------------------------------------
# the sharded init, and the meshes refused
# ---------------------------------------------------------------------------

def test_sharded_init_is_the_unsharded_init_in_the_reference_layout(
        mesh_2x2):
    """Also one compressed mesh step of each family: its loss and
    gradient norm those of the single-device step on the whole batch (so
    every weight the family uses goes through the gatherer)."""
    from repro_torch.optim import OptConfig

    batches = mesh_2x2[1]
    ranks = [r["init"] for r in mesh_2x2[3]]
    assert all("do not split over 2" in r["uneven"] for r in ranks)
    jm = JAbstractMesh((2, 2), ("data", "model"))
    for arch in INIT_ARCHS:
        tcfg = tconfigs.get_config(arch).reduced()
        state = TS.init_train_state(tcfg, 7, device="cpu", compress=True)
        whole = {k: v.clone() for k, v in _flat(state.params)}
        _, ref = TS.make_train_step(tcfg, None, OptConfig(), compress=True)(
            state, {k: torch.from_numpy(v) for k, v in batches[arch].items()})
        jcfg = jconfigs.get_config(arch).reduced()
        specs = dict(_flat(JSH.param_pspecs(JM.param_shapes(jcfg), jm,
                                            jcfg)))
        for params, shapes, ef_shapes, m in (r[arch] for r in ranks):
            np.testing.assert_allclose(m["loss"], float(ref["loss"]),
                                       rtol=1e-5, err_msg=arch)
            np.testing.assert_allclose(m["grad_norm"],
                                       float(ref["grad_norm"]), rtol=1e-4,
                                       err_msg=arch)
            for name, t in whole.items():
                np.testing.assert_array_equal(
                    dict(_flat(params))[name], t.float().numpy(),
                    err_msg=f"{arch} {name}")
                want = JNamedSharding(jm, specs[name]).shard_shape(
                    tuple(t.shape))
                assert shapes[name] == tuple(want), (arch, name)
                assert ef_shapes[name] == tuple(want), (arch, name)


def test_cuda_mesh_without_nccl_and_oversized_meshes_raise(monkeypatch):
    with pytest.raises(RuntimeError, match="world size 1"):
        LM.make_mesh((2, 2), ("data", "model"), device="cpu")
    monkeypatch.setattr(torch.distributed, "is_nccl_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        LM.make_mesh((1, 1), ("data", "model"))
    assert not torch.distributed.is_initialized()


def test_mesh_step_frees_its_gradients_without_the_cyclic_collector(
        monkeypatch):
    """A mesh step's fp32 gradient accumulators die with the step, by
    reference counting alone: no reference cycle runs through the
    autograd graph (at full width one more set is 12.85 GB).  One
    process, a 1 x 1 gloo mesh, remat on, compress on."""
    import gc
    import weakref

    from repro_torch.distributed import collectives as C
    from repro_torch.optim import OptConfig

    made = []
    init = C.ParamGather.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        made.append((weakref.ref(self), [weakref.ref(t) for t in
                                         self.grads.values()]))

    monkeypatch.setattr(C.ParamGather, "__init__", spy)
    cfg = dataclasses.replace(tconfigs.get_config("llama3.2-3b").reduced(),
                              remat=True)
    mesh = LM.make_mesh((1, 1), ("data", "model"), device="cpu")
    gc.disable()
    try:
        state = TS.init_train_state(cfg, 0, device="cpu", mesh=mesh,
                                    compress=True)
        step = TS.make_train_step(cfg, mesh, OptConfig(), accum=2,
                                  compress=True)
        tokens = torch.randint(0, cfg.vocab_size, (4, 16),
                               generator=torch.Generator().manual_seed(0))
        for _ in range(2):
            state, m = step(state, {"tokens": tokens})
            assert np.isfinite(float(m["loss"]))
        assert len(made) == 4
        for owner, grads in made:
            assert owner() is None and all(g() is None for g in grads)
    finally:
        gc.enable()
        torch.distributed.destroy_process_group()
