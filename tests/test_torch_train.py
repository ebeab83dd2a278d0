"""The port's training step against the JAX package's, on the CPU in fp32.

* ``cross_entropy`` with and without a mask and a z-loss: loss and aux
  within 1e-6.
* The gradients of ``make_loss_fn`` for reduced llama3.2-3b, granite-20b,
  recurrentgemma-9b and xlstm-1.3b (two rows of 24 tokens, JAX weights
  converted, ``ftl_mode`` "off" and "auto"): loss within 1e-6 and each
  leaf's max |Δg| within 1e-4 of that leaf's max |g|.  The port's
  attention core runs its autograd Function's plain backward here
  (``ref.attention_bwd``), and recurrentgemma-9b's RG-LRU scan its own
  (``ref.rg_lru_bwd``, once for each recurrent layer, counted).
* ``make_train_step`` against ``jax.jit`` of the reference's for accum 1
  and 2, three steps of reduced llama3.2-3b on ``SyntheticLM`` bigram
  batches: per-step loss, grad_norm and lr within 1e-5 relative, params
  after each step within 1e-5 + 1e-4·lr·(step+1) absolute.
* ``cfg.remat`` gives the same gradients as no remat, bit for bit.

The reference runs with matmul precision "highest"; both packages plan on
the same explicit default target.
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.train import losses as jlosses  # noqa: E402
from repro.train import steps as JS  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train import losses as tlosses  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

ARCHS = ["llama3.2-3b", "granite-20b", "recurrentgemma-9b", "xlstm-1.3b"]


@pytest.fixture(autouse=True)
def same_target():
    jhw.set_default_target("cpu_cache")
    thw.set_default_target("cpu_cache")
    with jax.default_matmul_precision("highest"):
        yield
    jhw.set_default_target(None)
    thw.set_default_target(None)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw),
            dataclasses.replace(tconfigs.get_config(arch).reduced(), **kw))


def _flat(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + k + "/")
        else:
            yield pre + k, v


@pytest.fixture(scope="module")
def jweights():
    """JAX init_params of each reduced config (fp32), as numpy."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg, _ = _cfgs(arch)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(i))
        out[arch] = jax.tree.map(np.asarray, jp)
    return out


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_reference(masked, z_loss):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 19)).astype(np.float32) * 3
    labels = rng.integers(0, 19, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.4).astype(np.float32) if masked else None
    jl, ja = jlosses.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask), z_loss=z_loss)
    tl, ta = tlosses.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), z_loss=z_loss)
    np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=1e-6)
    assert set(ta) == set(ja) == {"nll", "accuracy", "tokens"}
    for k in ja:
        np.testing.assert_allclose(float(ta[k]), float(ja[k]), rtol=0,
                                   atol=1e-6)


def test_cross_entropy_all_masked_counts_one_token():
    logits = torch.zeros((1, 4, 7))
    labels = torch.zeros((1, 4), dtype=torch.int64)
    loss, aux = tlosses.cross_entropy(logits, labels, torch.zeros((1, 4)))
    assert float(loss) == 0.0 and float(aux["tokens"]) == 1.0


# ---------------------------------------------------------------------------
# gradients of the loss, four families
# ---------------------------------------------------------------------------

def _torch_grads(tcfg, tp, tokens):
    leaves = TM.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = TS.make_loss_fn(tcfg)(tp, {"tokens": torch.from_numpy(
        tokens)})
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    names = [n for n, _ in _flat(tp)]
    grads = {n: (torch.zeros_like(p) if g is None else g)
             for n, p, g in zip(names, leaves, gs)}
    return float(loss.detach()), grads


@pytest.mark.parametrize("mode", ["off", "auto"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_reference(jweights, arch, mode):
    jcfg, tcfg = _cfgs(arch, ftl_mode=mode)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, jweights[arch])
    (jl, _), jg = jax.value_and_grad(JS.make_loss_fn(jcfg), has_aux=True)(
        jp, {"tokens": jnp.asarray(tokens)})
    with mock.patch.object(tref, "rg_lru_bwd",
                           wraps=tref.rg_lru_bwd) as scan_bwd:
        tl, tg = _torch_grads(tcfg, params_from_numpy(jweights[arch],
                                                      "cpu"), tokens)
    # the scan's gradient goes through its autograd Function: its plain
    # backward runs once in each recurrent layer
    kinds = TM.period_kinds(tcfg)
    n_rec = sum(kinds[i % len(kinds)] == "rec" for i in range(tcfg.n_layers))
    assert scan_bwd.call_count == n_rec
    assert n_rec > 0 or tcfg.family != "hybrid"
    np.testing.assert_allclose(tl, float(jl), rtol=0, atol=1e-6)
    jflat = dict(_flat(jax.tree.map(np.asarray, jg)))
    assert set(jflat) == set(tg)
    worst = 0.0
    for name, want in jflat.items():
        got = tg[name].numpy()
        assert got.shape == want.shape, name
        if want.size == 0:          # xlstm-1.3b's empty period stack
            continue
        scale = float(np.abs(want).max())
        rel = float(np.abs(got - want).max()) / max(scale, 1e-30)
        worst = max(worst, rel)
        assert rel <= 1e-4, (name, rel)
    assert worst <= 1e-4


def test_empty_stack_leaves_get_zero_gradients(jweights):
    """Reduced xlstm-1.3b has no whole period: its ``layers`` leaves are
    (0, ...) and no gradient reaches them; the step counts them as
    zeros and moves on."""
    _, tcfg = _cfgs("xlstm-1.3b")
    tp = params_from_numpy(jweights["xlstm-1.3b"], "cpu")
    empty = [p for p in TM.tree_leaves(tp["layers"])]
    assert empty and all(p.shape[0] == 0 for p in empty)
    state = TS.TrainState(tp, TS.init_opt_state(tp),
                          torch.zeros((), dtype=torch.int32))
    step = TS.make_train_step(tcfg, None, OptConfig(warmup_steps=0))
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 16))
    state, m = step(state, {"tokens": torch.from_numpy(tokens)})
    assert np.isfinite(float(m["loss"])) and int(state.step) == 1


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(jweights, accum):
    jcfg, tcfg = _cfgs("llama3.2-3b")
    kw = dict(peak_lr=1e-2, warmup_steps=1, decay_steps=3)
    jstep = jax.jit(JS.make_train_step(jcfg, None, JOptConfig(**kw),
                                       accum=accum))
    tstep = TS.make_train_step(tcfg, None, OptConfig(**kw), accum=accum)
    jp = jax.tree.map(jnp.asarray, jweights["llama3.2-3b"])
    jstate = JS.TrainState(jp, JS.init_opt_state(jp),
                           jnp.zeros((), jnp.int32))
    tp = params_from_numpy(jweights["llama3.2-3b"], "cpu")
    tstate = TS.TrainState(tp, TS.init_opt_state(tp),
                           torch.zeros((), dtype=torch.int32))
    data = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size,
                                    global_batch=4, seq_len=24, seed=3),
                        process_index=0, process_count=1)
    for i in range(3):
        batch = data.batch_at(i)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(
            batch["tokens"])})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
        lr = float(jm["lr"])
        jflat = dict(_flat(jax.tree.map(np.asarray, jstate.params)))
        for name, t in _flat(tstate.params):
            np.testing.assert_allclose(
                t.detach().numpy(), jflat[name], rtol=0,
                atol=1e-5 + 1e-4 * lr * (i + 1),
                err_msg=f"step {i} {name}")
        assert int(tstate.step) == i + 1


def test_train_step_updates_in_place_and_refuses_mesh_and_compress():
    _, tcfg = _cfgs("llama3.2-3b")
    state = TS.init_train_state(tcfg, 0, device="cpu")
    before = {n: t.clone() for n, t in _flat(state.params)}
    step = TS.make_train_step(tcfg, None, OptConfig(warmup_steps=0))
    tokens = torch.randint(0, tcfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    new, m = step(state, {"tokens": tokens})
    assert new.params is state.params and new.opt is state.opt
    assert any(not torch.equal(t, before[n]) for n, t in _flat(new.params))
    assert {"loss", "grad_norm", "lr", "nll", "accuracy",
            "tokens"} <= set(m)
    # a mesh is a DeviceMesh: anything else is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        TS.make_train_step(tcfg, object(), OptConfig())
    # compress=True refuses a state without an error-feedback state, and
    # trains one that has it, updating the error in place
    with pytest.raises(ValueError, match="error-feedback"):
        TS.make_train_step(tcfg, None, OptConfig(), compress=True)(
            new, {"tokens": tokens})
    cstate = TS.init_train_state(tcfg, 0, device="cpu", compress=True)
    err = TM.tree_leaves(cstate.ef_error)
    cnew, cm = TS.make_train_step(tcfg, None, OptConfig(warmup_steps=0),
                                  compress=True)(cstate, {"tokens": tokens})
    assert TM.tree_leaves(cnew.ef_error)[0] is err[0]
    assert any(e.any() for e in err) and np.isfinite(float(cm["loss"]))
    with pytest.raises(ValueError, match="microbatches"):
        TS.make_train_step(tcfg, None, OptConfig(), accum=3)(
            new, {"tokens": tokens})


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-3b", "recurrentgemma-9b"])
def test_remat_gives_the_same_gradients_bit_for_bit(jweights, arch):
    tokens = np.random.default_rng(4).integers(0, 512, (2, 24))
    grads = {}
    for remat in (False, True):
        _, tcfg = _cfgs(arch, remat=remat)
        grads[remat] = _torch_grads(
            tcfg, params_from_numpy(jweights[arch], "cpu"),
            tokens.astype(np.int32))
    assert grads[True][0] == grads[False][0]
    for name, g in grads[False][1].items():
        assert torch.equal(grads[True][1][name], g), name


def test_remat_keeps_no_grad_serving_unchanged(jweights):
    _, tcfg = _cfgs("llama3.2-3b", remat=True)
    tp = params_from_numpy(jweights["llama3.2-3b"], "cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, (1, 16)))
    with torch.no_grad():
        a, _ = TM.forward(tcfg, tp, {"tokens": tokens})
        b, _ = TM.forward(dataclasses.replace(tcfg, remat=False), tp,
                          {"tokens": tokens})
    assert torch.equal(a, b)
