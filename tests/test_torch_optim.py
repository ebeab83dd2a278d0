"""The port's AdamW against the JAX package's, on the CPU in fp32.

``lr_schedule`` over warmup, decay and floor; ``global_norm`` and the set
of leaf paths that take weight decay on the parameter trees of the four
served configs (reduced); ``adamw_update`` given the same numpy
gradients, moments and parameters at steps 0, 1 and 50: new parameters,
``m`` and ``v`` within rtol = atol = 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

ARCHS = ["llama3.2-3b", "granite-20b", "recurrentgemma-9b", "xlstm-1.3b"]
TOL = dict(rtol=1e-6, atol=1e-6)


def _flat(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, (*pre, k))
        else:
            yield (*pre, k), v


@pytest.fixture(scope="module")
def trees():
    """Each reduced config's JAX parameter tree, as numpy."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = jconfigs.get_config(arch).reduced()
        out[arch] = jax.tree.map(np.asarray,
                                 JM.init_params(cfg, jax.random.PRNGKey(i)))
    return out


@pytest.mark.parametrize("opt", [
    dict(peak_lr=1e-3, warmup_steps=10, decay_steps=100),
    dict(peak_lr=3e-4, warmup_steps=0, decay_steps=50, min_lr_ratio=0.0),
    dict(peak_lr=2e-2, warmup_steps=7, decay_steps=7)])
def test_lr_schedule_matches_reference(opt):
    jcfg, tcfg = jadamw.OptConfig(**opt), tadamw.OptConfig(**opt)
    for step in (0, 1, 3, 6, 7, 8, 10, 11, 30, 49, 50, 51, 99, 100, 150):
        want = float(jadamw.lr_schedule(jnp.int32(step), jcfg))
        got = tadamw.lr_schedule(torch.tensor(step, dtype=torch.int32),
                                 tcfg)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_global_norm_matches_reference(trees, arch):
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, trees[arch])))
    got = tadamw.global_norm(params_from_numpy(trees[arch], "cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_decayed_leaf_paths_match_reference(trees, arch):
    want = set()

    def mark(path, leaf):
        if jadamw._decay_mask(path):
            want.add(tuple(str(k.key) for k in path))
        return leaf

    jax.tree_util.tree_map_with_path(mark, trees[arch])
    got = {path for path, _ in _flat(trees[arch])
           if tadamw._decay_mask(path)}
    assert got == want
    # and some leaves of each kind exist: weights decay, norms do not
    assert got and len(got) < len(list(_flat(trees[arch])))


def _state(tree, seed):
    """Random fp32 gradients and moments shaped like ``tree``."""
    rng = np.random.default_rng(seed)
    like = lambda scale: {  # noqa: E731
        path: (rng.standard_normal(a.shape) * scale).astype(np.float32)
        for path, a in _flat(tree)}
    g, m, v = like(0.3), like(0.05), like(0.01)
    v = {k: x * x for k, x in v.items()}
    return g, m, v


def _nest(flat):
    out = {}
    for path, a in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = a
    return out


@pytest.mark.parametrize("step", [0, 1, 50])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "recurrentgemma-9b"])
def test_adamw_update_matches_reference(trees, arch, step):
    cfg = dict(peak_lr=1e-2, warmup_steps=10, decay_steps=100,
               weight_decay=0.1, grad_clip=1.0)
    g, m, v = _state(trees[arch], step)
    jp, jm, jmet = jadamw.adamw_update(
        jax.tree.map(jnp.asarray, _nest(g)),
        {"m": jax.tree.map(jnp.asarray, _nest(m)),
         "v": jax.tree.map(jnp.asarray, _nest(v))},
        jax.tree.map(jnp.asarray, trees[arch]), jnp.int32(step),
        jadamw.OptConfig(**cfg))
    tp = params_from_numpy(trees[arch], "cpu")
    topt = {"m": params_from_numpy(_nest(m), "cpu"),
            "v": params_from_numpy(_nest(v), "cpu")}
    tp2, topt2, tmet = tadamw.adamw_update(
        params_from_numpy(_nest(g), "cpu"), topt, tp,
        torch.tensor(step, dtype=torch.int32), tadamw.OptConfig(**cfg))
    assert tp2 is tp and topt2 is topt          # updated in place
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)
    for tree_t, tree_j in ((tp2, jp), (topt2["m"], jm["m"]),
                           (topt2["v"], jm["v"])):
        jflat = dict(_flat(jax.tree.map(np.asarray, tree_j)))
        for path, t in _flat(tree_t):
            np.testing.assert_allclose(t.numpy(), jflat[path], **TOL,
                                       err_msg=str(path))


def test_adamw_keeps_the_parameter_dtype_and_clips():
    params = {"w": torch.zeros(4, dtype=torch.bfloat16),
              "ln1": {"scale": torch.ones(4, dtype=torch.bfloat16)}}
    grads = {"w": torch.full((4,), 1e6), "ln1": {"scale": torch.zeros(4)}}
    opt = tadamw.init_opt_state(params)
    assert all(t.dtype == torch.float32 for _, t in _flat(opt["m"]))
    cfg = tadamw.OptConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=1,
                           weight_decay=0.5)
    p, _, met = tadamw.adamw_update(grads, opt, params,
                                    torch.tensor(5), cfg)
    assert p["w"].dtype == torch.bfloat16
    assert float(met["grad_norm"]) > 1e5        # reported before clipping
    # zero gradient + decay: a norm's scale does not shrink
    assert float(p["ln1"]["scale"][0]) == 1.0


def test_init_opt_state_matches_param_tree(trees):
    tp = params_from_numpy(trees["xlstm-1.3b"], "cpu")
    opt = tadamw.init_opt_state(tp)
    shapes = lambda t: {k: v.shape for k, v in _flat(t)}  # noqa: E731
    assert shapes(opt["m"]) == shapes(opt["v"]) == shapes(tp)
    assert all(float(v.abs().sum()) == 0 for _, v in _flat(opt["v"]))
    assert TM.tree_leaves(opt["m"])[0].dtype == torch.float32


def test_opt_config_defaults_match_reference():
    assert dataclasses.asdict(tadamw.OptConfig()) == \
        dataclasses.asdict(jadamw.OptConfig())
