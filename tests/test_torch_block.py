"""The port's plan-driven block (``registry.run_block``) against the JAX
package's, on ``llama3.2-3b.reduced()`` in fp32 with the same weights and
inputs: equal within rtol=atol=2e-5 under ``ftl_mode`` off, auto and
fused (the JAX side's fused MLP is its Pallas kernel in interpret mode),
and causal or not."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.core.ftl import executor_block as jexec  # noqa: E402
from repro.core.ftl import registry as jregistry  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.core.ftl import executor_block as texec  # noqa: E402
from repro_torch.core.ftl import registry as tregistry  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
M_TOKENS = 32


def _cfgs(mode, gated=True):
    over = dict(dtype="float32", remat=False, ftl_mode=mode,
                mlp_gated=gated)
    return (dataclasses.replace(jconfigs.get_config("llama3.2-3b").reduced(),
                                **over),
            dataclasses.replace(tconfigs.get_config("llama3.2-3b").reduced(),
                                **over))


def _layer(jcfg, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    dt = jnp.float32
    jp = {"ln1": jlayers.init_norm(jcfg.d_model, jcfg.norm, dt),
          "attn": jlayers.init_attention(jcfg, ks[0]),
          "ln2": jlayers.init_norm(jcfg.d_model, jcfg.norm, dt),
          "mlp": jlayers.init_mlp(jcfg, ks[1])}
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(d):
    return np.random.default_rng(1).standard_normal(
        (2, M_TOKENS, d)).astype(np.float32)


@pytest.mark.parametrize("target", ["tpu_v5e", "cpu_cache"])
@pytest.mark.parametrize("mode", ["off", "auto", "fused"])
@pytest.mark.parametrize("causal", [True, False])
def test_run_block_matches_reference(mode, causal, target):
    jcfg, tcfg = _cfgs(mode)
    jp, tp = _layer(jcfg)
    x = _x(jcfg.d_model)
    jplan = jregistry.plan_block(jcfg, m=M_TOKENS, dtype="float32",
                                 target=jhw.get_target(target))
    tplan = tregistry.plan_block(tcfg, m=M_TOKENS, dtype="float32",
                                 target=thw.get_target(target), device="cpu")
    assert tplan.chain.cuts() == jplan.chain.cuts()
    jy = jregistry.run_block(jplan, jp, jnp.asarray(x),
                             positions=jnp.arange(M_TOKENS), causal=causal)
    ty = tregistry.run_block(tplan, tp, torch.from_numpy(x),
                             positions=torch.arange(M_TOKENS), causal=causal)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("gated", [True, False])
def test_layer_path_matches_plan_path(gated):
    """block_layer without a plan (layer by layer) equals run_block."""
    jcfg, tcfg = _cfgs("auto", gated=gated)
    _, tp = _layer(jcfg)
    x = torch.from_numpy(_x(tcfg.d_model))
    pos = torch.arange(M_TOKENS)
    plan = tregistry.plan_block(tcfg, m=M_TOKENS, dtype="float32",
                                target=thw.CPU_CACHE, device="cpu")
    torch.testing.assert_close(
        tlayers.block_layer(tcfg, tp, x, positions=pos, plan=plan),
        tlayers.block_layer(tcfg, tp, x, positions=pos), **TOL)


@pytest.mark.parametrize("mode", ["off", "auto", "fused", "scan"])
def test_resolved_executors_on_cpu_mirror_the_reference(mode):
    """On the CPU the port resolves each stage to the counterpart of the
    executor the JAX package resolves (pallas_* → cuda_*, xla_* →
    torch_*)."""
    jcfg, tcfg = _cfgs(mode)
    t = "tpu_v5e"
    jplan = jregistry.plan_block(jcfg, m=M_TOKENS, dtype="float32",
                                 target=jhw.get_target(t))
    tplan = tregistry.plan_block(tcfg, m=M_TOKENS, dtype="float32",
                                 target=thw.get_target(t), device="cpu")
    rename = {"pallas_": "cuda_", "xla_": "torch_"}
    want = {}
    for k, v in jexec.resolved_executors(jplan).items():
        for a, b in rename.items():
            v = v.replace(a, b, 1) if v.startswith(a) else v
        want[k] = v
    assert texec.resolved_executors(tplan) == want


def test_stale_cuda_bindings_requalify_on_cpu():
    """A plan made for the card runs on CPU tensors: every cuda_* binding
    requalifies to the torch executor for its kind."""
    _, tcfg = _cfgs("auto")
    _, tp = _layer(_cfgs("auto")[0])
    plan = tregistry.plan_block(dataclasses.replace(tcfg, dtype="bfloat16"),
                                m=M_TOKENS, target=thw.H100, device="cuda")
    assert plan.platform == "cuda"
    x = torch.from_numpy(_x(tcfg.d_model))
    y = tregistry.run_block(plan, tp, x, positions=torch.arange(M_TOKENS))
    ref = tlayers.block_layer(tcfg, tp, x, positions=torch.arange(M_TOKENS))
    torch.testing.assert_close(y, ref, **TOL)
