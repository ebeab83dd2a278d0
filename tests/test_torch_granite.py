"""granite-20b in the port against the JAX package.

``granite-20b.reduced()`` in fp32 (4 layers, d_model 128, MQA 4/1, an
ungated tanh-gelu MLP with biases, qkv and output-projection biases,
layernorm): the JAX ``init_params`` tree with its zero biases and unit
norm scales redrawn from numpy goes through ``params_from_numpy``, so
every bias and the layernorm's shift take part.  ``forward`` agrees
within rtol=atol=2e-5 under ``ftl_mode`` off and auto (the plan-driven
block is held in ``tests/test_torch_block.py``); the serving engine's greedy tokens equal the JAX engine's, paged and
dense; MQA at granite's 48 query heads per KV head agrees in the flash
path, the masked decode attention and the paged pool.  On the ``h100``
target the planner binds ``cuda_partial_mlp`` at every prefill bucket of
the full-width config, never for a gated MLP and never at decode.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.core.ftl import executor_block  # noqa: E402
from repro_torch.core.ftl import registry as tregistry  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
ARCH = "granite-20b"


def _cfgs(mode="off", **over):
    over = dict(remat=False, ftl_mode=mode, **over)
    return (dataclasses.replace(jconfigs.get_config(ARCH).reduced(), **over),
            dataclasses.replace(tconfigs.get_config(ARCH).reduced(), **over))


def _redraw(tree, rng):
    """Every bias, norm scale and norm shift redrawn (the initializers
    give zeros and ones, which would hide a bias the port drops)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw(v, rng)
        elif k in ("b", "bias"):
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        elif k == "scale":
            out[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


def _weights(jcfg, seed=0):
    """(jax tree, numpy tree) of one set of weights."""
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    npp = _redraw(jax.tree.map(np.asarray, jp), np.random.default_rng(seed))
    return jax.tree.map(jnp.asarray, npp), npp


@pytest.fixture(scope="module")
def weights():
    return _weights(_cfgs()[0])


@pytest.fixture(autouse=True)
def same_target():
    jhw.set_default_target("cpu_cache")
    thw.set_default_target("cpu_cache")
    yield
    jhw.set_default_target(None)
    thw.set_default_target(None)


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(2, vocab, size=(b, s))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_config_is_the_reference_copy():
    j, t = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.d_ff) == \
        (52, 6144, 48, 1, 24576)
    assert not t.mlp_gated and t.mlp_bias and t.qkv_bias \
        and t.norm == "layernorm"


def test_param_tree_matches_reference(weights):
    _, npp = weights
    _, tcfg = _cfgs()
    tp = TM.init_params(tcfg, 0, device="cpu")
    shapes = lambda t: {k: tuple(v.shape)  # noqa: E731
                        for k, v in _flatten(t)}
    assert shapes(tp) == shapes(npp)
    layer = tp["layers"]["pos0"]
    for name in ("wq", "wk", "wv", "wo"):
        assert "b" in layer["attn"][name]
    assert "bias" in layer["ln1"] and "wg" not in layer["mlp"]


def _flatten(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, pre + k + ".")
        else:
            yield pre + k, v


@pytest.mark.parametrize("heads", [4, 48])
@pytest.mark.parametrize("mode", ["off", "auto"])
def test_forward_matches_reference(mode, heads):
    """Logits, with MQA at 4 and at granite's 48 query heads a KV head."""
    jcfg, tcfg = _cfgs(mode, n_heads=heads,
                       head_dim=32 if heads == 4 else 8)
    jp, npp = _weights(jcfg, seed=heads)
    toks = _tokens(2, 16, jcfg.vocab_size)
    jl, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, _ = TM.forward(tcfg, params_from_numpy(npp, "cpu"),
                       {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_prefill_and_decode_match_reference(weights, mode):
    jp, npp = weights
    tp = params_from_numpy(npp, "cpu")
    jcfg, tcfg = _cfgs(mode)
    toks = _tokens(2, 16, jcfg.vocab_size, seed=1)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_seq=32,
                        last_pos=jnp.int32(10))
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                        max_seq=32, last_pos=10)
    _close(tl, jl)
    pos, nxt = np.array([11, 16]), np.array([[5], [7]])
    for _ in range(2):
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(nxt), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(nxt), tc,
                                torch.from_numpy(pos))
        _close(tl, jl)
        _close(tc["layers"]["pos0"]["v"], jc["layers"]["pos0"]["v"])
        nxt = np.array(jnp.argmax(jl[:, 0], -1))[:, None]
        pos = pos + 1


def test_layernorm_with_bias_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(64)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(64)).astype(np.float32)}
    want = jlayers.norm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), "layernorm")
    got = tlayers.norm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), "layernorm")
    _close(got, want)


def test_mqa_48_heads_attention_matches_reference():
    """48 query heads on one KV head: the flash path (its plain version
    on the CPU) against the Pallas kernel in interpret mode, and the
    masked decode attention against the reference's."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 48, 32, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, 1, 32, 64)).astype(np.float32)
            for _ in range(2))
    want = jflash(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                  block_q=16, block_k=16, interpret=True)
    got = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=True)
    _close(got, want)
    qd = q[:, :, :1]
    kd, vd = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)  # (B,S,Hk,D)
    mask = np.arange(32) < 20
    want = jlayers.masked_decode_attention(
        *(jnp.asarray(a) for a in (qd, kd, vd, mask)))
    got = tlayers.masked_decode_attention(
        *(torch.from_numpy(a) for a in (qd, kd, vd, mask)))
    _close(got, want)


def _prompts(vocab, lens=(5, 13, 8, 20), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("heads", [4, 48])
def test_greedy_tokens_match_reference(paged, heads):
    """The engine under the CLI's mode for granite (``'auto'``), with the
    paged pool holding one KV head."""
    jcfg, tcfg = _cfgs(TS.serving_ftl_mode(tconfigs.get_config(ARCH)),
                       n_heads=heads, head_dim=32 if heads == 4 else 8)
    jp, npp = _weights(jcfg, seed=7)
    prompts = _prompts(jcfg.vocab_size)
    jeng = JS.ServeEngine(jcfg, jp, batch_slots=2, max_seq=32, eos_id=-1,
                          target=jhw.CPU_CACHE, paged=paged)
    jout = {r.rid: r.out for r in jeng.run(
        [JS.Request(i, p, 5) for i, p in enumerate(prompts)], {})}
    teng = TS.ServeEngine(tcfg, params_from_numpy(npp, "cpu"),
                          batch_slots=2, max_seq=32, eos_id=-1,
                          target=thw.CPU_CACHE, paged=paged, device="cpu")
    assert teng.paged == paged
    tout = {r.rid: r.out for r in teng.run(
        [TS.Request(i, p, 5) for i, p in enumerate(prompts)])}
    assert tout == jout
    assert all(len(v) == 5 for v in tout.values())


def test_serving_mode_rule():
    """``'auto'`` for the ungated MLP, ``'fused'`` for the gated ones."""
    assert TS.serving_ftl_mode(tconfigs.get_config(ARCH)) == "auto"
    for arch in ("llama3.2-3b", "recurrentgemma-9b"):
        assert TS.serving_ftl_mode(tconfigs.get_config(arch)) == "fused"


def test_cli_runs_on_cpu(capsys):
    TS.main(["--arch", ARCH, "--reduced", "--device", "cpu",
             "--requests", "3", "--slots", "2", "--prompt-len", "8",
             "--max-new", "3", "--max-seq", "32", "--target", "h100"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "0 decode replans" in out
    # a CPU run resolves the plan's kernel bindings to the torch executors
    assert "'mlp': 'torch_partial_scan_mlp'" in out


# ---------------------------------------------------------------------------
# the planner on the h100 target, full width
# ---------------------------------------------------------------------------

def _full(mode="auto"):
    return dataclasses.replace(tconfigs.get_config(ARCH), ftl_mode=mode)


@pytest.mark.parametrize("m", TM.PREFILL_BUCKETS)
def test_h100_prefill_binds_the_partial_kernels(m):
    _, plan = TM.serve_plan(_full(), m=m, target=thw.H100, device="cuda")
    assert plan.mlp_schedule == "partial"
    assert {b.kind: b.executor for b in plan.bindings}["mlp"] == \
        "cuda_partial_mlp"
    assert executor_block.resolved_executors(plan) == {
        "gemm": "cuda_gemm", "attention": "cuda_flash_attention",
        "mlp": "cuda_partial_mlp"}


def test_h100_decode_plan_binds_the_torch_partial_scan():
    _, plan = TM.serve_plan(_full(), m=1, target=thw.H100, phase="decode",
                            device="cuda")
    assert executor_block.resolved_executors(plan)["mlp"] == \
        "torch_partial_scan_mlp"
    assert all(not b.executor.startswith("cuda_") for b in plan.bindings)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "recurrentgemma-9b"])
def test_gated_mlp_never_binds_the_partial_kernels(arch):
    cfg = dataclasses.replace(tconfigs.get_config(arch), ftl_mode="auto")
    for m in (8, 256, 2048):
        plan = tregistry.plan_block(cfg, m=m, target=thw.H100,
                                    device="cuda")
        assert executor_block.resolved_executors(plan)["mlp"] != \
            "cuda_partial_mlp"
    ctx = tregistry.ExecContext(kind="mlp", platform="cuda",
                                schedule="partial", gated=True,
                                target=thw.H100)
    assert tregistry.find("mlp", ctx).name == "torch_partial_scan_mlp"


@pytest.mark.parametrize("change,binds", [
    ({}, True),
    ({"dtype": "float32"}, False),
    ({"phase": "decode"}, False),
    ({"platform": "cpu"}, False),
    ({"schedule": "fused"}, False),
    ({"target": thw.CPU_CACHE}, True),
])
def test_partial_executor_qualification(change, binds):
    ctx = tregistry.ExecContext(**{
        **dict(kind="mlp", platform="cuda", schedule="partial", m=2048,
               d_model=6144, d_ff=24576, gated=False, target=thw.H100),
        **change})
    assert tregistry.get("cuda_partial_mlp").qualifies(ctx) == binds


def test_partial_executor_needs_its_tiles_in_the_fast_level():
    tiny = dataclasses.replace(thw.H100, levels=(
        dataclasses.replace(thw.H100.fast, capacity_bytes=32 << 10),
        *thw.H100.backing))
    ctx = tregistry.ExecContext(kind="mlp", platform="cuda",
                                schedule="partial", target=tiny)
    assert not tregistry.get("cuda_partial_mlp").qualifies(ctx)
