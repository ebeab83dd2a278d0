"""The port's sharding rules against the JAX package's, with no devices.

The reference's rule engine runs on ``jax.sharding.AbstractMesh``, the
port's on its own ``repro_torch.launch.mesh.AbstractMesh``; both take
the parameter shapes without allocating (``param_shapes``: the
reference's ``jax.eval_shape``, the port's ``meta`` tensors).

* ``param_pspecs`` leaf by leaf for every config in ``configs.ARCHS`` on
  the production meshes 16x16 and 2x16x16 and on 2x4, 1x2 and 4x1.
* ``cache_pspecs`` at the decode shape 128 x 32,768 (full configs) and
  4 x 64 (reduced), and ``batch_pspecs``.
* Every activation kind's spec against the one the reference's policy
  hands ``jax.lax.with_sharding_constraint`` (captured with
  ``monkeypatch``), on three meshes and at shapes that divide and do not.
* ``count_params`` exactly, and each leaf's shard shape on 2x4 against
  the reference's ``NamedSharding(...).shard_shape``.
* ``state_pspecs``, ``train_step_shardings`` and ``decode_shardings``
  (the specs of every sharding they return) on 16x16 and 2x16x16.
* ``to_placements``: a spec's DTensor placements, a two-axis entry in
  the mesh's order, and the refusals.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import steps as JS  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import sharding as TSH  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}
ARCHS = list(jconfigs.ARCHS)


def _meshes(name):
    shape, axes = MESHES[name]
    return JAbstractMesh(shape, axes), AbstractMesh(shape, axes)


def _flat(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + k + "/")
        else:
            yield pre + k, v


def _jflat(tree):
    """The reference's spec tree by path, PartitionSpecs as tuples."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(k.key) for k in p): tuple(s) for p, s in leaves}


@functools.lru_cache(maxsize=None)
def _shapes(arch, reduced=False):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    return jcfg, tcfg, JM.param_shapes(jcfg), TM.param_shapes(tcfg)


def test_configs_agree():
    assert sorted(tconfigs.ARCHS) == sorted(ARCHS) and len(ARCHS) == 10


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, mesh):
    jcfg, tcfg, jshape, tshape = _shapes(arch)
    jm, tm = _meshes(mesh)
    want = _jflat(JSH.param_pspecs(jshape, jm, jcfg))
    got = {k: tuple(v) for k, v in _flat(TSH.param_pspecs(tshape, tm,
                                                          tcfg))}
    assert set(got) == set(want)
    for name, spec in want.items():
        assert got[name] == spec, (name, got[name], spec)
    # the production meshes do shard something of every config
    if mesh in ("16x16", "2x16x16"):
        assert any(any(e is not None for e in s) for s in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_reference(arch):
    jcfg, tcfg, _, tshape = _shapes(arch)
    assert TM.count_params(tcfg) == JM.count_params(jcfg)
    assert all(t.device.type == "meta" for t in TM.tree_leaves(tshape))


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shapes_on_2x4_match_reference(arch):
    jcfg, tcfg, jshape, tshape = _shapes(arch)
    jm, tm = _meshes("2x4")
    jspecs = JSH.param_pspecs(jshape, jm, jcfg)
    want = {p: JNamedSharding(jm, JP(*s)).shard_shape(tuple(
        dict(_flat(tshape))[p].shape)) for p, s in _jflat(jspecs).items()}
    for name, spec in _flat(TSH.param_pspecs(tshape, tm, tcfg)):
        shape = tuple(dict(_flat(tshape))[name].shape)
        got = TSH.NamedSharding(tm, spec).shard_shape(shape)
        assert got == tuple(want[name]), name


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_pspecs_match_reference(arch, reduced):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    b, s = (4, 64) if reduced else (128, 32768)
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, b, s))
    tcache = TM.init_cache(tcfg, b, s, device="meta")
    for mesh in ("16x16", "2x16x16", "2x4"):
        jm, tm = _meshes(mesh)
        want = _jflat(JSH.cache_pspecs(jcache, jm, jcfg))
        got = {k: tuple(v) for k, v in _flat(TSH.cache_pspecs(tcache, tm,
                                                              tcfg))}
        assert got == want, mesh
        batch = {"tokens": jax.ShapeDtypeStruct((b, s), np.int32),
                 "frames": jax.ShapeDtypeStruct((b, 7, 3), np.float32)}
        want_b = {k: tuple(v) for k, v in
                  JSH.batch_pspecs(batch, jm).items()}
        got_b = {k: tuple(v) for k, v in TSH.batch_pspecs(batch, tm).items()}
        assert got_b == want_b


KINDS = {"residual": 3, "ffn_hidden": 3, "logits": 3, "heads_q": 4,
         "heads_kv": 4, "kv_cache": 4, "moe_buf": 3, "moe_hidden": 3,
         "moe_gbuf": 4, "moe_ghidden": 4, "moe_gout": 4, "rec_state": 2,
         "unknown_kind": 3}


class _Shape:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "2x4"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_activation_specs_match_reference_policy(monkeypatch, kind, mesh):
    jm, tm = _meshes(mesh)
    captured = []
    monkeypatch.setattr(JSH, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: captured.append(tuple(spec)) or x)
    policy = JSH.make_activation_policy(jm, None)
    for dims in ((64, 32, 48, 96), (3, 5, 6, 7), (32, 60, 8, 2048)):
        shape = dims[:KINDS[kind]]
        captured.clear()
        x = _Shape(shape)
        assert policy(x, kind) is x
        got = TSH.activation_spec(kind, shape, tm)
        if not captured:
            assert got is None
        else:
            assert tuple(got) == captured[0], (shape, got, captured)


def test_port_policy_passes_local_tensors_through():
    policy = TSH.make_activation_policy(AbstractMesh((2, 4),
                                                     ("data", "model")), None)
    x = torch.ones(4, 3, 8)
    assert policy(x, "residual") is x


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    tm = AbstractMesh((2, 4, 8), ("pod", "data", "model"))
    assert TSH.to_placements(TSH.P(("pod", "data"), None, "model"), tm) == (
        Shard(0), Shard(0), Shard(2))
    assert TSH.to_placements(TSH.P(None, None), tm) == (
        Replicate(), Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        TSH.to_placements(TSH.P(("data", "pod")), tm)
    with pytest.raises(ValueError, match="two dims"):
        TSH.to_placements(TSH.P("data", "data"), tm)
    sh = TSH.NamedSharding(tm, TSH.P(("pod", "data"), "model"))
    assert sh.shard_shape((16, 24)) == (2, 3)
    with pytest.raises(ValueError, match="split"):
        sh.shard_shape((6, 24))


def _specs(tree):
    """Spec of every sharding in a tree (dicts, train states, tuples), by
    path, the reference's and the port's alike."""
    if isinstance(tree, (JNamedSharding, TSH.NamedSharding)):
        return {"": tuple(tree.spec)}
    if isinstance(tree, (JP, TSH.P)):
        return {"": tuple(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = enumerate(tree)
    else:                               # a train state
        items = ((f, getattr(tree, f)) for f in
                 ("params", "opt", "step", "ef_error"))
    out = {}
    for k, v in items:
        if v is not None:
            out.update({f"{k}/{p}": s for p, s in _specs(v).items()})
    return out


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-moe-a2.7b",
                                  "recurrentgemma-9b"])
def test_step_shardings_match_reference(arch, mesh):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jm, tm = _meshes(mesh)
    jstate = JS.train_state_shapes(jcfg, compress=True)
    tstate = TS.train_state_shapes(tcfg, compress=True)
    batch = {"tokens": jax.ShapeDtypeStruct((512, 4096), np.int32)}
    want = _specs(JS.train_step_shardings(jcfg, jm, jstate, batch))
    got = _specs(TS.train_step_shardings(tcfg, tm, tstate, batch))
    assert got == want
    assert _specs(TS.state_pspecs(tstate, tm, tcfg)) == _specs(
        JS.state_pspecs(jstate, jm, jcfg))
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, 128, 32768))
    tcache = TM.init_cache(tcfg, 128, 32768, device="meta")
    want = _specs(JS.decode_shardings(jcfg, jm, JM.param_shapes(jcfg),
                                      jcache, 128))
    got = _specs(TS.decode_shardings(tcfg, tm, TM.param_shapes(tcfg),
                                     tcache, 128))
    assert got == want
