"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun``: the cells and their skip reasons,
the accumulation depth on both production meshes, the ``--opt``
rewrites, and reduced configs traced end to end on a fake 2 x 2 mesh.

The reference's module sets a 512-device XLA flag when it is imported,
and the port's sets up a fake process group: both run in subprocesses,
so that neither reaches this test process.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, production_layout  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _run(code: str, timeout: int = 300) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


_REFERENCE = """
import json
from repro.launch.dryrun import _accum_for, all_cells, cell_status
from repro.configs import get_config, get_shape
from repro.launch.mesh import make_production_mesh
meshes = {mp: make_production_mesh(multi_pod=mp) for mp in (False, True)}
accum = {f"{a}/{s}/{mp}": _accum_for(get_config(a), get_shape(s), m)
         for a, s, _ in all_cells() for mp, m in meshes.items()}
print(json.dumps({"cells": all_cells(), "accum": accum}))
"""


@pytest.fixture(scope="module")
def reference():
    return json.loads(_run(_REFERENCE))


def test_cells_equal_the_reference(reference):
    cells = dryrun.all_cells()
    # the same cells and skip strings, each registry in its own arch order
    assert sorted(list(c) for c in cells) == sorted(reference["cells"])
    assert len(cells) == 40
    assert sum(c[2] == "run" for c in cells) == 32
    assert all(c[1] == "long_500k" for c in cells if c[2] != "run")
    assert dryrun.cell_status("xlstm-1.3b", "long_500k") == "run"
    assert dryrun.cell_status("qwen2-72b", "long_500k").startswith("skip")


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_accum_equals_the_reference(reference, arch, multi_pod):
    mesh = AbstractMesh(*production_layout(multi_pod=multi_pod))
    for shape in tconfigs.SHAPES:
        got = dryrun._accum_for(tconfigs.get_config(arch),
                                tconfigs.get_shape(shape), mesh)
        assert got == reference["accum"][f"{arch}/{shape}/{multi_pod}"]


_OPT = """
from repro_torch.launch.dryrun import apply_opt_level
from repro_torch.configs import get_config
from repro_torch.kernels.ops import _PLAIN_ATTN
cfg3 = apply_opt_level(get_config('yi-6b'), False)
assert cfg3.moe_dispatch == 'scatter'
assert _PLAIN_ATTN['mode'] == 'naive', _PLAIN_ATTN
cfg = apply_opt_level(get_config('moonshot-v1-16b-a3b'), True)
assert cfg.moe_dispatch == 'grouped', cfg.moe_dispatch
assert cfg.moe_groups == 16
cfg2 = apply_opt_level(get_config('xlstm-1.3b'), True)
assert cfg2.mlstm_chunk == 256
assert _PLAIN_ATTN['mode'] == 'blockwise' and _PLAIN_ATTN['min_len'] == 8192
print('OK')
"""


def test_opt_level_rewrites_as_the_reference():
    assert _run(_OPT) == "OK"


_LOWER = """
import json
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.core import hw
from repro_torch.launch.dryrun import lower_cell
import torch.distributed as dist
hw.set_default_target('h100')
arch = %r
shapes = {"train": ShapeSpec("t", "train", 16, 4),
          "prefill": ShapeSpec("p", "prefill", 16, 4),
          "decode": ShapeSpec("d", "decode", 32, 4)}
out = {}
for kind, shape in shapes.items():
    out[kind] = lower_cell(arch, shape.name, cfg=get_config(arch).reduced(),
                           shape=shape, layout=((2, 2), ("data", "model")))
    assert not dist.is_initialized()
print(json.dumps(out))
"""


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-moe-a2.7b",
                                  "xlstm-1.3b"])
def test_lower_cell_traces_reduced_configs_on_a_fake_mesh(arch):
    recs = json.loads(_run(_LOWER % arch, timeout=600))
    for kind, rec in recs.items():
        assert rec["kind"] == kind and rec["chips"] == 4
        assert rec["mesh"] == "2x2"
        assert rec["ftl_target"] == "h100"
        assert rec["roofline"]["target"] == "h100"
        assert rec["cost"]["flops_per_chip"] > 0
        assert rec["cost"]["bytes_per_chip"] > 0
        assert 0 < rec["cost"]["matmul_flops_per_chip"] \
            <= rec["cost"]["flops_per_chip"]
        mem = rec["memory"]
        assert mem["argument_size_in_bytes"] > 0
        assert mem["peak_bytes"] == mem["argument_size_in_bytes"] \
            + mem["temp_size_in_bytes"]
        assert rec["roofline"]["mfu_bound"] <= 1
        assert rec["collectives"]["by_kind"]["all-gather"] > 0
    train = recs["train"]
    # accumulation over 2 microbatches: gradients reduce-scattered over
    # data, the loss all-reduced; AdamW's moments updated in place
    assert train["collectives"]["by_kind"]["reduce-scatter"] > 0
    assert train["collectives"]["by_kind"]["all-reduce"] > 0
    assert train["memory"]["alias_size_in_bytes"] > 0


_LOOP = """
import json
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch.dryrun import _trace, fake_mesh
cfg = get_config(%r).reduced()
shape = ShapeSpec("t", "train", %d, %d)
with fake_mesh((2, 2), ("data", "model")) as mesh:
    full = _trace(cfg, shape, mesh, unrolled=True)
    priced = _trace(cfg, shape, mesh)
print(json.dumps({"full": full, "priced": priced}))
"""


@pytest.mark.parametrize("arch,seq,batch", [("llama3.2-3b", 16, 8),
                                            ("recurrentgemma-9b", 8, 4),
                                            ("xlstm-1.3b", 8, 4)])
def test_loops_priced_as_unrolled(arch, seq, batch):
    """Traced whole, llama's 4 microbatches give every count that 2 and 3
    give by the loop rule; the recurrences' time loops of 8 steps give
    every count that four steps give: the RG-LRU scan and its plain
    backward, the mLSTM scan and its backward's checkpointed chunks, the
    sLSTM under autograd and remat."""
    got = json.loads(_run(_LOOP % (arch, seq, batch), timeout=600))
    full, priced = got["full"], got["priced"]
    assert full["ops"]["mm"] > 0
    print(f"{arch}: peak {priced['peak_bytes']} priced, "
          f"{full['peak_bytes']} unrolled")
    # the peak within a step's locals (tests/test_torch_roofline.py,
    # PEAK_RTOL); every other count exact
    assert priced["peak_bytes"] == pytest.approx(full["peak_bytes"],
                                                 rel=0.05, abs=0)
    for k in ("peak_bytes", "temp_size_in_bytes"):
        del priced[k], full[k]
    assert priced == full
