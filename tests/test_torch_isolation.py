"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports jax or the JAX package, and the entry points
never carry on quietly on the CPU when no card is there."""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch.serve import ServeEngine  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_pulls_no_jax_and_no_repro():
    mods = list(_modules())
    assert "repro_torch.launch.serve" in mods
    # the planner tooling's subpackages are walked too
    assert {"repro_torch.sim", "repro_torch.sim.des", "repro_torch.calib",
            "repro_torch.calib.fit", "repro_torch.calib.measure",
            "repro_torch.tune", "repro_torch.tune.autotune",
            "repro_torch.obs.export", "repro_torch.obs.drift"} <= set(mods)
    # and the distributed layer's
    assert {"repro_torch.distributed", "repro_torch.distributed.sharding",
            "repro_torch.distributed.act_sharding",
            "repro_torch.distributed.compression",
            "repro_torch.distributed.pipeline",
            "repro_torch.distributed.mesh_capture",
            "repro_torch.distributed.collectives",
            "repro_torch.launch.mesh"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_importing_obs_pulls_no_torch():
    """The telemetry package (its drift monitor reads ``calib.measure``)
    imports torch only where a measurement runs."""
    code = ("import sys, repro_torch.obs, repro_torch.calib\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_names(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py",
                                  *sorted(PKG.rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_repro(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("llama3.2-3b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(cfg, 0)
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, batch_slots=1, max_seq=16)
