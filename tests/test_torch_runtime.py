"""The port's training runtime: data, checkpoints, the loop, the monitors
and the launcher, modelled on the reference's ``tests/test_data.py``,
``test_ckpt.py``, ``test_runtime.py`` and ``test_launchers.py``.

* ``SyntheticLM.batch_at(i)`` gives the reference's bits for both kinds.
* A checkpoint of a bf16 + fp32 ``TrainState`` round-trips bit for bit
  (bf16 leaves travel as their uint16 bits, the manifest says
  ``bfloat16``).
* ``TrainLoop`` resumes from a checkpoint, and a preempted run, resumed,
  ends on the same state as an unbroken one.
* ``python -m repro_torch.launch.train ... --device cpu`` runs, resumes
  and prints ``final: step N``; without ``--device`` on a host with no
  card it raises.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import pipeline as jpipe  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.ckpt import CheckpointManager, restore_tree  # noqa: E402
from repro_torch.ckpt import save_tree  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.runtime import LoopConfig, TrainLoop  # noqa: E402
from repro_torch.runtime.monitor import (  # noqa: E402
    HeartbeatMonitor, StragglerMonitor)
from repro_torch.train import steps as TS  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bigram", "random"])
def test_batches_match_reference_bit_for_bit(kind):
    kw = dict(vocab_size=512, global_batch=4, seq_len=33, seed=7, kind=kind)
    jd = jpipe.SyntheticLM(jpipe.DataConfig(**kw), process_index=0,
                           process_count=1)
    td = tpipe.SyntheticLM(tpipe.DataConfig(**kw))
    for i in range(3):
        want, got = jd.batch_at(i)["tokens"], td.batch_at(i)["tokens"]
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)
    assert td.optimal_nll() == jd.optimal_nll()


def test_host_shards_and_prefetch_match_batch_at():
    cfg = tpipe.DataConfig(vocab_size=97, global_batch=4, seq_len=9)
    full = tpipe.SyntheticLM(cfg).batch_at(2)["tokens"]
    halves = [tpipe.SyntheticLM(cfg, process_index=i, process_count=2)
              .batch_at(2)["tokens"] for i in range(2)]
    assert np.array_equal(np.concatenate(halves), full)
    it = tpipe.SyntheticLM(cfg).iterate(start_step=1)
    for i in range(1, 4):
        assert np.array_equal(next(it)["tokens"],
                              tpipe.SyntheticLM(cfg).batch_at(i)["tokens"])


def test_batch_shapes_allocate_nothing():
    cfg = tconfigs.get_config("llama3.2-3b")
    shape = type("S", (), {"global_batch": 8, "seq_len": 4096})()
    b = tpipe.make_batch_shapes(cfg, shape)
    assert b["tokens"].shape == (8, 4096) and b["tokens"].is_meta


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _bf16_state(seed=0):
    cfg = dataclasses.replace(tconfigs.get_config("llama3.2-3b").reduced(),
                              dtype="bfloat16")
    st = TS.init_train_state(cfg, seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for leaf in TM.tree_leaves(st.opt):
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    st.step.fill_(7)
    return st


def _flat(tree, pre=""):
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _flat(getattr(tree, f.name), pre + "." + f.name + "/")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, pre + k + "/")
    elif tree is not None:
        yield pre, tree


def _same(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("blocking", [True, False])
def test_train_state_round_trips_bit_for_bit(tmp_path, blocking):
    st = _bf16_state()
    assert st.params["embed"]["tok"].dtype == torch.bfloat16
    assert st.opt["m"]["embed"]["tok"].dtype == torch.float32
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(st, 7, blocking=blocking)
    mgr.wait()
    like = _bf16_state(seed=3)              # other values, same structure
    got, step = mgr.restore(like)
    assert step == 7 and isinstance(got, TS.TrainState)
    _same(got, st)
    man = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert man["step"] == 7
    assert man["shapes"][".params/embed/tok"][1] == "bfloat16"
    assert man["shapes"][".opt/m/embed/tok"][1] == "float32"
    assert man["shapes"][".step"] == [[], "int32"]


def test_async_save_copies_before_returning(tmp_path):
    st = {"w": torch.arange(6, dtype=torch.float32)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(st, 1, blocking=False)
    st["w"].add_(100.0)                      # training goes on in place
    mgr.wait()
    got, _ = mgr.restore({"w": torch.zeros(6)})
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32))


def test_save_tree_restore_tree(tmp_path):
    tree = {"a": torch.randn(3, 4).to(torch.bfloat16),
            "b": {"c": torch.arange(5, dtype=torch.int32)}}
    path = str(tmp_path / "t.npz")
    save_tree(path, tree)
    got = restore_tree(path, {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
                              "b": {"c": torch.zeros(5, dtype=torch.int32)}})
    _same(got, tree)


def test_latest_step_retention_and_partial_writes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (1, 2, 3):
        mgr.save({"x": torch.tensor(float(s))}, s)
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    os.makedirs(tmp_path / "step_9.tmp")    # a crashed write
    os.makedirs(tmp_path / "step_8")        # no manifest: never finished
    assert mgr.latest_step() == 3
    got, step = mgr.restore({"x": torch.tensor(0.0)})
    assert step == 3 and float(got["x"]) == 3.0


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore({"x": torch.zeros(1)})


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def _train_loop(ckpt_dir, total, *, ckpt_every=1000):
    cfg = tconfigs.get_config("llama3.2-3b").reduced()
    data = tpipe.SyntheticLM(tpipe.DataConfig(
        vocab_size=cfg.vocab_size, global_batch=2, seq_len=16, seed=1))
    step = TS.make_train_step(cfg, None, OptConfig(
        peak_lr=1e-2, warmup_steps=2, decay_steps=10), accum=2)
    return TrainLoop(
        LoopConfig(total_steps=total, ckpt_dir=ckpt_dir,
                   ckpt_every=ckpt_every, ckpt_async=False),
        step, lambda i: {"tokens": torch.from_numpy(
            data.batch_at(i)["tokens"])},
        TS.init_train_state(cfg, 0, device="cpu"))


def test_preempted_run_resumes_to_the_unbroken_state(tmp_path):
    loop = _train_loop(str(tmp_path), 6)
    orig = loop.step_fn

    def step_with_preempt(state, batch):
        if int(state.step) == 2:
            loop._preempted = True              # as SIGTERM's handler does
        return orig(state, batch)

    loop.step_fn = step_with_preempt
    loop.run()
    assert loop.ckpt.latest_step() == 3
    resumed = _train_loop(str(tmp_path), 6)
    final = resumed.run()
    assert int(final.step) == 6
    assert [m["step"] for m in resumed.metrics_log] == [4, 5, 6]
    unbroken = _train_loop(None, 6).run()
    _same(final, unbroken)


def test_loop_runs_to_completion_with_periodic_checkpoints(tmp_path):
    loop = _train_loop(str(tmp_path), 4, ckpt_every=2)
    seen = []
    loop.on_metrics = lambda s, m: seen.append(s)
    loop.cfg = dataclasses.replace(loop.cfg, log_every=2)
    state = loop.run()
    assert int(state.step) == 4 and len(loop.metrics_log) == 4
    assert seen == [2, 4]
    assert all(isinstance(v, float) for k, v in loop.metrics_log[0].items()
               if k != "step")
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_4"]


def test_straggler_monitor_flags_slow_step():
    mon = StragglerMonitor(threshold=3.0, warmup=3)
    for i in range(6):
        mon.start_step()
        time.sleep(0.01)
        mon.end_step(i)
    mon.start_step()
    time.sleep(0.2)
    stat = mon.end_step(6)
    assert stat.flagged and [s.step for s in mon.flagged_steps] == [6]
    assert mon.ema < 0.05


def test_heartbeat_stale_detection(tmp_path):
    h0 = HeartbeatMonitor(str(tmp_path), 0, timeout=0.2)
    h1 = HeartbeatMonitor(str(tmp_path), 1, timeout=0.2)
    h0.stamp()
    h1.stamp()
    assert h0.stale_peers() == []
    time.sleep(0.3)
    h0.stamp()
    assert h0.stale_peers() == [1]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _run(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)


def test_launcher_runs_on_the_cpu_and_resumes(tmp_path):
    base = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "32", "--log-every", "2"]
    p = _run(base + ["--steps", "4"])
    assert p.returncode == 0, p.stderr[-2000:]
    assert "final: step 4" in p.stdout
    assert "step      2 loss" in p.stdout
    assert "FTL block plan" in p.stderr
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
          "--heartbeat-dir", str(tmp_path / "hb")]
    p = _run(base + ck + ["--steps", "2"])
    assert p.returncode == 0, p.stderr[-2000:]
    p = _run(base + ck + ["--steps", "4", "--accum", "2"])
    assert p.returncode == 0, p.stderr[-2000:]
    assert "resumed from checkpoint step 2" in p.stderr
    assert "final: step 4" in p.stdout
    assert os.listdir(tmp_path / "hb") == ["proc_0"]


def test_launcher_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tlaunch.parser().parse_args(["--arch", "llama3.2-3b",
                                        "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.build(args)
    # a 2x2 mesh needs four processes: one, with no launcher, raises and
    # names the world size
    args = tlaunch.parser().parse_args(
        ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu", "--mesh",
         "2x2"])
    with pytest.raises(RuntimeError, match="world size 1"):
        tlaunch.build(args)
    # --compress builds a trainer that carries an error-feedback state
    args = tlaunch.parser().parse_args(
        ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
         "--compress"])
    loop = tlaunch.build(args)
    assert loop.mesh is None and loop.state.ef_error is not None
    assert all(e.dtype == torch.float32 and not e.any()
               for e in TM.tree_leaves(loop.state.ef_error))


def test_build_takes_a_config_in_place_of_the_arch():
    """``build(args, cfg)`` trains the config it is handed (here reduced
    recurrentgemma-9b cut to two periods), with the flags' data, steps
    and device."""
    cfg = dataclasses.replace(
        tconfigs.get_config("recurrentgemma-9b").reduced(), n_layers=6)
    args = tlaunch.parser().parse_args(
        ["--arch", "recurrentgemma-9b", "--device", "cpu", "--steps", "1",
         "--batch", "2", "--seq", "16"])
    loop = tlaunch.build(args, cfg)
    stack = TM.tree_leaves(loop.state.params["layers"])
    assert stack and all(t.shape[0] == 2 for t in stack)  # two periods
    loop.run()
    assert len(loop.metrics_log) == 1
    assert np.isfinite(loop.metrics_log[0]["loss"])
    whole = tlaunch.build(tlaunch.parser().parse_args(
        ["--arch", "recurrentgemma-9b", "--reduced", "--device", "cpu",
         "--steps", "1", "--batch", "2", "--seq", "16"]))
    assert all(t.shape[0] == 1
               for t in TM.tree_leaves(whole.state.params["layers"]))
