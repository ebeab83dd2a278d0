"""Training driver of the port: the counterpart of ``repro.launch.train``.

It runs real steps on the CUDA card unless ``--device`` names another
device (with no card and no device named it raises).  Fault tolerance
comes from :class:`repro_torch.runtime.TrainLoop`: auto-resume from the
latest checkpoint, async saves every ``--ckpt-every`` steps,
SIGTERM-preemption checkpointing, straggler flagging.

``--mesh AxB[xC]`` trains on a mesh over the axes ``("pod", "data",
"model")[-len(shape):]``, one process a device (``torchrun
--nproc-per-node N``; a mesh of one device needs no launcher): the state
is placed under ``train.steps.state_pspecs``, each rank reads its dp
rows of every batch, and checkpoints hold whole leaves.  ``--compress``
applies int8 error-feedback compression to the reduced gradients.  Over
NCCL on cards, over gloo with ``--device cpu``::

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch llama3.2-3b --reduced --device cpu --mesh 2x2 --compress

CPU end to end (reduced config, synthetic bigram data)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --device cpu --steps 4 --batch 2 --seq 32 --log-every 2

On the card, full width::

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 4 --batch 4 --seq 1024 --accum 2

``--obs`` records ``train_step`` spans and the straggler/heartbeat
metrics on :mod:`repro_torch.obs`; ``--obs-trace PATH`` writes the merged
live+modeled timeline over the block plan, ``--obs-metrics PATH`` the
Prometheus text (both imply ``--obs``).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging

import torch
import torch.distributed as dist

from repro_torch import obs as obslib
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.ftl import executor_block
from repro_torch.core.ftl import registry as ftl_registry
from repro_torch.core.ftl.solver import InfeasibleError
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import process_rank, resolve_device
from repro_torch.distributed.sharding import to_shardings
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import OptConfig
from repro_torch.runtime import LoopConfig, TrainLoop
from repro_torch.runtime.monitor import HeartbeatMonitor
from repro_torch.train import steps as S


def build(args, cfg: ModelConfig | None = None) -> TrainLoop:
    """The :class:`TrainLoop` the flags in ``args`` describe, not yet
    run; its ``block_plan`` and ``heartbeat`` are surfaced for tools.
    ``cfg``, where given, takes the place of the config ``--arch`` names
    (``--reduced`` and ``--ftl-mode`` still apply to it); its ``mesh``
    is the mesh ``--mesh`` built, or None."""
    mesh = None
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.split("x"))
        mesh = make_mesh(shape, ("pod", "data", "model")[-len(shape):],
                         device=args.device)
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.ftl_mode:
        cfg = dataclasses.replace(cfg, ftl_mode=args.ftl_mode)

    # the FTL plan of one block at the training token count: the plan
    # model.forward resolves (per cfg, m, dtype) and runs every block
    # through under any mode but "off"
    bp = None
    try:
        bp = ftl_registry.plan_block(cfg, m=args.seq, device=device)
        execs = executor_block.resolved_executors(bp, m=args.seq)
        state = ("executed by every forward block"
                 if cfg.ftl_mode != "off" else
                 "report only — ftl_mode='off' runs the baseline; pass "
                 "--ftl-mode auto to execute it")
        logging.info("FTL block plan (m=%d, target=%s, %s):\n%s\n"
                     "  runtime executors: %s",
                     args.seq, bp.target.name, state, bp.summary(), execs)
    except (ValueError, InfeasibleError) as e:
        logging.info("FTL block plan unavailable (layer-per-layer path): "
                     "%s", e)

    state = S.init_train_state(cfg, args.seed, device=device,
                               compress=args.compress, mesh=mesh)
    opt = OptConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                    decay_steps=args.steps)
    step = S.make_train_step(cfg, mesh, opt, accum=args.accum,
                             compress=args.compress)
    shardings = None if mesh is None else to_shardings(S.state_pspecs(
        S.train_state_shapes(cfg, compress=args.compress), mesh, cfg), mesh)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=args.batch,
        seq_len=args.seq, seed=args.seed, kind=args.data), mesh=mesh)

    # liveness: stamp a heartbeat at the top of every step (make_batch is
    # the first per-step call)
    hb = (HeartbeatMonitor(args.heartbeat_dir, process_rank()[0])
          if args.heartbeat_dir else None)

    def on_metrics(s: int, m: dict) -> None:
        if process_rank()[0] == 0:          # one line a step, not a rank
            print(f"step {s:6d} loss {m.get('loss', float('nan')):.4f} "
                  f"gnorm {m.get('grad_norm', 0):.3f} "
                  f"lr {m.get('lr', 0):.2e}"
                  + (f" moe_aux {m['moe_aux']:.4f}" if "moe_aux" in m
                     else ""), flush=True)

    def make_batch(i: int):
        if hb is not None:
            hb.stamp()
        return {k: torch.from_numpy(v).to(device)
                for k, v in data.batch_at(i).items()}

    loop = TrainLoop(
        LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, log_every=args.log_every),
        step, make_batch, state, state_shardings=shardings,
        on_metrics=on_metrics,
    )
    loop.block_plan = bp
    loop.heartbeat = hb
    loop.mesh = mesh
    return loop


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default="bigram", choices=["bigram", "random"])
    ap.add_argument("--mesh", default=None,
                    help="AxB[xC] over (pod,) data, model; one process a "
                    "device (torchrun)")
    ap.add_argument("--ftl-mode", default=None,
                    choices=["off", "fused", "scan", "auto"])
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--obs", action="store_true",
                    help="runtime telemetry: train_step spans + straggler/"
                    "heartbeat metrics on the repro_torch.obs registry")
    ap.add_argument("--obs-trace", default=None,
                    help="merged live+modeled Chrome-tracing JSON "
                    "(implies --obs)")
    ap.add_argument("--obs-metrics", default=None,
                    help="Prometheus text exposition written post-run "
                    "(implies --obs)")
    ap.add_argument("--heartbeat-dir", default=None,
                    help="shared dir for per-process heartbeat stamps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                    "only when asked for)")
    return ap


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = parser().parse_args(argv)
    if args.obs_trace or args.obs_metrics:
        args.obs = True
    if args.obs:
        obslib.enable()
    loop = build(args)
    loop.run()
    if loop.mesh is not None and dist.is_initialized():
        dist.destroy_process_group()
    if process_rank()[0] != 0:
        return
    if loop.metrics_log:
        last = loop.metrics_log[-1]
        print(f"final: step {last['step']} loss {last.get('loss'):.4f}")
    # stragglers the loop's monitor flagged live
    flagged = loop.monitor.flagged_steps
    if flagged:
        worst = max(flagged, key=lambda s: s.seconds)
        print(f"stragglers: {len(flagged)} flagged step(s), worst "
              f"step {worst.step} at {worst.seconds:.3f}s "
              f"(ema {loop.monitor.ema:.3f}s)")
    elif args.obs:
        print(f"stragglers: none flagged over {len(loop.monitor.history)} "
              f"steps (ema {loop.monitor.ema:.3f}s)"
              if loop.monitor.ema is not None else "stragglers: no steps ran")

    if args.obs_trace:
        obslib.write_merged_trace(args.obs_trace, chain=loop.block_plan)
        print(f"wrote merged trace to {args.obs_trace}")
    if args.obs_metrics:
        obslib.write_prometheus(args.obs_metrics)
        print(f"wrote metrics to {args.obs_metrics}")


if __name__ == "__main__":
    main()
