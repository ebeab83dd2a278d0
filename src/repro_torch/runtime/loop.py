"""Fault-tolerant training loop: the port's counterpart of
``repro.runtime.loop``.

Wires together: data pipeline (restartable at any step), checkpoint manager
(async saves, auto-resume), straggler monitor, and a preemption handler
(SIGTERM → synchronous checkpoint → clean exit).  On resume the
checkpoint is restored into the structure, dtypes and devices of the
state the loop was given (under ``state_shardings`` where given: a tree
of ``NamedSharding`` for a state on a mesh), and the data pipeline
resumes at the restored step.  Each step's metrics become host floats
inside the step's span, which waits for the device, so the monitor's
wall time covers the step.
"""
from __future__ import annotations

import dataclasses
import logging
import signal
from typing import Any, Callable

from repro_torch import obs
from repro_torch.ckpt import CheckpointManager
from repro_torch.runtime.monitor import StragglerMonitor

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    ckpt_async: bool = True
    keep_n: int = 3
    log_every: int = 10
    straggler_threshold: float = 2.0


class TrainLoop:
    """``run()`` drives step_fn over the data stream with fault tolerance.

    ``step_fn(state, batch) -> (state, metrics)``.
    ``make_batch(step) -> batch`` — pure function of the step index
    (counter-based pipeline), so resume needs no stream replay.
    """

    def __init__(
        self,
        cfg: LoopConfig,
        step_fn: Callable,
        make_batch: Callable[[int], Any],
        init_state: Any,
        *,
        state_shardings: Any | None = None,
        on_metrics: Callable[[int, dict], None] | None = None,
    ):
        self.cfg = cfg
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.state = init_state
        self.state_shardings = state_shardings
        self.on_metrics = on_metrics
        self.monitor = StragglerMonitor(threshold=cfg.straggler_threshold)
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, keep_n=cfg.keep_n)
                     if cfg.ckpt_dir else None)
        self._preempted = False
        self.metrics_log: list[dict] = []

    # ------------------------------------------------------------------
    def _install_signal_handlers(self):
        def handler(signum, frame):
            log.warning("signal %s: checkpoint-and-exit requested", signum)
            self._preempted = True

        self._prev = {
            s: signal.signal(s, handler)
            for s in (signal.SIGTERM, signal.SIGINT)
        }

    def _restore_signal_handlers(self):
        for s, h in getattr(self, "_prev", {}).items():
            signal.signal(s, h)

    # ------------------------------------------------------------------
    def _resume(self) -> int:
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return 0
        self.state, step = self.ckpt.restore(
            self.state, shardings=self.state_shardings)
        log.info("resumed from checkpoint step %d", step)
        return step

    def _save(self, step: int, *, blocking: bool) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save(self.state, step, blocking=blocking)

    # ------------------------------------------------------------------
    def run(self) -> Any:
        self._install_signal_handlers()
        try:
            start = self._resume()
            step = start
            while step < self.cfg.total_steps and not self._preempted:
                batch = self.make_batch(step)
                self.monitor.start_step()
                with obs.span(f"train_step:{step}", "train"):
                    self.state, metrics = self.step_fn(self.state, batch)
                    # block on the loss so wall time covers the step
                    metrics = {k: float(v) for k, v in metrics.items()}
                stat = self.monitor.end_step(step)
                if stat.flagged:
                    log.warning("straggler: step %d took %.3fs (ema %.3fs)",
                                step, stat.seconds, self.monitor.ema)
                step += 1
                if self.on_metrics and (step % self.cfg.log_every == 0):
                    self.on_metrics(step, metrics)
                self.metrics_log.append({"step": step, **metrics})
                if step % self.cfg.ckpt_every == 0:
                    self._save(step, blocking=not self.cfg.ckpt_async)
            # final/preemption checkpoint is synchronous — must complete
            if self.ckpt is not None and step > start:
                self._save(step, blocking=True)
                self.ckpt.wait()
            return self.state
        finally:
            self._restore_signal_handlers()
