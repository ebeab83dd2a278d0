"""Straggler & liveness monitoring: the port's copy of
``repro.runtime.monitor``, recording through :mod:`repro_torch.obs`.

``StragglerMonitor`` — per-step wall-time EMA + deviation tracking; flags
steps slower than ``threshold ×`` the running median (hardware degradation,
thermal throttling, a slow host in the data-parallel group).  On a real
pod the flagged signal feeds the controller, which can evict the host and
trigger an elastic restart (runtime/loop.py handles the restart half).

``HeartbeatMonitor`` — file-based process heartbeats: every process stamps
``<dir>/proc_<i>`` each step; any process can list peers whose stamp is
older than ``timeout``.  File-based so it works on any shared filesystem
without a side-channel service; swap ``stamp``/``stale_peers`` for your
RPC of choice on clusters with a coordinator.

Both monitors emit through :mod:`repro_torch.obs.metrics`: flagged-step
counter + per-step seconds gauge (straggler), stamp counter +
oldest-peer-heartbeat-age gauge (liveness) — so a scrape of the metrics
registry shows cluster health next to the serving/planning telemetry.
"""
from __future__ import annotations

import dataclasses
import os
import time

from repro_torch import obs

_C_FLAGGED = obs.counter(
    "train_straggler_flagged_total",
    "steps flagged slower than threshold x the EMA")
_G_STEP = obs.gauge(
    "train_step_seconds", "wall-clock of the last training step")
_G_EMA = obs.gauge(
    "train_step_seconds_ema", "EMA of unflagged step wall-clock")
_C_STAMPS = obs.counter(
    "train_heartbeat_stamps_total", "heartbeats written by this process")
_G_HB_AGE = obs.gauge(
    "train_heartbeat_oldest_age_seconds",
    "age of the oldest peer heartbeat at the last stale_peers() scan")


@dataclasses.dataclass
class StepStat:
    step: int
    seconds: float
    flagged: bool


class StragglerMonitor:
    def __init__(self, *, threshold: float = 2.0, warmup: int = 5):
        self.threshold = threshold
        self.warmup = warmup
        self.ema: float | None = None
        self.history: list[StepStat] = []
        self._t0: float | None = None

    def start_step(self) -> None:
        self._t0 = time.monotonic()

    def end_step(self, step: int) -> StepStat:
        assert self._t0 is not None, "start_step not called"
        dt = time.monotonic() - self._t0
        self._t0 = None
        flagged = False
        if len(self.history) >= self.warmup and self.ema is not None:
            flagged = dt > self.threshold * self.ema
        # EMA excludes flagged outliers so one straggler doesn't poison it
        if self.ema is None:
            self.ema = dt
        elif not flagged:
            self.ema = 0.9 * self.ema + 0.1 * dt
        stat = StepStat(step, dt, flagged)
        self.history.append(stat)
        _G_STEP.set(dt)
        if self.ema is not None:
            _G_EMA.set(self.ema)
        if flagged:
            _C_FLAGGED.inc()
        return stat

    @property
    def flagged_steps(self) -> list[StepStat]:
        return [s for s in self.history if s.flagged]


class HeartbeatMonitor:
    def __init__(self, directory: str, process_index: int, *,
                 timeout: float = 60.0):
        self.dir = directory
        self.pi = process_index
        self.timeout = timeout
        os.makedirs(directory, exist_ok=True)

    def stamp(self) -> None:
        path = os.path.join(self.dir, f"proc_{self.pi}")
        with open(path, "w") as f:
            f.write(str(time.time()))
        _C_STAMPS.inc()

    def stale_peers(self) -> list[int]:
        now = time.time()
        stale = []
        oldest_age = 0.0
        for name in os.listdir(self.dir):
            if not name.startswith("proc_"):
                continue
            try:
                with open(os.path.join(self.dir, name)) as f:
                    t = float(f.read().strip())
            except (OSError, ValueError):
                continue
            oldest_age = max(oldest_age, now - t)
            if now - t > self.timeout:
                stale.append(int(name.split("_")[1]))
        _G_HB_AGE.set(oldest_age)
        return sorted(stale)
