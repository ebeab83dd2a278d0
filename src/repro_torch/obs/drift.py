"""Online modeled-vs-measured drift monitor.

The port's copy of ``repro.obs.drift``.  The calibration loop
(:mod:`repro_torch.calib`) established the metric that matters: the
geometric-mean modeled/measured ratio, gated inside a band
(:data:`DEFAULT_BAND` = (0.3, 10/3), ``calib.drift_gate``'s).  That
check runs offline.  This monitor runs the *same* arithmetic
continuously inside a live process: executed-segment wall-clock observations become
``calib.Measurement`` rows, each is re-priced on the monitor's target
through the one shared roofline formula, and a rolling window of
log-ratios per (name, target) keeps the current geomean — flagged
through ``obs.metrics`` the moment it leaves the band.

Exactness contract (held in ``tests/test_torch_obs.py``): feeding the
monitor a set of observations and then computing the offline geomean
over ``monitor.measurements()`` with the calibration formula
(``exp(mean(log(modeled/measured)))``) reproduces
``monitor.geomean_ratio()`` bit-for-bit — the online view is the
offline gate, not an approximation of it.
"""
from __future__ import annotations

import math
from collections import deque
from typing import TYPE_CHECKING

from repro_torch.calib.measure import (Measurement, features_from_chain,
                                 modeled_measurement_s)

from . import metrics as _metrics

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core import hw as hwlib

__all__ = ["DEFAULT_BAND", "DriftMonitor"]

# the calibration drift band (calib.drift_gate's default): a model off
# by more than ~3x either way is mispricing plans outright.
DEFAULT_BAND = (0.3, 10 / 3)


class DriftMonitor:
    """Rolling modeled-vs-measured drift per (name, target).

    ``target`` is the machine every observation is priced on (use a
    ``Target.calibrated(...)`` fit for a meaningful band check — presets
    are *rankings*, not wall-clock predictors).  ``window`` bounds the
    per-name rolling deque; ``keep`` bounds the retained raw
    ``Measurement`` rows (for offline re-fitting / the exactness gate).
    """

    def __init__(self, target: "hwlib.Target | None" = None, *,
                 band: tuple[float, float] = DEFAULT_BAND,
                 window: int = 64, keep: int = 256,
                 registry: _metrics.MetricsRegistry | None = None):
        if target is None:
            from repro_torch.core import hw as hwlib

            target = hwlib.default_target()
        self.target = target
        self.band = (float(band[0]), float(band[1]))
        self.window = window
        self._logs: dict[str, deque[float]] = {}
        self._rows: deque[Measurement] = deque(maxlen=keep)
        self.n_observed = 0
        reg = registry if registry is not None else _metrics.REGISTRY
        lbl = ("segment", "target")
        self._g_ratio = reg.gauge(
            "drift_geomean_ratio",
            "rolling geomean modeled/measured ratio", lbl)
        self._g_n = reg.gauge(
            "drift_window_observations",
            "observations in the rolling window", lbl)
        self._c_out = reg.counter(
            "drift_out_of_band_total",
            "observations that pushed a rolling geomean out of band", lbl)

    # -- feeding -----------------------------------------------------------

    def observe_measurement(self, m: Measurement, *,
                            scale: float = 1.0) -> float:
        """Record one observation; returns its modeled/measured ratio.

        ``scale`` multiplies the *modeled* side — pass ``n_layers`` when
        the measured seconds cover a full model pass of a per-block
        plan.
        """
        modeled = scale * modeled_measurement_s(self.target, m)
        ratio = modeled / m.measured_s
        dq = self._logs.get(m.name)
        if dq is None:
            dq = self._logs[m.name] = deque(maxlen=self.window)
        dq.append(math.log(ratio))
        self._rows.append(m)
        self.n_observed += 1
        g = math.exp(sum(dq) / len(dq))
        lbl = self._labels(m.name)
        self._g_ratio.labels(**lbl).set(g)
        self._g_n.labels(**lbl).set(len(dq))
        if not (self.band[0] <= g <= self.band[1]):
            self._c_out.labels(**lbl).inc()
        return ratio

    def observe(self, name: str, measured_s: float, segments, *,
                kind: str = "block", scale: float = 1.0) -> float:
        m = Measurement(name=name, kind=kind, measured_s=measured_s,
                        segments=tuple(segments))
        return self.observe_measurement(m, scale=scale)

    def observe_chain(self, chain, measured_s: float, *, name: str,
                      kind: str = "block", scale: float = 1.0) -> float:
        """Observe a wall-clock run of a planned chain / ``BlockPlan``."""
        return self.observe(name, measured_s, features_from_chain(chain),
                            kind=kind, scale=scale)

    def _labels(self, name: str) -> dict:
        return {"segment": name, "target": self.target.name}

    # -- reading -----------------------------------------------------------

    def geomean_ratio(self, name: str | None = None) -> float | None:
        """Rolling geomean ratio for one name, or pooled over all names
        (every windowed log-ratio weighted equally) when ``name`` is
        None.  ``None`` when nothing has been observed."""
        if name is not None:
            dq = self._logs.get(name)
            if not dq:
                return None
            return math.exp(sum(dq) / len(dq))
        logs = [v for dq in self._logs.values() for v in dq]
        if not logs:
            return None
        return math.exp(sum(logs) / len(logs))

    def in_band(self, name: str | None = None) -> bool | None:
        g = self.geomean_ratio(name)
        if g is None:
            return None
        return self.band[0] <= g <= self.band[1]

    def measurements(self) -> list[Measurement]:
        """Retained raw rows, oldest first — feedable straight into
        ``calib.calibrate`` for an offline re-fit."""
        return list(self._rows)

    def status(self) -> dict:
        """JSON-ready summary (the serve CLI's drift line)."""
        per = {}
        for name, dq in sorted(self._logs.items()):
            g = math.exp(sum(dq) / len(dq))
            per[name] = {
                "geomean_ratio": g,
                "n_window": len(dq),
                "in_band": self.band[0] <= g <= self.band[1],
            }
        return {
            "target": self.target.name,
            "band": list(self.band),
            "n_observed": self.n_observed,
            "geomean_ratio": self.geomean_ratio(),
            "in_band": self.in_band(),
            "per_segment": per,
        }
