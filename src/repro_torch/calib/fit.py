"""Fit effective Target constants from measurements (NNLS roofline fit).

The roofline model the whole planning stack prices with is piecewise
linear in the *reciprocal* hardware constants:

    transfer = max_port Σ_level  bytes·(1/bw) + transfers·dma_setup
    compute  = max_engine Σ_kind flops·(1/rate)
    runtime  = max(compute, transfer)            (hw.modeled_runtime)

Each isolated microbenchmark (:mod:`repro_torch.calib.measure`) is designed to
sit on one branch of each ``max`` (its ``branch`` hint), so its row is a
plain linear equation in the unknowns ``1/bw``, ``dma_setup`` and
``1/rate`` — all physically non-negative.  :func:`calibrate` stacks the
rows (weighted by ``1/measured`` so the fit minimizes *relative* error,
the quantity the drift gate means by "ratio") and solves each branch by
non-negative least squares (:func:`nnls`, Lawson–Hanson), re-resolving
the busiest-engine / busiest-port assignment between passes for targets
where those inner maxima matter.

The result is a preset-shaped :class:`~repro_torch.core.hw.Target` — same
level names, capacities, ports, buffer depths and engine structure as
the base; only the bandwidth / setup / rate constants move (an
engine-less base grows a single ``core`` engine carrying the fitted
per-kind rates).  Constants no measurement touched are inherited from
the base and reported as such.  Residuals (modeled vs measured, base and
calibrated side by side) are computed for *every* measurement, including
the unhinted whole-block ones the fit never saw — those are the
validation set :func:`drift_gate` checks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core import hw as hwlib

from .measure import COMPUTE, TRANSFER, Measurement, modeled_measurement_s

_TINY = 1e-30


def nnls(A, b, max_iter: int | None = None) -> np.ndarray:
    """Solve ``min ||Ax - b||`` s.t. ``x >= 0`` (Lawson–Hanson active
    set).  Small dense systems only — the calibration fit has a handful
    of unknowns."""
    A = np.asarray(A, dtype=float)
    b = np.asarray(b, dtype=float)
    m, n = A.shape
    x = np.zeros(n)
    passive = np.zeros(n, dtype=bool)
    w = A.T @ (b - A @ x)
    tol = 1e-10 * max(1.0, float(np.abs(A).max(initial=0.0)))
    max_iter = max_iter if max_iter is not None else 3 * max(n, 1)
    it = 0
    while (~passive).any() and it < max_iter:
        masked = np.where(~passive, w, -np.inf)
        j = int(np.argmax(masked))
        if masked[j] <= tol:
            break
        passive[j] = True
        while True:
            s = np.zeros(n)
            s[passive] = np.linalg.lstsq(A[:, passive], b, rcond=None)[0]
            neg = passive & (s <= 0.0)
            if not neg.any():
                break
            with np.errstate(divide="ignore", invalid="ignore"):
                steps = x[neg] / (x[neg] - s[neg])
            alpha = float(np.min(steps))
            x = x + alpha * (s - x)
            passive = passive & (x > tol)
        x = s
        w = A.T @ (b - A @ x)
        it += 1
    return np.clip(x, 0.0, None)


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Residual:
    """Modeled-vs-measured of one measurement, base and calibrated."""

    name: str
    kind: str
    measured_s: float
    base_modeled_s: float
    calibrated_modeled_s: float
    in_fit: bool

    @property
    def base_ratio(self) -> float:
        return self.base_modeled_s / self.measured_s

    @property
    def calibrated_ratio(self) -> float:
        return self.calibrated_modeled_s / self.measured_s

    @property
    def base_log_residual(self) -> float:
        return abs(math.log(max(self.base_ratio, _TINY)))

    @property
    def calibrated_log_residual(self) -> float:
        return abs(math.log(max(self.calibrated_ratio, _TINY)))


def _geomean(vals: Sequence[float]) -> float:
    vals = [max(v, _TINY) for v in vals]
    if not vals:
        return 1.0
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """The fitted target plus everything needed to judge the fit."""

    base: hwlib.Target
    target: hwlib.Target
    fitted: tuple[tuple[str, float], ...]      # constant name -> value
    inherited: tuple[str, ...]                 # kept from the base
    residuals: tuple[Residual, ...]
    n_iter: int

    # -- aggregate quality -------------------------------------------------
    @property
    def geomean_ratio(self) -> float:
        """Geometric-mean modeled/measured on the calibrated target —
        the drift-gate statistic (1.0 = unbiased model)."""
        return _geomean([r.calibrated_ratio for r in self.residuals])

    @property
    def base_geomean_ratio(self) -> float:
        return _geomean([r.base_ratio for r in self.residuals])

    @property
    def mean_abs_log_residual(self) -> float:
        """Mean |ln(modeled/measured)| on the calibrated target — the
        spread statistic 'residuals shrink' refers to."""
        rs = self.residuals
        return sum(r.calibrated_log_residual for r in rs) / max(1, len(rs))

    @property
    def base_mean_abs_log_residual(self) -> float:
        rs = self.residuals
        return sum(r.base_log_residual for r in rs) / max(1, len(rs))

    def residuals_of(self, kind: str) -> tuple[Residual, ...]:
        return tuple(r for r in self.residuals if r.kind == kind)

    def summary(self) -> str:
        lines = [
            f"calibrated '{self.base.name}' -> '{self.target.name}' "
            f"({self.n_iter} pass(es), {len(self.residuals)} measurements)",
            f"  geomean modeled/measured: {self.base_geomean_ratio:.3f} "
            f"(base) -> {self.geomean_ratio:.3f} (calibrated)",
            f"  mean |log residual|:      "
            f"{self.base_mean_abs_log_residual:.3f} (base) -> "
            f"{self.mean_abs_log_residual:.3f} (calibrated)",
            "  fitted constants:",
        ]
        for name, val in self.fitted:
            lines.append(f"    {name:<28} {val:.4g}")
        if self.inherited:
            lines.append(f"  inherited from base: "
                         f"{', '.join(self.inherited)}")
        per = {}
        for r in self.residuals:
            per.setdefault(r.kind, []).append(r.calibrated_ratio)
        for kind, ratios in sorted(per.items()):
            lines.append(f"  {kind:<12} geomean ratio "
                         f"{_geomean(ratios):.3f}  (n={len(ratios)})")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------

def _engine_of(target: hwlib.Target, kind: str) -> str:
    return target.engine_rate(kind)[0]


def _busiest_engine(target: hwlib.Target, flops: dict[str, float]) -> str:
    times = target.engine_times(flops)
    return max(times, key=lambda e: times[e])


def _busiest_port(target: hwlib.Target, by_level: dict[str, int],
                  n_level: dict[str, int]) -> str:
    per_port = target.transfer_time_by_port(by_level, n_level)
    return max(per_port, key=lambda p: per_port[p])


def _fit_rows(measurements: Sequence[Measurement]):
    """Fit inputs: hinted, single-segment measurements only.  Multi-
    segment (whole-block) measurements mix compute- and transfer-bound
    segments, so they validate the fit instead of entering it."""
    return [m for m in measurements
            if m.branch is not None and len(m.segments) == 1]


def _solve_branch(rows: list[tuple[dict, float]], keys: list):
    """Weighted NNLS of ``Σ_k feat[k]·x[k] ≈ measured`` over ``rows``.
    Rows are weighted ``1/measured`` (relative error — the drift gate's
    ratio statistic); columns are rescaled to unit peak for
    conditioning.  Returns ``{key: value}`` for keys any row touched."""
    touched = [k for k in keys
               if any(feat.get(k, 0.0) > 0.0 for feat, _ in rows)]
    if not touched:
        return {}
    A = np.array([[feat.get(k, 0.0) / meas for k in touched]
                  for feat, meas in rows])
    b = np.ones(len(rows))
    scale = np.maximum(np.abs(A).max(axis=0), _TINY)
    x = nnls(A / scale, b) / scale
    return dict(zip(touched, x))


def calibrate(
    measurements: Sequence[Measurement],
    base: hwlib.Target | None = None,
    *,
    max_iter: int = 4,
) -> CalibrationResult:
    """Fit effective per-level bandwidth/dma_setup and per-engine-kind
    FLOP/s from ``measurements`` and emit a preset-shaped calibrated
    target (see module docstring).  ``base`` defaults to the process
    default target; its structure (levels, capacities, ports, engines)
    is preserved — only constants move."""
    base = base if base is not None else hwlib.default_target()
    fit_set = _fit_rows(measurements)
    if not fit_set:
        raise ValueError(
            "calibrate() needs at least one single-segment measurement "
            "with a branch hint (see repro_torch.calib.measure.microbench_sweep)")

    backing = {lv.name for lv in base.backing}
    cur = base
    rates: dict[tuple[str, str], float] = {}
    bw: dict[str, float] = {}
    setup: dict[str, float] = {}
    n_iter = 0
    for n_iter in range(1, max_iter + 1):
        # --- build branch rows under the current assignment ---------------
        c_rows: list[tuple[dict, float]] = []
        t_rows: list[tuple[dict, float]] = []
        for m in fit_set:
            seg = m.segments[0]
            if m.branch == COMPUTE:
                flops = dict(seg.flops_by_kind)
                eng = _busiest_engine(cur, flops)
                feat = {("rate", eng, k): f for k, f in flops.items()
                        if _engine_of(cur, k) == eng and f > 0.0}
                if feat:
                    c_rows.append((feat, m.measured_s / seg.repeat))
            else:
                by_level = {lv: b for lv, b in seg.bytes_by_level
                            if lv in backing}
                n_level = {lv: n for lv, n in seg.transfers_by_level
                           if lv in backing}
                if not by_level and not n_level:
                    continue
                port = _busiest_port(cur, by_level, n_level)
                on_port = {lv.name for lv in base.backing
                           if lv.dma_port == port}
                feat: dict = {}
                for lv, b in by_level.items():
                    if lv in on_port and b > 0:
                        feat[("bw", lv)] = float(b)
                for lv, n in n_level.items():
                    if lv in on_port and n > 0:
                        feat[("setup", lv)] = float(n)
                if feat:
                    t_rows.append((feat, m.measured_s / seg.repeat))

        rate_keys = sorted({k for feat, _ in c_rows for k in feat})
        lvl_keys = sorted({k for feat, _ in t_rows for k in feat})
        inv_rates = _solve_branch(c_rows, rate_keys)
        lvl_consts = _solve_branch(t_rows, lvl_keys)

        new_rates = {(e, k): float(1.0 / v)
                     for (_, e, k), v in inv_rates.items() if v > _TINY}
        new_bw = {lv: float(1.0 / v)
                  for (tag, lv), v in lvl_consts.items()
                  if tag == "bw" and v > _TINY}
        new_setup = {lv: float(v) for (tag, lv), v in lvl_consts.items()
                     if tag == "setup"}
        nxt = _build_target(base, new_rates, new_bw, new_setup)
        converged = (new_rates.keys() == rates.keys()
                     and new_bw.keys() == bw.keys()
                     and all(_close(new_rates[k], rates[k])
                             for k in new_rates)
                     and all(_close(new_bw[k], bw[k]) for k in new_bw)
                     and all(_close(new_setup.get(k, 0.0),
                                    setup.get(k, 0.0), absolute=1e-12)
                             for k in new_setup))
        rates, bw, setup, cur = new_rates, new_bw, new_setup, nxt
        if converged:
            break

    fitted = tuple(sorted(
        [(f"rate:{e}:{k}", v) for (e, k), v in rates.items()]
        + [(f"bw:{lv}", v) for lv, v in bw.items()]
        + [(f"dma_setup:{lv}", v) for lv, v in setup.items()]
    ))
    fitted_names = {n for n, _ in fitted}
    inherited = tuple(sorted(
        [f"bw:{lv.name}" for lv in base.backing
         if f"bw:{lv.name}" not in fitted_names]
        + [f"dma_setup:{lv.name}" for lv in base.backing
           if f"dma_setup:{lv.name}" not in fitted_names]
    ))
    fit_names = {m.name for m in fit_set}
    residuals = tuple(
        Residual(
            name=m.name, kind=m.kind, measured_s=m.measured_s,
            base_modeled_s=modeled_measurement_s(base, m),
            calibrated_modeled_s=modeled_measurement_s(cur, m),
            in_fit=m.name in fit_names,
        )
        for m in measurements
    )
    return CalibrationResult(base=base, target=cur, fitted=fitted,
                             inherited=inherited, residuals=residuals,
                             n_iter=n_iter)


def _close(a: float, b: float, rel: float = 1e-6,
           absolute: float = 0.0) -> bool:
    return abs(a - b) <= max(absolute, rel * max(abs(a), abs(b)))


def _build_target(
    base: hwlib.Target,
    rates: dict[tuple[str, str], float],
    bw: dict[str, float],
    setup: dict[str, float],
) -> hwlib.Target:
    """The calibrated target: base structure, fitted constants.

    Levels keep name/capacity/port/depth; fitted levels get new
    bandwidth and DMA setup.  An engine-carrying base keeps its engines
    with fitted exact-kind rates grafted in; an engine-less base grows a
    single ``core`` engine with the fitted per-kind rates (plus a
    conservative ``'*'`` catch-all), which is strictly more expressive
    than the old single-rate model and exactly how the fit priced it.
    """
    levels = []
    for lv in base.levels:
        if lv.name in bw or lv.name in setup:
            levels.append(dataclasses.replace(
                lv,
                bw_bytes_per_s=bw.get(lv.name, lv.bw_bytes_per_s),
                dma_setup_s=setup.get(lv.name, lv.dma_setup_s),
            ))
        else:
            levels.append(lv)

    flops = base.flops
    if base.engines:
        engines = []
        for e in base.engines:
            mine = {k: r for (en, k), r in rates.items() if en == e.name}
            if mine:
                kept = tuple((k, r) for k, r in e.rates if k not in mine)
                engines.append(hwlib.Engine(
                    e.name, kept + tuple(sorted(mine.items()))))
            else:
                engines.append(e)
        engines = tuple(engines)
    elif rates:
        by_kind = dict(sorted(
            (k, r) for (_, k), r in rates.items()))
        fallback = min(by_kind.values())
        engines = (hwlib.Engine(
            "core", tuple(by_kind.items()) + (("*", fallback),)),)
    else:
        engines = base.engines
    gemm_route = next((r for (_, k), r in rates.items() if k == "gemm"),
                      None)
    if gemm_route is not None:
        flops = gemm_route
    name = base.name.split("@calib")[0] + "@calib"
    return dataclasses.replace(base, name=name, levels=tuple(levels),
                               flops=flops, engines=engines)


# ---------------------------------------------------------------------------
# CI drift gate
# ---------------------------------------------------------------------------

def drift_gate(
    result: CalibrationResult,
    *,
    band: tuple[float, float] = (0.3, 10 / 3),
    require_tighter: bool = True,
) -> dict:
    """The CI modeled-vs-measured gate: on the *calibrated* target the
    geometric-mean modeled/measured ratio must sit inside ``band``, and
    (``require_tighter``) the calibrated residual spread must be
    strictly tighter than the uncalibrated base's.  Returns a JSON-ready
    verdict; callers raise on ``ok == False``."""
    g = result.geomean_ratio
    in_band = band[0] <= g <= band[1]
    tighter = (result.mean_abs_log_residual
               < result.base_mean_abs_log_residual)
    ok = in_band and (tighter or not require_tighter)
    return {
        "ok": bool(ok),
        "band": list(band),
        "geomean_ratio": g,
        "in_band": bool(in_band),
        "base_geomean_ratio": result.base_geomean_ratio,
        "mean_abs_log_residual": result.mean_abs_log_residual,
        "base_mean_abs_log_residual": result.base_mean_abs_log_residual,
        "residual_tighter_than_base": bool(tighter),
        "n_measurements": len(result.residuals),
        "n_fit": sum(1 for r in result.residuals if r.in_fit),
    }


__all__ = ["nnls", "Residual", "CalibrationResult", "calibrate",
           "drift_gate"]
