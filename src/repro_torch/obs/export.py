"""Exporters: merged Perfetto timeline, Prometheus text, JSON snapshot.

The port's copy of ``repro.obs.export``.  ``merged_chrome_trace`` is the
headline view: the **live** runtime spans
(from :mod:`repro_torch.obs.spans`) and the **modeled/measured** tracks (from
``sim.to_chrome_trace``) on one Chrome-tracing timeline — pid 0 is the
simulated plan, pid 1 the live process — so "is the executed plan
honoring the modeled roofline" is a single Perfetto screenful.

``prometheus_text`` renders the metrics registry in the text exposition
format (``# HELP``/``# TYPE`` + samples), suitable for a file-based
scrape or `curl`-style inspection; ``metrics_snapshot`` is the same data
as plain JSON.
"""
from __future__ import annotations

import json
from typing import Sequence

from . import metrics as _metrics
from . import spans as _spans

__all__ = [
    "merged_chrome_trace",
    "write_merged_trace",
    "prometheus_text",
    "write_prometheus",
    "metrics_snapshot",
]

_LIVE_PID = 1


def _live_events(rows: Sequence[_spans.Span]) -> list[dict]:
    if not rows:
        return []
    t_base = min(s.t0 for s in rows)
    tids: dict[int, int] = {}
    events: list[dict] = []
    for s in rows:
        tid = tids.setdefault(s.tid, len(tids))
        events.append({
            "name": s.name, "ph": "X", "pid": _LIVE_PID, "tid": tid,
            "ts": 1e6 * (s.t0 - t_base),
            "dur": 1e6 * s.duration_s,
            "cat": s.cat,
            "args": {"depth": s.depth},
        })
    meta = [{"name": "process_name", "ph": "M", "pid": _LIVE_PID,
             "args": {"name": "live runtime"}}]
    meta += [{"name": "thread_name", "ph": "M", "pid": _LIVE_PID,
              "tid": tid, "args": {"name": f"thread:{raw}"}}
             for raw, tid in sorted(tids.items(), key=lambda kv: kv[1])]
    return meta + events


def merged_chrome_trace(*, spans=None, chain=None, measured=None,
                        registry: _metrics.MetricsRegistry | None = None,
                        ) -> dict:
    """Chrome-tracing JSON with up to three sources merged:

    * ``chain`` (a ``ChainPlan``/``BlockPlan``/``Schedule``) → the
      simulated timeline on pid 0, with optional ``measured`` spans as a
      second track (exactly ``sim.to_chrome_trace``);
    * ``spans`` → live runtime spans on pid 1 (an explicit list of
      :class:`~repro_torch.obs.spans.Span`, a :class:`SpanRecorder`, or
      ``None`` to snapshot the default recorder);
    * ``registry`` → a metrics snapshot embedded under
      ``otherData.metrics`` (defaults to the global registry).
    """
    events: list[dict] = []
    if chain is not None:
        from repro_torch import sim  # lazy: sim imports the planner

        events += sim.to_chrome_trace(chain, measured=measured,
                                      pid=0)["traceEvents"]
    if spans is None:
        rec = _spans.recorder()
        rows = rec.snapshot() if rec is not None else []
    elif isinstance(spans, _spans.SpanRecorder):
        rows = spans.snapshot()
    else:
        rows = list(spans)
    events += _live_events(rows)
    reg = registry if registry is not None else _metrics.REGISTRY
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"metrics": reg.collect()},
    }


def write_merged_trace(path, *, spans=None, chain=None, measured=None,
                       registry: _metrics.MetricsRegistry | None = None,
                       ) -> None:
    with open(path, "w") as f:
        json.dump(merged_chrome_trace(spans=spans, chain=chain,
                                      measured=measured,
                                      registry=registry), f)


def _fmt_labels(lbl: dict) -> str:
    if not lbl:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(lbl.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def prometheus_text(registry: _metrics.MetricsRegistry | None = None) -> str:
    """Prometheus text exposition (version 0.0.4) of the registry."""
    reg = registry if registry is not None else _metrics.REGISTRY
    lines = []
    for name, m in reg.collect().items():
        if m["help"]:
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m['kind']}")
        for lbl, v in m["samples"]:
            lbl = dict(lbl)
            if "__sum__" in lbl:
                lbl.pop("__sum__")
                lines.append(f"{name}_sum{_fmt_labels(lbl)} {_fmt_value(v)}")
            elif "__count__" in lbl:
                lbl.pop("__count__")
                lines.append(
                    f"{name}_count{_fmt_labels(lbl)} {_fmt_value(v)}")
            elif "le" in lbl:
                lines.append(
                    f"{name}_bucket{_fmt_labels(lbl)} {_fmt_value(v)}")
            else:
                lines.append(f"{name}{_fmt_labels(lbl)} {_fmt_value(v)}")
    return "\n".join(lines) + "\n"


def write_prometheus(path,
                     registry: _metrics.MetricsRegistry | None = None,
                     ) -> None:
    with open(path, "w") as f:
        f.write(prometheus_text(registry))


def metrics_snapshot(registry: _metrics.MetricsRegistry | None = None,
                     ) -> dict:
    """JSON-ready snapshot of every metric (collectors included)."""
    reg = registry if registry is not None else _metrics.REGISTRY
    return reg.collect()
