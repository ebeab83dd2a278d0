"""Runtime telemetry of the PyTorch port: spans, metrics, exporters, drift.

The port's own copies of the reference ``repro.obs``:

* :mod:`.spans` — monotonic-clock ring-buffer span recorder, off by
  default; ``obs.enable()`` turns recording on.
* :mod:`.metrics` — process-global counters / gauges / histograms with
  pull-style collectors.
* :mod:`.export` — the merged Perfetto timeline (live spans on pid 1
  beside ``sim.to_chrome_trace``'s modeled/measured tracks on pid 0),
  Prometheus text exposition, JSON snapshot.
* :mod:`.drift` — online modeled-vs-measured drift: executed segments
  become ``calib.Measurement`` rows with a rolling geomean ratio per
  (segment, target), flagged when it leaves the calibration band.

The planner, the executor registry, ``run_block`` and ``ServeEngine``
record through them.  Importing this package pulls neither torch nor jax
(``drift`` reads ``calib.measure``, which imports torch only inside its
timed functions).
"""
from . import drift, export, metrics, spans
from .drift import DEFAULT_BAND, DriftMonitor
from .export import (merged_chrome_trace, metrics_snapshot,
                     prometheus_text, write_merged_trace,
                     write_prometheus)
from .metrics import (REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry, collect, counter, gauge,
                      histogram, register_collector)
from .spans import (Span, SpanRecorder, begin, disable, enable, enabled,
                    end, recorder, span)

__all__ = [
    "spans", "metrics", "export", "drift",
    "Span", "SpanRecorder", "enable", "disable", "enabled", "recorder",
    "begin", "end", "span",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "register_collector", "collect",
    "merged_chrome_trace", "write_merged_trace", "prometheus_text",
    "write_prometheus", "metrics_snapshot",
    "DriftMonitor", "DEFAULT_BAND",
]
