"""Runtime telemetry of the PyTorch port: spans and metrics.

The port's own copies of ``repro.obs.spans`` (monotonic-clock ring-buffer
span recorder, off by default) and ``repro.obs.metrics`` (process-global
counters / gauges / histograms with pull-style collectors).  The
planner, the executor registry, ``run_block`` and ``ServeEngine`` record
through them.  Importing this package pulls neither torch nor jax.
"""
from . import metrics, spans
from .metrics import (REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry, collect, counter, gauge,
                      histogram, register_collector)
from .spans import (Span, SpanRecorder, begin, disable, enable, enabled,
                    end, recorder, span)

__all__ = [
    "spans", "metrics",
    "Span", "SpanRecorder", "enable", "disable", "enabled", "recorder",
    "begin", "end", "span",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "register_collector", "collect",
]
