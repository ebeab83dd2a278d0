"""Named counters / gauges / histograms on a process-global registry.

Prometheus-shaped but dependency-free: a metric has a name, a help
string, and optional label names; ``labels(**kv)`` returns a child
whose ``inc``/``set``/``observe`` is a couple of float ops (hot call
sites should cache the child).  Unlike spans, metrics are always on —
an increment is too cheap to gate.

``register_collector`` hangs a callback that runs at ``collect()``
time, for surfaces that already keep their own counters (the PR-8
plan-cache ledger, ``ServeEngine.plan_report()``): the existing
bookkeeping stays canonical and is *re-expressed* as gauges on scrape
instead of being double-counted on the hot path.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "register_collector",
    "collect",
    "reset",
]

_DEFAULT_BUCKETS = (
    1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 5.0, 10.0, math.inf)


def _check_labels(labelnames: Sequence[str], kv: dict) -> tuple:
    if set(kv) != set(labelnames):
        raise ValueError(
            f"labels {sorted(kv)} do not match declared {sorted(labelnames)}")
    return tuple(str(kv[k]) for k in labelnames)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, _Metric] = {}
        self._lock = threading.Lock()

    def labels(self, **kv) -> "_Metric":
        key = _check_labels(self.labelnames, kv)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    key, type(self)(self.name, self.help))
        return child

    def samples(self) -> list[tuple[dict, float]]:
        raise NotImplementedError

    def _labelled_samples(self) -> list[tuple[dict, float]]:
        if not self.labelnames:
            return self.samples()
        out = []
        for key, child in sorted(self._children.items()):
            lbl = dict(zip(self.labelnames, key))
            out.extend((dict(lbl, **extra), v)
                       for extra, v in child.samples())
        return out

    def _reset(self) -> None:
        self._children.clear()


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += amount

    def samples(self):
        return [({}, self.value)]

    def _reset(self) -> None:
        super()._reset()
        self.value = 0.0


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount

    def samples(self):
        return [({}, self.value)]

    def _reset(self) -> None:
        super()._reset()
        self.value = 0.0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(buckets))
        if not bs or bs[-1] != math.inf:
            bs = bs + (math.inf,)
        self.buckets = bs
        self._counts = [0] * len(bs)
        self.sum = 0.0
        self.count = 0

    def labels(self, **kv) -> "Histogram":
        key = _check_labels(self.labelnames, kv)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    key, Histogram(self.name, self.help,
                                   buckets=self.buckets))
        return child  # type: ignore[return-value]

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, b in enumerate(self.buckets):
            if value <= b:
                self._counts[i] += 1
                break

    def samples(self):
        out, cum = [], 0
        for b, c in zip(self.buckets, self._counts):
            cum += c
            le = "+Inf" if b == math.inf else repr(b)
            out.append(({"le": le}, float(cum)))
        out.append(({"__sum__": ""}, self.sum))
        out.append(({"__count__": ""}, float(self.count)))
        return out

    def _reset(self) -> None:
        super()._reset()
        self._counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0


class MetricsRegistry:
    """Get-or-create registry; re-registering with a different type or
    label set is an error (the Prometheus exposition would be garbage)."""

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[["MetricsRegistry"], None]] = []
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, labelnames: Sequence[str],
             **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kw)
                self._metrics[name] = m
                return m
        if type(m) is not cls or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with "
                f"labels {m.labelnames}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)  # type: ignore

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)  # type: ignore

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames,  # type: ignore
                         buckets=buckets)

    def register_collector(
            self, fn: Callable[["MetricsRegistry"], None]) -> None:
        """Run ``fn(registry)`` at every ``collect()`` — pull-style
        metrics for surfaces that keep their own counters."""
        self._collectors.append(fn)

    def run_collectors(self) -> None:
        for fn in list(self._collectors):
            fn(self)

    def collect(self) -> dict[str, dict]:
        """{name: {kind, help, labelnames, samples}} snapshot."""
        self.run_collectors()
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out[name] = {
                "kind": m.kind,
                "help": m.help,
                "labelnames": list(m.labelnames),
                "samples": [(lbl, v) for lbl, v in m._labelled_samples()],
            }
        return out

    def metrics(self) -> dict[str, _Metric]:
        return dict(self._metrics)

    def reset(self) -> None:
        """Zero every metric value (registrations and collectors stay)."""
        for m in self._metrics.values():
            m._reset()

    def clear(self) -> None:
        """Drop registrations *and* collectors (tests only)."""
        self._metrics.clear()
        self._collectors.clear()


REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "",
              labelnames: Sequence[str] = (),
              buckets: Sequence[float] = _DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets)


def register_collector(fn: Callable[[MetricsRegistry], None]) -> None:
    REGISTRY.register_collector(fn)


def collect() -> dict[str, dict]:
    return REGISTRY.collect()


def reset() -> None:
    REGISTRY.reset()
