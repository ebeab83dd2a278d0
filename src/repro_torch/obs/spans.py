"""Monotonic-clock span recorder on a preallocated ring buffer.

A *span* is one timed region of the runtime (a ``plan_chain`` call, one
decode step, one executed stage).  The recorder is built for hot paths:

* ``begin``/``end`` write into preallocated parallel slot lists — no
  per-span object is allocated while recording (the ``Span`` dataclass
  only materializes at ``drain()``/``snapshot()`` time);
* nesting depth is tracked per thread on a preallocated stack, so spans
  render as a properly nested flame graph in Perfetto;
* the buffer is a fixed-capacity ring: when full, the oldest spans are
  overwritten and counted in ``dropped`` rather than growing memory.

Recording is **off by default**.  ``enable()`` flips a module-level flag
checked by every helper, so an un-instrumented process pays one dict
lookup + one ``if`` per call site.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Iterator

__all__ = [
    "Span",
    "SpanRecorder",
    "enable",
    "disable",
    "enabled",
    "recorder",
    "begin",
    "end",
    "span",
]

_MAX_DEPTH = 64


@dataclass(frozen=True)
class Span:
    """One completed span (materialized only on drain/snapshot)."""

    name: str
    cat: str
    t0: float  # perf_counter seconds
    t1: float
    depth: int
    tid: int

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class _ThreadState(threading.local):
    def __init__(self) -> None:
        # preallocated per-thread begin stack: (name, cat, t0) slots
        self.names: list[str | None] = [None] * _MAX_DEPTH
        self.cats: list[str | None] = [None] * _MAX_DEPTH
        self.t0s: list[float] = [0.0] * _MAX_DEPTH
        self.depth = 0


class SpanRecorder:
    """Fixed-capacity ring buffer of completed spans."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._names: list[str | None] = [None] * capacity
        self._cats: list[str | None] = [None] * capacity
        self._t0s = [0.0] * capacity
        self._t1s = [0.0] * capacity
        self._depths = [0] * capacity
        self._tids = [0] * capacity
        self._recorded = 0  # total spans ever committed (monotone)
        self.dropped = 0  # spans overwritten before being drained
        self._lock = threading.Lock()
        self._tls = _ThreadState()

    # -- hot path ----------------------------------------------------------

    def begin(self, name: str, cat: str = "runtime") -> None:
        tls = self._tls
        d = tls.depth
        if d < _MAX_DEPTH:
            tls.names[d] = name
            tls.cats[d] = cat
            tls.t0s[d] = time.perf_counter()
        tls.depth = d + 1

    def end(self) -> None:
        t1 = time.perf_counter()
        tls = self._tls
        d = tls.depth - 1
        if d < 0:  # unmatched end() (e.g. toggled mid-span): ignore
            return
        tls.depth = d
        if d >= _MAX_DEPTH:  # was too deep to record; just unwind
            return
        with self._lock:
            i = self._recorded % self.capacity
            if self._recorded >= self.capacity:
                self.dropped += 1
            self._names[i] = tls.names[d]
            self._cats[i] = tls.cats[d]
            self._t0s[i] = tls.t0s[d]
            self._t1s[i] = t1
            self._depths[i] = d
            self._tids[i] = threading.get_ident()
            self._recorded += 1

    def span(self, name: str, cat: str = "runtime") -> "_SpanCM":
        return _SpanCM(self, name, cat)

    # -- cold path ---------------------------------------------------------

    def __len__(self) -> int:
        return min(self._recorded, self.capacity)

    def _rows(self) -> Iterator[Span]:
        n = min(self._recorded, self.capacity)
        start = self._recorded - n
        for k in range(start, self._recorded):
            i = k % self.capacity
            yield Span(
                name=self._names[i] or "",
                cat=self._cats[i] or "",
                t0=self._t0s[i],
                t1=self._t1s[i],
                depth=self._depths[i],
                tid=self._tids[i],
            )

    def snapshot(self) -> list[Span]:
        """Completed spans, oldest first, without resetting the buffer."""
        with self._lock:
            return list(self._rows())

    def drain(self) -> list[Span]:
        """Return completed spans (oldest first) and reset the buffer.

        ``dropped`` keeps accumulating across drains so overflow is
        visible even if every drain arrives late.
        """
        with self._lock:
            out = list(self._rows())
            self._recorded = 0
            return out


class _SpanCM:
    __slots__ = ("_rec", "_name", "_cat")

    def __init__(self, rec: SpanRecorder, name: str, cat: str):
        self._rec = rec
        self._name = name
        self._cat = cat

    def __enter__(self) -> "_SpanCM":
        self._rec.begin(self._name, self._cat)
        return self

    def __exit__(self, *exc) -> None:
        self._rec.end()


# -- module-level default recorder (disabled until enable()) ---------------

_DEFAULT: SpanRecorder | None = None


def enable(capacity: int | None = None) -> SpanRecorder:
    """Turn on span recording; idempotent unless ``capacity`` changes."""
    global _DEFAULT
    if _DEFAULT is None or (capacity is not None
                            and capacity != _DEFAULT.capacity):
        _DEFAULT = SpanRecorder(capacity or 4096)
    return _DEFAULT


def disable() -> None:
    global _DEFAULT
    _DEFAULT = None


def enabled() -> bool:
    return _DEFAULT is not None


def recorder() -> SpanRecorder | None:
    return _DEFAULT


def begin(name: str, cat: str = "runtime") -> None:
    rec = _DEFAULT
    if rec is not None:
        rec.begin(name, cat)


def end() -> None:
    rec = _DEFAULT
    if rec is not None:
        rec.end()


class _MaybeSpan:
    """Context manager over the *default* recorder; no-op when disabled.

    The recorder is looked up at ``__enter__`` and pinned, so an
    enable/disable flip mid-span cannot unbalance a stack.
    """

    __slots__ = ("_name", "_cat", "_rec")

    def __init__(self, name: str, cat: str):
        self._name = name
        self._cat = cat
        self._rec: SpanRecorder | None = None

    def __enter__(self) -> "_MaybeSpan":
        rec = _DEFAULT
        self._rec = rec
        if rec is not None:
            rec.begin(self._name, self._cat)
        return self

    def __exit__(self, *exc) -> None:
        if self._rec is not None:
            self._rec.end()


def span(name: str, cat: str = "runtime") -> _MaybeSpan:
    return _MaybeSpan(name, cat)
