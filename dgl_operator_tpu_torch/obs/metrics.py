"""Metrics registry — counters, gauges and fixed-bucket histograms with
labels, held in memory. Writing them out (Prometheus text, JSON
snapshots merged across processes) is not ported yet.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Dict, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# duration buckets (seconds) spanning sub-ms host ops to 10-minute
# phases
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
                   600.0)

# request-latency buckets (seconds) for the serving plane: dense
# through the single-digit-millisecond band where a warm request lands
LATENCY_BUCKETS = (0.0005, 0.001, 0.002, 0.003, 0.005, 0.0075, 0.01,
                   0.015, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 1.0,
                   2.5, 5.0, 10.0)


class _Metric:
    kind = ""

    def __init__(self, name: str, help: str, label_names: Sequence[str],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(label_names)
        for ln in self.label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"bad label name {ln!r} for {name}")
        self._lock = lock
        self._samples: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name} takes labels {list(self.label_names)}, "
                f"got {sorted(labels)}")
        return tuple(str(labels[n]) for n in self.label_names)


class Counter(_Metric):
    """Monotone accumulator; ``inc`` rejects negative amounts."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc "
                             f"{amount}")
        with self._lock:
            k = self._key(labels)
            self._samples[k] = float(self._samples.get(k, 0.0)) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._samples.get(self._key(labels), 0.0))


class Gauge(_Metric):
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._samples[self._key(labels)] = float(value)


class Histogram(_Metric):
    """Fixed-bucket histogram; buckets are upper bounds (le), with an
    implicit +Inf overflow bucket."""

    kind = "histogram"

    def __init__(self, name, help, label_names, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, label_names, lock)
        bs = tuple(float(b) for b in buckets)
        if not bs or list(bs) != sorted(set(bs)) or \
                not all(math.isfinite(b) for b in bs):
            raise ValueError(f"histogram {name}: buckets must be a "
                             f"finite strictly-increasing sequence, "
                             f"got {buckets}")
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        with self._lock:
            k = self._key(labels)
            s = self._samples.get(k)
            if s is None:
                s = self._samples[k] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0}
            s["counts"][bisect.bisect_left(self.buckets, v)] += 1
            s["sum"] += v
            s["count"] += 1


class MetricsRegistry:
    """Get-or-create metric families; name/type/label collisions raise
    at creation (a silent second family would fork the data)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name, help, labels, **kw) -> _Metric:
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labels,
                                              self._lock, **kw)
                return m
        if not isinstance(m, cls):
            raise ValueError(f"metric {name} already registered as "
                             f"{m.kind}, not {cls.kind}")
        if m.label_names != tuple(labels):
            raise ValueError(
                f"metric {name} registered with labels "
                f"{list(m.label_names)}, got {list(labels)}")
        if help and not m.help:
            m.help = help
        return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)
