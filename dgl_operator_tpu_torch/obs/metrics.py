"""Metrics registry — counters, gauges and fixed-bucket histograms with
labels, held in memory, with a JSON-able :meth:`MetricsRegistry.snapshot`
and its Prometheus text exposition (:func:`render_prometheus`, what the
serving plane's ``/metrics`` answers). Writing snapshots to files and
merging them across processes is not ported yet.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

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


def _fmt(v: float) -> str:
    """Prometheus sample-value formatting: integral values render as
    integers (``3``, not ``3.0``); the rest use Python's shortest
    round-trip repr."""
    f = float(v)
    if math.isfinite(f) and f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


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

    def inc(self, amount: float = 1, **labels) -> None:
        with self._lock:
            k = self._key(labels)
            self._samples[k] = float(self._samples.get(k, 0.0)) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._samples.get(self._key(labels), 0.0))


class Histogram(_Metric):
    """Fixed-bucket histogram; buckets are upper bounds (le), with an
    implicit +Inf overflow bucket. Counts are stored per bucket and
    rendered cumulative, per the Prometheus exposition contract."""

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

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Bucket-interpolated quantile estimate (the Prometheus
        ``histogram_quantile`` rule); None with no observations."""
        with self._lock:
            s = self._samples.get(self._key(labels))
            counts = list(s["counts"]) if s else []
        return quantile_from_counts(self.buckets, counts, q)


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

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        """JSON-able view of every family (the JAX package's
        ``metrics.json`` exchange format)."""
        out: Dict[str, dict] = {}
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                fam: dict = {"type": m.kind, "help": m.help,
                             "label_names": list(m.label_names)}
                if isinstance(m, Histogram):
                    fam["buckets"] = list(m.buckets)
                samples = []
                for key, val in sorted(m._samples.items()):
                    s = {"labels": dict(zip(m.label_names, key))}
                    if isinstance(m, Histogram):
                        s.update(counts=list(val["counts"]),
                                 sum=val["sum"], count=val["count"])
                    else:
                        s["value"] = val
                    samples.append(s)
                fam["samples"] = samples
                out[name] = fam
        return out

    def to_prometheus(self) -> str:
        return render_prometheus(self.snapshot())

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


# ----------------------------------------------------------------------
def quantile_from_counts(buckets: Sequence[float],
                         counts: Sequence[int],
                         q: float) -> Optional[float]:
    """Estimate quantile ``q`` from per-bucket (non-cumulative) counts:
    linear interpolation inside the landing bucket (lower bound 0 for
    the first, the last finite bound for the +Inf overflow). None when
    there are no observations."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = sum(counts)
    if not counts or total == 0:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        prev_cum, cum = cum, cum + c
        if cum >= rank and c > 0:
            if i >= len(buckets):        # +Inf overflow bucket
                return float(buckets[-1])
            lo = 0.0 if i == 0 else float(buckets[i - 1])
            hi = float(buckets[i])
            frac = (rank - prev_cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    return float(buckets[-1])


def render_quantile_gauges(snapshot: Dict[str, dict],
                           families: Sequence[str] = (
                               "serve_request_seconds",
                               "serve_forward_seconds"),
                           name: str = "serve_quantile_seconds",
                           quantiles: Sequence[float] = (0.5, 0.95,
                                                         0.99)) -> str:
    """p50/p95/p99 gauges derived from histogram snapshots, appended to
    ``/metrics`` so a scraper without a ``histogram_quantile`` rule
    reads the latency quantiles directly. Families with no observations
    are omitted."""
    lines: List[str] = []
    for fname in families:
        fam = snapshot.get(fname)
        if not fam or fam.get("type") != "histogram" \
                or not fam.get("samples"):
            continue
        buckets = fam.get("buckets", [])
        counts = [0] * (len(buckets) + 1)
        for s in fam["samples"]:
            for i, c in enumerate(s.get("counts", [])):
                counts[i] += c
        values = [(q, quantile_from_counts(buckets, counts, q))
                  for q in quantiles]
        values = [(q, v) for q, v in values if v is not None]
        if not values:
            continue
        if not lines:
            lines.append(f"# HELP {name} bucket-interpolated latency "
                         "quantiles derived from the histogram "
                         "families")
            lines.append(f"# TYPE {name} gauge")
        for q, v in values:
            lines.append(
                f'{name}{{family="{_escape(fname)}",'
                f'quantile="{_fmt(q)}"}} {_fmt(v)}')
    return "\n".join(lines) + ("\n" if lines else "")


def render_prometheus(snapshot: Dict[str, dict]) -> str:
    """Prometheus text exposition (version 0.0.4) of a snapshot."""
    lines: List[str] = []
    for name in sorted(snapshot):
        fam = snapshot[name]
        if fam.get("help"):
            lines.append(f"# HELP {name} "
                         + str(fam["help"]).replace("\\", r"\\")
                         .replace("\n", r"\n"))
        lines.append(f"# TYPE {name} {fam['type']}")
        label_names = fam.get("label_names", [])

        def pairs(labels, extra=()):
            items = [(ln, labels.get(ln, "")) for ln in label_names]
            items += list(extra)
            if not items:
                return ""
            body = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
            return "{" + body + "}"

        for s in fam.get("samples", []):
            labels = s.get("labels", {})
            if fam["type"] == "histogram":
                cum = 0
                bounds = [_fmt(b) for b in fam.get("buckets", [])]
                for bound, c in zip(bounds + ["+Inf"], s["counts"]):
                    cum += c
                    lines.append(f"{name}_bucket"
                                 f"{pairs(labels, [('le', bound)])} "
                                 f"{_fmt(cum)}")
                lines.append(f"{name}_sum{pairs(labels)} "
                             f"{_fmt(s['sum'])}")
                lines.append(f"{name}_count{pairs(labels)} "
                             f"{_fmt(s['count'])}")
            else:
                lines.append(f"{name}{pairs(labels)} "
                             f"{_fmt(s['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")
