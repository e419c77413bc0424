"""Live rolling-window serving metrics for ``/livez``.

The serving half of the JAX package's ``LiveFeed``: the serving plane
adds nothing per request; rolling qps and windowed p50/p95/p99 are
derived on read by differencing snapshots of the metrics registry (the
latency histogram's bucket counts are cumulative, so a window's
quantiles come from the bucket-count deltas between its edges,
:func:`~.metrics.quantile_from_counts`). Trainer heartbeats, the HTTP
sidecar and endpoint registration are not ported.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

from dgl_operator_tpu_torch.obs.metrics import quantile_from_counts

DEFAULT_WINDOW_S = 10.0
_LAT_FAMILY = "serve_request_seconds"


def _delta(end: float, start: float) -> float:
    """Cumulative-counter delta that survives a reset: a value that went
    down restarted from 0, so the window's delta is the end value."""
    d = end - start
    return d if d >= 0 else end


class LiveFeed:
    """Per-plane rolling-window aggregator over registry snapshots.
    Thread-safe; ``clock`` injectable for tests."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 clock: Callable[[], float] = time.time):
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        # (ts, requests, shed, lat_buckets, lat_counts) registry
        # extracts, ringed so a read can difference against the
        # window's far edge
        self._reg: deque = deque(maxlen=256)

    @staticmethod
    def _extract(reg_snapshot: Dict[str, dict]
                 ) -> Tuple[float, float, Tuple[float, ...], list]:
        def counter(name: str) -> float:
            fam = reg_snapshot.get(name) or {}
            return float(sum(s.get("value", 0)
                             for s in fam.get("samples", [])))

        fam = reg_snapshot.get(_LAT_FAMILY) or {}
        buckets = tuple(fam.get("buckets") or ())
        counts = [0] * (len(buckets) + 1)
        for s in fam.get("samples", []):
            for i, c in enumerate(s.get("counts", [])):
                counts[i] += c
        return (counter("serve_requests_total"),
                counter("serve_requests_shed_total"), buckets, counts)

    def snapshot(self, registry=None,
                 window_s: Optional[float] = None) -> Dict:
        """The rolling-window aggregate. Keys are None while the window
        holds no signal yet (an idle feed never reports a bogus 0
        rate)."""
        w = float(window_s or self.window_s)
        now = self._clock()
        out: Dict = {"ts": round(now, 3), "window_s": w, "done": False}
        if registry is not None:
            out.update(self._serve_stats(registry.snapshot(), now, w))
        return out

    def _serve_stats(self, reg_snapshot, now: float, w: float) -> Dict:
        cur = self._extract(reg_snapshot)
        with self._lock:
            base = None
            for rec in self._reg:
                if rec[0] <= now - w:
                    base = rec
                else:
                    break
            if base is None and self._reg:
                base = self._reg[0]
            if base is not None and (
                    cur[0] < base[1]
                    or (len(base[4]) == len(cur[3])
                        and any(a < b
                                for a, b in zip(cur[3], base[4])))):
                # the registry was reset (an engine restart): every
                # earlier record describes a dead incarnation, so the
                # window restarts at the new one
                self._reg.clear()
                base = None
            self._reg.append((now, *cur))
        out: Dict = {"qps": None, "p50_ms": None, "p95_ms": None,
                     "p99_ms": None,
                     "requests_total": int(cur[0]),
                     "shed_total": int(cur[1])}
        if base is None:
            return out
        dt = now - base[0]
        if dt <= 0:
            return out
        out["qps"] = round(_delta(cur[0], base[1]) / dt, 3)
        # windowed quantiles: bucket-count deltas between the window's
        # edges (a bucket layout that appeared mid-window falls back to
        # all-time counts)
        if len(base[4]) == len(cur[3]):
            counts = [max(a - b, 0) for a, b in zip(cur[3], base[4])]
        else:
            counts = cur[3]
        for q, key in ((0.5, "p50_ms"), (0.95, "p95_ms"),
                       (0.99, "p99_ms")):
            v = quantile_from_counts(cur[2], counts, q)
            out[key] = round(v * 1e3, 3) if v is not None else None
        return out
