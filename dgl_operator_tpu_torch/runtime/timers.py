"""Per-phase timing instrumentation for the training loop.

A copy of the JAX package's ``PhaseTimer`` (its wall-clock buckets and
per-bucket byte counters; the metric-registry folding is not ported).
The trainer's buckets are ``sample`` (host sampling done on the loop
thread: inline sampling), ``stall`` (time the loop thread waited on the
sampler pipeline for a batch that was not ready, and the chaos
``step:slow`` drag) and ``dispatch`` (the step: host-to-device copies,
then the enqueue of forward, backward and the optimizer update). Kernels
run asynchronously, so device time shows up in whichever host call next
waits for the card; the epoch wall clock is the throughput number.

The owner layout's exchange pipeline (``runtime/dist.py``) bills the
bytes of each exchange to ``exchange`` and records the exchange's and
the step's windows in an :class:`OverlapTracker`, which reports the
share of exchange time hidden under compute.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple


class PhaseTimer:
    """Accumulating named wall-clock buckets, with byte counters per
    bucket."""

    def __init__(self) -> None:
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.bytes: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def add_bytes(self, name: str, nbytes: int) -> None:
        """Attribute moved bytes to a bucket."""
        self.bytes[name] += int(nbytes)

    def reset(self) -> None:
        self.total.clear()
        self.count.clear()
        self.bytes.clear()

    def snapshot(self) -> Dict[str, Dict]:
        """A point-in-time copy for readers on other threads (the live
        feed samples it once per heartbeat)."""
        return {"total": dict(self.total), "count": dict(self.count),
                "bytes": dict(self.bytes)}

    def as_dict(self) -> Dict[str, float]:
        """Seconds per bucket."""
        return dict(self.total)


# ---------------------------------------------------------------------
Interval = Tuple[float, float]


def merge_intervals(spans: Iterable[Interval]) -> List[Interval]:
    """Union of ``(t0, t1)`` intervals as a sorted disjoint list (empty
    and inverted spans are dropped)."""
    spans = sorted((a, b) for a, b in spans if b > a)
    out: List[Interval] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap_seconds(a: Iterable[Interval], b: Iterable[Interval]) -> float:
    """Total seconds of ``union(a) ∩ union(b)``: the time stage A ran
    while stage B was also running."""
    ma, mb = merge_intervals(a), merge_intervals(b)
    i = j = 0
    total = 0.0
    while i < len(ma) and j < len(mb):
        lo = max(ma[i][0], mb[j][0])
        hi = min(ma[i][1], mb[j][1])
        if hi > lo:
            total += hi - lo
        if ma[i][1] <= mb[j][1]:
            i += 1
        else:
            j += 1
    return total


class OverlapTracker:
    """Exchange-against-compute interval bookkeeping of the owner
    layout's pipeline: each exchange's and each step's window, and
    :meth:`ratio`, the share of exchange time hidden under compute (the
    ``overlap_ratio`` of an epoch's record and of the heartbeat).
    Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.exchange: List[Interval] = []
        self.compute: List[Interval] = []

    def add_exchange(self, t0: float, t1: float) -> None:
        with self._lock:
            self.exchange.append((t0, t1))

    def add_compute(self, t0: float, t1: float) -> None:
        with self._lock:
            self.compute.append((t0, t1))

    def ratio(self) -> Optional[float]:
        """The hidden-exchange share in [0, 1]; None before any
        exchange was recorded. When every exchange window has zero
        length the verdict is point containment: 1.0 if every exchange
        instant fell inside a compute window, else 0.0. Inverted
        windows are dropped."""
        with self._lock:
            ex, co = list(self.exchange), list(self.compute)
        ex = [(a, b) for a, b in ex if b >= a]
        if not ex:
            return None
        total = sum(b - a for a, b in merge_intervals(ex))
        if total <= 0:
            mco = merge_intervals(co)
            hidden = all(any(ca <= p <= cb for ca, cb in mco)
                         for p, _ in ex)
            return 1.0 if hidden and mco else 0.0
        return min(overlap_seconds(ex, co) / total, 1.0)

    def reset(self) -> None:
        with self._lock:
            self.exchange.clear()
            self.compute.clear()
