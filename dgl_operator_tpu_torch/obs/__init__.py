"""In-memory telemetry: a metrics registry, an event list and timed
spans, one bundle per process (:func:`get_obs`).

Everything stays in memory and is bounded. A span recorded while a
trace context is active (``obs/tracectx.py``) carries its trace, span
and parent ids. File sinks are not ported yet, so :meth:`Obs.flush`
writes nothing.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Iterator, Optional

from dgl_operator_tpu_torch.obs import tracectx
from dgl_operator_tpu_torch.obs.metrics import (DEFAULT_BUCKETS,  # noqa: F401
                                                LATENCY_BUCKETS, Counter,
                                                Gauge, Histogram,
                                                MetricsRegistry)

# records kept per in-memory list; the oldest are dropped beyond it
MAX_RECORDS = 10_000
# the JAX package's names: its file plane's directory, and the role a
# launcher gives each trainer (host:pid:trainer-<rank>)
OBS_DIR_ENV = "TPU_OPERATOR_OBS_DIR"
OBS_ROLE_ENV = "TPU_OPERATOR_OBS_ROLE"


class Obs:
    """One process's telemetry: ``metrics``, ``events`` (dicts with a
    ``kind`` and a wall-clock ``ts``) and ``spans`` (dicts with a
    ``name`` and ``perf_counter`` start/end)."""

    def __init__(self):
        self.metrics = MetricsRegistry()
        self.events: collections.deque = collections.deque(
            maxlen=MAX_RECORDS)
        self.spans: collections.deque = collections.deque(
            maxlen=MAX_RECORDS)

    def emit(self, kind: str, **fields) -> None:
        self.events.append({"kind": kind, "ts": time.time(), **fields})

    def complete(self, name: str, t0: float, t1: float, **args) -> None:
        """Record a span that ran from ``t0`` to ``t1``
        (``time.perf_counter`` readings), stamped with the active trace
        context's ids."""
        self.spans.append({"name": name, "t0": t0, "t1": t1,
                           **tracectx.current_ids(), **args})

    def flush(self) -> None:
        """Publish telemetry to files: a no-op, as the port keeps its
        telemetry in memory."""

    @contextlib.contextmanager
    def span(self, name: str, **args) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.complete(name, t0, time.perf_counter(), **args)


_lock = threading.Lock()
_obs: Optional[Obs] = None


def get_obs() -> Obs:
    """The process-global :class:`Obs`, created on first use."""
    global _obs
    with _lock:
        if _obs is None:
            _obs = Obs()
        return _obs
