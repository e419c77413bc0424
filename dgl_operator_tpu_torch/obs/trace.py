"""Trace spans — a nestable, ``perf_counter``-based span API exported
as Chrome trace-event JSON (``trace.json``), loadable in Perfetto /
``chrome://tracing``.

Spans record complete ("X") events: epoch-anchored microsecond
timestamps plus duration, keyed by (pid, tid) so nesting falls out of
containment on the same thread track and the driver + each trainer
subprocess appear as separate process tracks in one merged file.

Standard library only.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

from dgl_operator_tpu_torch.obs._io import atomic_write, dir_lock, read_json

TRACE_JSON = "trace.json"


class Tracer:
    def __init__(self, process_name: Optional[str] = None,
                 pid: Optional[int] = None):
        self.pid = os.getpid() if pid is None else pid
        self.process_name = process_name
        self._lock = threading.Lock()
        self._events: List[Dict[str, object]] = []
        # maps perf_counter() readings onto the wall clock so every
        # process's spans land on one shared timeline in the merged file
        self._epoch0 = time.time() - time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", **args):
        """Time a block as one complete trace event; nest freely."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.complete(name, t0, time.perf_counter(), cat=cat, **args)

    @staticmethod
    def _stamp_trace(args: Dict[str, object]) -> Dict[str, object]:
        """Fold the active trace context (obs/tracectx.py) into a
        span's args, so every span recorded while a request/step
        context is live joins its trace tree: the active span becomes
        this record's PARENT (plain spans carry no id of their own).
        Spans with explicit ids (tracectx.span's records) pass
        through untouched."""
        if "trace_id" in args:
            return args
        from dgl_operator_tpu_torch.obs.tracectx import current
        ctx = current()
        if ctx is not None:
            args = dict({"trace_id": ctx.trace_id,
                         "parent_id": ctx.span_id}, **args)
        return args

    def complete(self, name: str, t0: float, t1: float, cat: str = "",
                 **args) -> None:
        """Record a span from explicit ``perf_counter()`` endpoints —
        for call sites that already hold their own timestamps."""
        args = self._stamp_trace(args)
        ev: Dict[str, object] = {
            "name": name, "cat": cat or "obs", "ph": "X",
            "ts": round((self._epoch0 + t0) * 1e6, 1),
            "dur": max(round((t1 - t0) * 1e6, 1), 0.0),
            "pid": self.pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def counter(self, name: str, series: Dict[str, float],
                cat: str = "prof") -> None:
        """Chrome counter-track sample (``ph="C"``): Perfetto renders
        each named counter as a stacked value track under the process'
        span rows — how the profiler (obs/prof.py) shows MFU and the
        HBM watermark directly beneath the step spans. ``series`` maps
        series label -> value; samples on the same name accumulate
        into one track."""
        ev: Dict[str, object] = {
            "name": name, "cat": cat or "prof", "ph": "C",
            "ts": round(time.time() * 1e6, 1),
            "pid": self.pid, "tid": 0,
            "args": {k: float(v) for k, v in series.items()}}
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, cat: str = "", **args) -> None:
        """Zero-duration marker (faults, kills) on this thread's track."""
        args = self._stamp_trace(args)
        ev: Dict[str, object] = {
            "name": name, "cat": cat or "obs", "ph": "i", "s": "t",
            "ts": round(time.time() * 1e6, 1),
            "pid": self.pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def chrome(self) -> Dict[str, object]:
        """This process's events in Chrome trace-event JSON object form
        (a process_name metadata record labels the track)."""
        evs: List[Dict[str, object]] = []
        if self.process_name:
            evs.append({"name": "process_name", "ph": "M",
                        "pid": self.pid, "tid": 0,
                        "args": {"name": self.process_name}})
        with self._lock:
            evs.extend(self._events)
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


def write_chrome(directory: str, tracer: Tracer) -> None:
    """Publish this process's spans into the run's shared
    ``trace.json``: other processes' events are kept, this pid's are
    replaced (re-flushing is idempotent). Runs under the obs directory
    lock; the write is atomic."""
    path = os.path.join(directory, TRACE_JSON)
    own = tracer.chrome()
    with dir_lock(directory):
        old = read_json(path, {})
        others = [e for e in old.get("traceEvents", [])
                  if isinstance(e, dict) and e.get("pid") != tracer.pid]
        atomic_write(path, json.dumps(
            {"traceEvents": others + own["traceEvents"],
             "displayTimeUnit": "ms"}, indent=1))
