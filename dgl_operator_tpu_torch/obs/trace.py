"""Trace spans — a ``perf_counter``-based span record exported as
Chrome trace-event JSON (``trace.json``), loadable in Perfetto /
``chrome://tracing``, and the hot-path spans of the training loop.

Spans record complete ("X") events: epoch-anchored microsecond
timestamps plus duration, keyed by (pid, tid) so nesting falls out of
containment on the same thread track and the driver + each trainer
subprocess appear as separate process tracks in one merged file.

:func:`hot_span` is the span of the per-call path (the loop's calls,
its epoch boundaries, the device run's staging and replays). It never
reaches ``trace.json``, which keeps every record of a process: while a
``torch.profiler`` is active it opens a ``record_function`` range, so
the span lies on the profiler's timeline above the kernels it
launched, and while the program's trace switch (``TPU_OPERATOR_TRACE``,
read by :func:`configure` when a trainer is built) is on it adds its
duration to a process-level aggregate per name (:func:`snapshot`).
With neither, it costs a flag check and the profiler's own check. The
switch also turns on the device sampler's phase counters
(``runtime/graphs.py::PhaseClock``), which :func:`add_phases`
accumulates here.

The spans, dotted and stable (``runtime/loop.py::run_epochs`` and
``runtime/graphs.py``):

- each call: ``loop.wait`` and ``loop.call`` (the ``PhaseTimer``'s
  wait and ``dispatch`` buckets: profiler ranges only, the timer keeps
  their times), ``loop.loss_fetch`` (the ``train_step`` event and its
  fetch of the call's last loss, every ``log_every`` steps: a sync),
  ``loop.ckpt``, ``loop.sentry`` (the sentry's tap) and
  ``loop.heartbeat`` (all of ``heartbeat()``);
- each epoch: ``epoch.permute`` (``permute(rng)`` with the calls'
  set-up), then, at its end, ``epoch.drain``, ``epoch.losses`` (a
  sync), ``epoch.eval``, ``epoch.record`` (with its flush) and
  ``epoch.ckpt``; the epoch itself is the profiler range ``epoch N``;
- the device run: ``devrun.stage`` (the epoch's ids into the bank),
  ``devrun.replay``, ``devrun.eager``, ``devrun.capture`` (once) and
  ``devrun.phases`` (the read of the phase counters).

``train``, ``epoch N``, the timer's buckets and every
``tracectx.span`` are profiler ranges only: their records stay where
they were. The phase counters are device µs per phase (``sample``,
``model``, ``sentry``, ``update``) over the sampled steps read; each is
the interval between two timing events of a replay, so the card's gaps
between the graph's consecutive kernels fall into the phase they lie
in.

Standard library only: ``torch`` is looked up once it is loaded.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from dgl_operator_tpu_torch.obs._io import atomic_write, dir_lock, read_json

TRACE_JSON = "trace.json"
# the program's trace switch: "1" turns on the span aggregates and the
# device sampler's phase counters
TRACE_ENV = "TPU_OPERATOR_TRACE"
# the device sampler's step phases, in the order they run
PHASES = ("sample", "model", "sentry", "update")

_switch = False
_agg_lock = threading.Lock()
# span name -> [count, seconds, longest seconds]; never reset
_spans: Dict[str, List[float]] = {}
# phase -> device µs, and the steps they were read over; never reset
_phase_us: Dict[str, float] = dict.fromkeys(PHASES, 0.0)
_phase_steps = 0
# torch.autograd._profiler_enabled, once torch is loaded
_profiler_enabled: Optional[Callable[[], bool]] = None


def configure(environ=None) -> bool:
    """Read the trace switch from ``TPU_OPERATOR_TRACE`` (any value but
    empty or ``0`` turns it on); trainers call this when they are
    built. Returns the switch."""
    global _switch
    environ = os.environ if environ is None else environ
    _switch = environ.get(TRACE_ENV, "").strip() not in ("", "0")
    return _switch


def tracing() -> bool:
    """Whether the trace switch is on."""
    return _switch


def _profiling() -> bool:
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        _profiler_enabled = torch.autograd._profiler_enabled
    return _profiler_enabled()


class _HotSpan:
    __slots__ = ("name", "aggregate", "_range", "_t0")

    def __init__(self, name: str, aggregate: bool):
        self.name = name
        self.aggregate = aggregate

    def __enter__(self) -> "_HotSpan":
        self._range = None
        if _profiling():
            from torch.profiler import record_function
            self._range = record_function(self.name)
            self._range.__enter__()
        self._t0 = (time.perf_counter() if self.aggregate and _switch
                    else None)
        return self

    def __exit__(self, *exc) -> None:
        if self._t0 is not None:
            dt = time.perf_counter() - self._t0
            with _agg_lock:
                agg = _spans.get(self.name)
                if agg is None:
                    _spans[self.name] = [1, dt, dt]
                else:
                    agg[0] += 1
                    agg[1] += dt
                    if dt > agg[2]:
                        agg[2] = dt
        if self._range is not None:
            self._range.__exit__(*exc)


_OFF = contextlib.nullcontext()


def hot_span(name: str, aggregate: bool = True):
    """A span of the per-call path (see the module's docstring): a
    profiler range while a profiler is active, and with the trace
    switch on (and ``aggregate``) one more count and duration of
    ``name`` in :func:`snapshot`. Names are dotted and stable; a name
    that varies (``epoch N``) passes ``aggregate=False``."""
    if _switch or _profiling():
        return _HotSpan(name, aggregate)
    return _OFF


def add_phases(us: Dict[str, float], steps: int) -> None:
    """Add one read of the device sampler's phase counters: device µs
    per phase over ``steps`` sampled steps."""
    global _phase_steps
    with _agg_lock:
        for phase, v in us.items():
            _phase_us[phase] += v
        _phase_steps += int(steps)


def snapshot() -> Dict[str, Dict]:
    """The process's aggregates so far: ``spans`` (name -> ``count``,
    ``seconds``, ``max_s``) and ``phases`` (``us`` per phase, the
    ``steps`` read). They are never reset: a reader takes two snapshots
    and subtracts (:func:`window`)."""
    with _agg_lock:
        return {"spans": {n: {"count": int(c), "seconds": s, "max_s": m}
                          for n, (c, s, m) in _spans.items()},
                "phases": {"us": dict(_phase_us), "steps": _phase_steps}}


def window(before: Dict[str, Dict], after: Dict[str, Dict]
           ) -> Dict[str, Dict]:
    """What two :func:`snapshot` readings differ by: each span's
    ``count`` and ``seconds`` (names that did not run are left out) and
    the phases' ``us`` and ``steps``. A ``max_s`` cannot be subtracted
    and is not given."""
    spans = {}
    for name, a in after["spans"].items():
        b = before["spans"].get(name, {"count": 0, "seconds": 0.0})
        if a["count"] > b["count"]:
            spans[name] = {"count": a["count"] - b["count"],
                           "seconds": a["seconds"] - b["seconds"]}
    ph_a, ph_b = after["phases"], before["phases"]
    return {"spans": spans,
            "phases": {"us": {p: ph_a["us"][p] - ph_b["us"][p]
                              for p in PHASES},
                       "steps": ph_a["steps"] - ph_b["steps"]}}


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
