"""Telemetry: a metrics registry, structured events and timed spans, one
bundle per process (:func:`get_obs`), and one ``obs/`` directory per run
shared by every process of that run.

Every :class:`Obs` keeps its recent events and spans in bounded
in-memory lists (``events``, ``spans``), which tests and the smoke read.
Rooted at a directory, it also writes the JAX package's file layout, so
either package's readers take the other's directories:

- ``events.jsonl`` — every :meth:`Obs.emit` appends one line at once,
  stamped with the run id, host, pid and role (``obs/events.py``);
- ``trace.json`` — spans as Chrome trace events on an epoch-anchored
  µs timeline, loadable in Perfetto (``obs/trace.py``);
- ``metrics.json`` / ``metrics.prom`` — every process's registry
  snapshot and their merged view, written by :meth:`Obs.flush`
  (``obs/metrics.py``).

The job plane reads those files: ``obs/collect.py`` merges every host's
directory into ``obs/job/``, ``obs/analyze.py`` and ``obs/doctor.py``
diagnose it, ``obs/xray.py`` splits its critical path, ``obs/top.py``
shows the live table and ``obs/prof.py`` the utilization. They are
imported directly, not re-exported here.

Process model: a driver calls :func:`obs_run` (or :func:`init_obs`) to
root the run's artifacts, by default under ``<workspace>/obs``, and
exports ``TPU_OPERATOR_OBS_DIR`` / ``TPU_OPERATOR_OBS_RUN``, so every
process it starts attaches to the same run through :func:`get_obs`.
Flushes are per-process idempotent merges, so a killed trainer's last
flush and its resumed successor's both land. Telemetry never fails the
job: a failed write is logged and the run goes on.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import os
import socket
import threading
import time
import uuid
from typing import Iterator, Optional

from dgl_operator_tpu_torch.obs import tracectx
from dgl_operator_tpu_torch.obs import metrics as _metrics_mod
from dgl_operator_tpu_torch.obs.events import (EVENTS_JSONL,  # noqa: F401
                                               EventLog)
from dgl_operator_tpu_torch.obs.metrics import (DEFAULT_BUCKETS,  # noqa: F401
                                                LATENCY_BUCKETS, METRICS_JSON,
                                                METRICS_PROM, Counter,
                                                Gauge, Histogram,
                                                MetricsRegistry,
                                                merge_snapshots,
                                                quantile_from_counts,
                                                render_prometheus)
from dgl_operator_tpu_torch.obs.trace import (TRACE_JSON, Tracer,  # noqa: F401
                                              write_chrome)

# records kept per in-memory list; the oldest are dropped beyond it
MAX_RECORDS = 10_000
OBS_DIR_ENV = "TPU_OPERATOR_OBS_DIR"
OBS_RUN_ENV = "TPU_OPERATOR_OBS_RUN"
# the role a launcher gives each trainer (host:pid:trainer-<rank>)
OBS_ROLE_ENV = "TPU_OPERATOR_OBS_ROLE"


def _gen_run_id() -> str:
    return time.strftime("%Y%m%dT%H%M%S") + "-" + uuid.uuid4().hex[:6]


class Obs:
    """One process's telemetry: ``metrics``, ``events`` (dicts with a
    ``kind`` and a wall-clock ``ts``) and ``spans`` (dicts with a
    ``name`` and ``perf_counter`` start/end), and, given a
    ``directory``, the run's files (``event_log``, ``tracer``). Without
    a directory everything stays in memory and :meth:`flush` is a
    no-op."""

    def __init__(self, directory: Optional[str] = None,
                 run_id: Optional[str] = None, role: str = "main",
                 console: bool = True):
        self.directory = os.path.abspath(directory) if directory else None
        if self.directory:
            try:
                os.makedirs(self.directory, exist_ok=True)
            except OSError as exc:
                print(f"obs: cannot create {self.directory} ({exc}); "
                      "telemetry stays in-memory", flush=True)
                self.directory = None
        self.run_id = run_id or _gen_run_id()
        self.role = role
        self.host = socket.gethostname()
        self.pid = os.getpid()
        self.metrics = MetricsRegistry()
        self.events: collections.deque = collections.deque(
            maxlen=MAX_RECORDS)
        self.spans: collections.deque = collections.deque(
            maxlen=MAX_RECORDS)
        self.event_log = EventLog(
            path=(os.path.join(self.directory, EVENTS_JSONL)
                  if self.directory else None),
            console=console,
            base={"run": self.run_id, "host": self.host, "pid": self.pid,
                  "role": role})
        self.tracer = Tracer(process_name=f"{role} ({self.host}:{self.pid})")

    @property
    def proc_id(self) -> str:
        return f"{self.host}:{self.pid}:{self.role}"

    def emit(self, kind: str, **fields) -> None:
        """Record one event; with a directory it is appended to
        ``events.jsonl`` at once (as the JAX record ``event=kind``)."""
        self.events.append({"kind": kind, "ts": time.time(), **fields})
        if self.directory:
            self.event_log.emit(kind, **fields)

    def complete(self, name: str, t0: float, t1: float, **args) -> None:
        """Record a span that ran from ``t0`` to ``t1``
        (``time.perf_counter`` readings), stamped with the active trace
        context's ids; with a directory it also goes to the Chrome
        trace (``cat`` among ``args`` is its category)."""
        self.spans.append({"name": name, "t0": t0, "t1": t1,
                           **tracectx.current_ids(), **args})
        if self.directory:
            self.tracer.complete(name, t0, t1, **args)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker on this thread's trace track (faults,
        kills); only the trace file holds it."""
        if self.directory:
            self.tracer.instant(name, **args)

    @contextlib.contextmanager
    def span(self, name: str, **args) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.complete(name, t0, time.perf_counter(), **args)

    def flush(self) -> None:
        """Publish ``metrics.json``, ``metrics.prom`` and ``trace.json``
        (merge-idempotent; events are already on disk). Never raises."""
        if not self.directory or not os.path.isdir(self.directory):
            # no run, or its directory was cleaned up under us
            return
        try:
            _metrics_mod.write_files(self.directory, self.proc_id,
                                     self.metrics.snapshot(),
                                     run_id=self.run_id)
            write_chrome(self.directory, self.tracer)
        except OSError as exc:
            print(f"obs: flush to {self.directory} failed ({exc})",
                  flush=True)


_lock = threading.Lock()
_obs: Optional[Obs] = None
# the environment's directory as :func:`get_obs` last matched it to
# ``_obs`` (``_UNSEEN`` after :func:`init_obs` installed one)
_UNSEEN = object()
_env_seen: object = _UNSEEN
_atexit_registered = False


def _flush_global() -> None:
    if _obs is not None:
        _obs.flush()


def _register_atexit() -> None:
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(_flush_global)


def init_obs(directory: Optional[str] = None, run_id: Optional[str] = None,
             role: str = "main", console: bool = True,
             export_env: bool = True) -> Obs:
    """Install the process-global :class:`Obs` (flushing any previous
    one). ``export_env`` publishes the directory and run id, so the
    processes started later attach to the same run."""
    global _obs, _env_seen
    with _lock:
        if _obs is not None:
            _obs.flush()
        _obs = Obs(directory, run_id=run_id, role=role, console=console)
        _env_seen = _UNSEEN
        if export_env and _obs.directory:
            os.environ[OBS_DIR_ENV] = _obs.directory
            os.environ[OBS_RUN_ENV] = _obs.run_id
        _register_atexit()
        return _obs


def get_obs() -> Obs:
    """The process-global :class:`Obs`, created from the environment
    (``TPU_OPERATOR_OBS_DIR`` / ``_RUN`` / ``_ROLE``) and made anew
    whenever the environment's directory changes, so an emitter never
    writes into a run the driver has left."""
    global _obs, _env_seen
    env_dir = os.environ.get(OBS_DIR_ENV) or None
    cur = _obs
    if cur is not None and env_dir == _env_seen:
        return cur
    want = os.path.abspath(env_dir) if env_dir else None
    with _lock:
        if _obs is None or _obs.directory != want:
            if _obs is not None:
                _obs.flush()
            _obs = Obs(want, run_id=os.environ.get(OBS_RUN_ENV),
                       role=os.environ.get(OBS_ROLE_ENV, "proc"))
            _register_atexit()
        _env_seen = env_dir
        return _obs


@contextlib.contextmanager
def obs_run(directory: str, role: str, run_id: Optional[str] = None,
            console: bool = True) -> Iterator[Obs]:
    """A driver's telemetry run: :func:`init_obs` with the environment
    exported on entry (the processes it starts inherit the run), flush
    and the environment restored on exit, so an in-process caller
    leaves nothing behind."""
    prev = {k: os.environ.get(k) for k in (OBS_DIR_ENV, OBS_RUN_ENV)}
    obs = init_obs(directory, run_id=run_id or os.environ.get(OBS_RUN_ENV),
                   role=role, console=console)
    try:
        yield obs
    finally:
        obs.flush()
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
