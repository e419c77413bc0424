"""Crash-safe flight recorder — the last N seconds of comm / step /
heartbeat samples per process, dumped on the way down.

The obs plane's post-mortem story (the doctor, the live feeds) reads
what a process *flushed*; a chaos ``host:die`` exits through
``os._exit`` and a SIGTERM kill may land mid-collective, so the most
interesting window — what was in flight when the process died — never
reaches ``metrics.prom``. This module is the black box for that window:

- :class:`FlightRecorder` — a bounded ring (time window + sample cap)
  of ``(ts, kind, payload)`` samples. Writers are the comm watcher
  (``kind="comm"``, start/done phases per watched collective window,
  obs/comm.py) and the trainer heartbeat (``kind="heartbeat"``,
  runtime/loop.py). A ``note()`` is one deque append under a mutex —
  cheap enough for the hot loop.
- :meth:`FlightRecorder.dump` — atomic best-effort write of the ring
  to ``<obs_dir>/flight-<pid>.json`` with the dump reason and the LAST
  COLLECTIVE IN FLIGHT (the newest ``comm`` start with no matching
  done). Called explicitly by the chaos death path
  (``PreemptionGuard._die`` — ``os._exit`` runs no handlers, so the
  dump must precede it) and the preemption path
  (``runtime/loop.flush_and_preempt``), and wired to SIGTERM +
  ``sys.excepthook`` by :meth:`FlightRecorder.install` for processes
  that die without either.
- :func:`load_flights` — every ``flight-*.json`` of a run, merged by
  ``tpu-doctor`` into an incident timeline naming the collective that
  was in flight when each process died (obs/doctor.py).

Stdlib-only; never raises into the caller — a failed dump costs the
post-mortem, not the exit path.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

FLIGHT_PREFIX = "flight-"
DEFAULT_WINDOW_S = 30.0
DEFAULT_MAXLEN = 2048


class FlightRecorder:
    """Per-process bounded sample ring. Thread-safe; ``clock``
    injectable for tests. The ring bounds BOTH ways: at most ``maxlen``
    samples, and :meth:`samples` returns only the trailing
    ``window_s`` seconds."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 maxlen: int = DEFAULT_MAXLEN,
                 clock: Callable[[], float] = time.time):
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(maxlen))
        self._installed = False

    # -- writers -------------------------------------------------------
    def note(self, kind: str, **payload) -> None:
        """Append one sample (one locked deque append; never raises)."""
        try:
            rec = {"ts": round(self._clock(), 6), "kind": str(kind),
                   **payload}
            with self._lock:
                self._ring.append(rec)
        except Exception:  # noqa: BLE001 — telemetry never raises
            pass

    # -- readers -------------------------------------------------------
    def samples(self) -> List[Dict]:
        """The trailing-window samples, oldest first."""
        now = self._clock()
        with self._lock:
            recs = list(self._ring)
        return [dict(r) for r in recs
                if r.get("ts", 0.0) >= now - self.window_s]

    def last_comm_inflight(self) -> Optional[Dict]:
        """The newest ``comm`` start sample with no matching done —
        the collective that was in flight when the ring stopped, or
        ``None`` (nothing in flight / no comm samples at all)."""
        done = set()
        with self._lock:
            recs = list(self._ring)
        for r in reversed(recs):
            if r.get("kind") != "comm":
                continue
            if r.get("phase") == "done":
                done.add(r.get("seq"))
            elif r.get("phase") == "start" and r.get("seq") not in done:
                return dict(r)
        return None

    def last_comm(self) -> Optional[Dict]:
        """The newest ``comm`` start sample, in flight or not — the
        incident timeline's fallback when the process died BETWEEN
        collectives (the watcher closed the window microseconds before
        the kill landed): naming the last collective is still the
        honest answer to "what was the network doing"."""
        with self._lock:
            recs = list(self._ring)
        for r in reversed(recs):
            if r.get("kind") == "comm" and r.get("phase") == "start":
                return dict(r)
        return None

    # -- the dump ------------------------------------------------------
    def dump(self, reason: str,
             obs_dir: Optional[str] = None) -> Optional[str]:
        """Atomic write of the ring to ``<obs_dir>/flight-<pid>.json``.
        Best-effort: returns the path, or ``None`` when there is no obs
        dir / the write failed — the exit path must proceed either
        way."""
        try:
            from dgl_operator_tpu_torch.obs import get_obs
            obs = get_obs()
            obs_dir = obs_dir or obs.directory
            if not obs_dir:
                return None
            payload = {
                "pid": os.getpid(), "host": obs.host, "role": obs.role,
                "reason": str(reason),
                "ts": round(self._clock(), 3),
                "window_s": self.window_s,
                "inflight": self.last_comm_inflight(),
                "last_comm": self.last_comm(),
                "samples": self.samples(),
            }
            os.makedirs(obs_dir, exist_ok=True)
            path = os.path.join(obs_dir,
                                f"{FLIGHT_PREFIX}{os.getpid()}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
            return path
        except Exception:  # noqa: BLE001 — a failed dump never raises
            return None

    # -- fault hooks ---------------------------------------------------
    def install(self) -> "FlightRecorder":
        """Chain the dump into SIGTERM and ``sys.excepthook`` so an
        external kill or an unhandled fault leaves the black box.
        Signal chaining preserves whatever handler was there (the
        trainer's preemption flag-setter keeps working); main-thread
        only (CPython restriction), idempotent, best-effort."""
        if self._installed:
            return self
        prev_hook = sys.excepthook

        def _hook(etype, value, tb):
            self.dump("fault")
            prev_hook(etype, value, tb)

        sys.excepthook = _hook
        if threading.current_thread() is threading.main_thread():
            try:
                prev = signal.getsignal(signal.SIGTERM)

                def _on_term(signum, frame):
                    self.dump("sigterm")
                    if callable(prev):
                        prev(signum, frame)
                    elif prev == signal.SIG_DFL:
                        signal.signal(signal.SIGTERM, signal.SIG_DFL)
                        os.kill(os.getpid(), signal.SIGTERM)

                signal.signal(signal.SIGTERM, _on_term)
            except (ValueError, OSError):
                pass
        self._installed = True
        return self


# ------------------------------------------------- process recorder
_flight: Optional[FlightRecorder] = None
_flight_lock = threading.Lock()


def get_flight() -> FlightRecorder:
    """The process-global recorder (the comm watcher and the heartbeat
    note into it; the death paths dump it)."""
    global _flight
    with _flight_lock:
        if _flight is None:
            _flight = FlightRecorder()
        return _flight


def reset_flight() -> None:
    """Fresh recorder (tests; a driver starting a second run)."""
    global _flight
    with _flight_lock:
        _flight = None


# ---------------------------------------------------- doctor's reader
def load_flights(obs_dir: str) -> List[Dict]:
    """Every process's flight dump of a run, sorted by dump time —
    what ``tpu-doctor`` merges into the incident timeline."""
    out: List[Dict] = []
    try:
        names = sorted(os.listdir(obs_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith(FLIGHT_PREFIX)
                and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(obs_dir, name)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(rec, dict):
            out.append(rec)
    out.sort(key=lambda r: r.get("ts", 0.0))
    return out
