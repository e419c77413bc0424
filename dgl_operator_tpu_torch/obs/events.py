"""Structured event log: the JSONL sink (``events.jsonl``) and a console
sink.

Every record carries the run id, host, pid, role and a wall-clock
timestamp, then the event's own fields, in the JAX package's format, so
the two packages read each other's logs.

Append semantics: the file is opened once, in append mode, and each
record is written as one line and flushed at once. ``O_APPEND`` keeps
the processes that share one ``events.jsonl`` (a driver and its
trainers) line-atomic for the short records emitted here. Keeping the
file open spares the hot loop an ``open`` per heartbeat; a write that
fails drops the file sink, loudly once, and the job goes on.

Standard library only.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional

EVENTS_JSONL = "events.jsonl"


class EventLog:
    def __init__(self, path: Optional[str] = None, console: bool = True,
                 base: Optional[Dict[str, object]] = None):
        self.path = path
        self.console = console
        self.base = dict(base or {})
        self._warned = False
        self._lock = threading.Lock()
        self._f = None

    def emit(self, event: str, message: Optional[str] = None,
             **fields) -> Dict[str, object]:
        """Record one structured event (JSONL sink only)."""
        rec: Dict[str, object] = {"ts": round(time.time(), 6)}
        rec.update(self.base)
        rec["event"] = event
        rec.update(fields)
        if message is not None:
            rec["message"] = message
        self._append(rec)
        return rec

    def log(self, message: str, event: str = "log",
            **fields) -> Dict[str, object]:
        """Console sink + event record: prints exactly ``message``
        (with ``flush=True``) and captures it as an event — the
        replacement for the drivers' bare ``print()`` calls."""
        if self.console:
            print(message, flush=True)
        return self.emit(event, message=message, **fields)

    def console_line(self, message: str) -> None:
        """Console-only decorative output (separators); not an event."""
        if self.console:
            print(message, flush=True)

    def _append(self, rec: Dict[str, object]) -> None:
        if not self.path:
            return
        try:
            line = json.dumps(rec, default=str)
            with self._lock:
                if self._f is None:
                    self._f = open(self.path, "a")
                self._f.write(line + "\n")
                self._f.flush()
        except (OSError, TypeError, ValueError) as exc:
            # telemetry must never fail the job: drop the file sink
            # (loudly, once) and keep the console alive
            if not self._warned:
                self._warned = True
                print(f"obs: event write to {self.path} failed ({exc});"
                      " falling back to console only", flush=True)
            self.path = None
            self.close()

    def close(self) -> None:
        with self._lock:
            f, self._f = self._f, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass
