"""Live rolling-window metrics for ``/livez``, and the trainer's live
sidecar.

The port's copy of the JAX package's ``obs/live.py``:

- :class:`LiveFeed` — an in-process ring. Trainers push one tick per
  call (:meth:`LiveFeed.tick`, from ``runtime/loop.py::heartbeat``);
  the serving plane adds nothing per request, since rolling qps and
  windowed p50/p95/p99 are derived on read by differencing snapshots
  of the metrics registry (the latency histogram's bucket counts are
  cumulative, so a window's quantiles come from the bucket-count
  deltas between its edges, :func:`~.metrics.quantile_from_counts`).
- :class:`LiveServer` — a stdlib HTTP sidecar on loopback: ``GET
  /livez`` returns the rolling snapshot as JSON, ``GET /metrics`` the
  registry's Prometheus text. The trainers start it through
  :func:`maybe_start_sidecar` when ``TPU_OPERATOR_LIVE_PORT`` is set
  (``0`` for an ephemeral port).

Endpoint registration under the obs directory, ``live_endpoints``,
``fetch_livez`` and ``live_job_health`` need the obs file plane, which
is not ported (``ROADMAP.md`` item 7).
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

from dgl_operator_tpu_torch.obs.metrics import quantile_from_counts

LIVE_PORT_ENV = "TPU_OPERATOR_LIVE_PORT"
DEFAULT_WINDOW_S = 10.0
_LAT_FAMILY = "serve_request_seconds"
# PhaseTimer bucket -> critical-path category of the rolling
# critpath_frac: dispatch is the step's enqueue (a compute proxy),
# exchange the halo stage, stall the blocked loop thread, sample host
# work
_LIVE_PHASE_CAT = {"dispatch": "compute", "exchange": "comm",
                   "stall": "stall", "sample": "other"}


def _delta(end: float, start: float) -> float:
    """Cumulative-counter delta that survives a reset: a value that went
    down restarted from 0, so the window's delta is the end value."""
    d = end - start
    return d if d >= 0 else end


def live_critpath(totals: Optional[Dict[str, float]]
                  ) -> Optional[Dict[str, float]]:
    """Category fractions of a PhaseTimer totals dict; None while the
    timer holds nothing."""
    acc: Dict[str, float] = {}
    for phase, v in (totals or {}).items():
        cat = _LIVE_PHASE_CAT.get(phase)
        if cat is not None and v and v > 0:
            acc[cat] = acc.get(cat, 0.0) + float(v)
    tot = sum(acc.values())
    if tot <= 0:
        return None
    return {k: round(v / tot, 4) for k, v in sorted(acc.items())}


class LiveFeed:
    """Per-process rolling-window aggregator. Trainers call
    :meth:`tick` once per call; the serving side needs no writer.
    Thread-safe; ``clock`` injectable for tests."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 maxlen: int = 4096,
                 clock: Callable[[], float] = time.time):
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        # (ts, step, exchange_bytes, stall_s, busy_s, mfu, hbm_mib,
        # overlap_ratio, loss, grad_norm, comm_bytes, phase_totals) per
        # heartbeat, the JAX feed's tuple
        self._ticks: deque = deque(maxlen=maxlen)
        # (ts, requests, shed, lat_buckets, lat_counts) registry
        # extracts, ringed so a read can difference against the
        # window's far edge
        self._reg: deque = deque(maxlen=256)
        self._done = False

    # -- writers ---------------------------------------------------------
    def tick(self, step: int, timer=None, ts: Optional[float] = None,
             mfu: Optional[float] = None,
             hbm_mib: Optional[float] = None,
             overlap_ratio: Optional[float] = None,
             loss: Optional[float] = None,
             grad_norm: Optional[float] = None,
             comm_bytes: Optional[Dict[str, float]] = None) -> None:
        """One training heartbeat: the global step plus, optionally, the
        trainer's PhaseTimer (the window derives the exchange MiB/s, the
        stall share and the critical-path split from its cumulative
        buckets), the pipeline's ``overlap_ratio`` and the sentry's
        ``loss`` and ``grad_norm``. ``mfu``, ``hbm_mib`` and
        ``comm_bytes`` are the profiler's and the communication plane's
        riders, which the port does not feed yet."""
        snap = timer.snapshot() if timer is not None else {}
        total = snap.get("total", {})
        busy = (total.get("stall", 0.0) + total.get("sample", 0.0)
                + total.get("dispatch", 0.0))
        rec = (self._clock() if ts is None else ts, int(step),
               float(snap.get("bytes", {}).get("exchange", 0)),
               float(total.get("stall", 0.0)), float(busy),
               (None if mfu is None else float(mfu)),
               (None if hbm_mib is None else float(hbm_mib)),
               (None if overlap_ratio is None else float(overlap_ratio)),
               (None if loss is None else float(loss)),
               (None if grad_norm is None else float(grad_norm)),
               (None if comm_bytes is None
                else {str(k): float(v) for k, v in comm_bytes.items()}),
               (None if timer is None
                else {str(k): float(v) for k, v in total.items()}))
        with self._lock:
            self._ticks.append(rec)

    def mark_done(self) -> None:
        """The terminal marker: silence after it is completion, not a
        stall."""
        with self._lock:
            self._done = True

    def reset(self) -> None:
        with self._lock:
            self._ticks.clear()
            self._reg.clear()
            self._done = False

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
        """The rolling-window aggregate: training rates from the tick
        ring, serving qps and quantiles from registry-snapshot deltas.
        Keys are None while the window holds no signal yet (an idle
        feed never reports a bogus 0 rate)."""
        w = float(window_s or self.window_s)
        now = self._clock()
        out: Dict = {"ts": round(now, 3), "window_s": w}
        with self._lock:
            ticks = [t for t in self._ticks if t[0] >= now - w]
            if not ticks and self._ticks:
                ticks = [self._ticks[-1]]
            out["done"] = self._done
        out.update(self._tick_stats(ticks))
        if registry is not None:
            out.update(self._serve_stats(registry.snapshot(), now, w))
        return out

    @staticmethod
    def _tick_stats(ticks: List[tuple]) -> Dict:
        out: Dict = {"step": None, "step_rate_hz": None,
                     "heartbeat_hz": None, "last_heartbeat_ts": None,
                     "median_interval_s": None,
                     "exchange_mib_per_s": None, "stall_frac": None,
                     "mfu": None, "hbm_mib": None,
                     "overlap_ratio": None, "loss": None,
                     "grad_norm": None, "comm_mib_per_s": None,
                     "comm_axis_mib_per_s": None,
                     "critpath_frac": None}
        if not ticks:
            return out
        out["step"] = ticks[-1][1]
        out["last_heartbeat_ts"] = round(ticks[-1][0], 6)
        # the riders: the last tick in the window that carried each
        riders = (("mfu", 5, 4), ("hbm_mib", 6, 1),
                  ("overlap_ratio", 7, 4), ("loss", 8, 6),
                  ("grad_norm", 9, 6))
        for t in reversed(ticks):
            for key, idx, nd in riders:
                if out[key] is None and t[idx] is not None:
                    out[key] = round(t[idx], nd)
            if all(out[key] is not None for key, _, _ in riders):
                break
        if len(ticks) < 2:
            return out
        dt = ticks[-1][0] - ticks[0][0]
        gaps = [b[0] - a[0] for a, b in zip(ticks, ticks[1:])]
        out["median_interval_s"] = round(
            max(statistics.median(gaps), 1e-6), 6)
        if dt <= 0:
            return out
        out["step_rate_hz"] = round((ticks[-1][1] - ticks[0][1]) / dt, 4)
        out["heartbeat_hz"] = round((len(ticks) - 1) / dt, 4)
        out["exchange_mib_per_s"] = round(
            _delta(ticks[-1][2], ticks[0][2]) / 2**20 / dt, 4)
        busy = _delta(ticks[-1][4], ticks[0][4])
        if busy > 0:
            out["stall_frac"] = round(
                _delta(ticks[-1][3], ticks[0][3]) / busy, 4)
        carried = [t for t in ticks if t[10] is not None]
        if len(carried) >= 2:
            first, last = carried[0], carried[-1]
            cdt = last[0] - first[0]
            if cdt > 0:
                axes = {ax: round(_delta(last[10].get(ax, 0.0),
                                         first[10].get(ax, 0.0))
                                  / 2**20 / cdt, 4)
                        for ax in last[10]}
                out["comm_axis_mib_per_s"] = axes
                out["comm_mib_per_s"] = round(sum(axes.values()), 4)
        timed = [t for t in ticks if t[11] is not None]
        if len(timed) >= 2:
            first, last = timed[0], timed[-1]
            out["critpath_frac"] = live_critpath(
                {ph: _delta(last[11].get(ph, 0.0), first[11].get(ph, 0.0))
                 for ph in last[11]})
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


# ------------------------------------------------------- process feed
_feed: Optional[LiveFeed] = None
_feed_lock = threading.Lock()


def get_feed() -> LiveFeed:
    """The process's feed (trainers tick it; the sidecar reads it)."""
    global _feed
    with _feed_lock:
        if _feed is None:
            _feed = LiveFeed()
        return _feed


def reset_feed() -> None:
    """A fresh process feed at the next :func:`get_feed`."""
    global _feed
    with _feed_lock:
        _feed = None


# --------------------------------------------------------- the sidecar
class _LiveHandler(BaseHTTPRequestHandler):
    server_version = "tpu-livez/0.1"

    def log_message(self, fmt, *args):  # liveness polls are not news
        pass

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/livez":
            self._reply(200, json.dumps(self.server.live.payload())
                        .encode(), "application/json")
        elif self.path == "/metrics":
            from dgl_operator_tpu_torch.obs import get_obs
            self._reply(200, get_obs().metrics.to_prometheus().encode(),
                        "text/plain; version=0.0.4")
        else:
            self._reply(404, json.dumps(
                {"error": f"unknown path {self.path}"}).encode(),
                "application/json")


class LiveServer:
    """The trainer's live sidecar: ``/livez`` (the feed's snapshot over
    the metrics registry, and the process's identity) and ``/metrics``
    on a loopback port (``port=0``: ephemeral; ``.port`` reports it)."""

    def __init__(self, feed: Optional[LiveFeed] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 role: Optional[str] = None):
        self.feed = feed if feed is not None else get_feed()
        self.role = role or "train"
        self.httpd = ThreadingHTTPServer((host, port), _LiveHandler)
        self.httpd.live = self
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def payload(self) -> Dict:
        from dgl_operator_tpu_torch.obs import get_obs
        out = self.feed.snapshot(registry=get_obs().metrics)
        out.update(host=socket.gethostname(), pid=os.getpid(),
                   role=self.role, port=self.port)
        return out

    def start(self) -> "LiveServer":
        from dgl_operator_tpu_torch.obs import get_obs
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="tpu-livez", daemon=True)
        self._thread.start()
        get_obs().emit("live_listening", port=self.port, role=self.role)
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# -------------------------------------------------- env-gated startup
_sidecar: Optional[LiveServer] = None
_sidecar_lock = threading.Lock()


def maybe_start_sidecar(role: Optional[str] = None
                        ) -> Optional[LiveServer]:
    """Start the process's live sidecar when ``TPU_OPERATOR_LIVE_PORT``
    is set (``0``: an ephemeral port); idempotent. Never raises: a port
    collision costs the run its live feed, not the training."""
    global _sidecar
    port_env = os.environ.get(LIVE_PORT_ENV)
    if port_env is None or port_env == "":
        return None
    with _sidecar_lock:
        if _sidecar is not None:
            return _sidecar
        try:
            _sidecar = LiveServer(port=int(port_env), role=role).start()
        except (OSError, ValueError) as exc:
            print(f"obs: live sidecar failed to start ({exc}); "
                  "continuing without a live feed", flush=True)
            return None
        return _sidecar


def stop_sidecar() -> None:
    """Stop the env-gated sidecar, if one runs."""
    global _sidecar
    with _sidecar_lock:
        sc, _sidecar = _sidecar, None
    if sc is not None:
        sc.stop()
