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

- discovery — every sidecar and serving plane drops its endpoint under
  ``<obs_dir>/live/`` (:func:`register_endpoint`); readers list them
  (:func:`live_endpoints`), fetch each ``/livez``
  (:func:`fetch_livez`) and judge the job from the live feeds, falling
  back to the event files (:func:`live_job_health`, what
  ``obs/top.py`` shows).
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import threading
import time
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

from dgl_operator_tpu_torch.obs.metrics import quantile_from_counts

LIVE_PORT_ENV = "TPU_OPERATOR_LIVE_PORT"
LIVE_SUBDIR = "live"
DEFAULT_WINDOW_S = 10.0
_LAT_FAMILY = "serve_request_seconds"


def _delta(end: float, start: float) -> float:
    """Cumulative-counter delta that survives a reset: a value that went
    down restarted from 0, so the window's delta is the end value."""
    d = end - start
    return d if d >= 0 else end


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
        ``comm_bytes`` are the profiler's (``obs/prof.py``) and the
        communication plane's (``obs/comm.py::axis_bytes_total``)
        riders."""
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
            from dgl_operator_tpu_torch.obs.xray import live_critpath
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
    on a loopback port (``port=0``: ephemeral; ``.port`` reports it),
    registered under ``<obs_dir>/live/`` while it runs."""

    def __init__(self, feed: Optional[LiveFeed] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 role: Optional[str] = None):
        self.feed = feed if feed is not None else get_feed()
        self.role = role or "train"
        self.httpd = ThreadingHTTPServer((host, port), _LiveHandler)
        self.httpd.live = self
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._endpoint_path: Optional[str] = None

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
        self._endpoint_path = register_endpoint(self.port, self.role)
        get_obs().emit("live_listening", port=self.port, role=self.role)
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._endpoint_path:
            try:
                os.remove(self._endpoint_path)
            except OSError:
                pass
            self._endpoint_path = None


# ---------------------------------------------- discovery + health
def _live_dir(obs_dir: str) -> str:
    return os.path.join(obs_dir, LIVE_SUBDIR)


def register_endpoint(port: int, role: str,
                      obs_dir: Optional[str] = None) -> Optional[str]:
    """Drop this process's live endpoint into the run's discovery
    directory (``<obs_dir>/live/``). Best-effort: a read-only obs dir
    costs the run discovery, never the job."""
    from dgl_operator_tpu_torch.obs import get_obs
    obs = get_obs()
    obs_dir = obs_dir or obs.directory
    if not obs_dir:
        return None
    try:
        d = _live_dir(obs_dir)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"{obs.host}-{obs.pid}-{role}.json".replace("/", "_"))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"host": obs.host, "pid": obs.pid, "role": role,
                       "addr": "127.0.0.1", "port": int(port),
                       "ts": round(time.time(), 3)}, f)
        os.replace(tmp, path)
        return path
    except OSError:
        return None


def live_endpoints(obs_dir: str) -> List[Dict]:
    """Registered live endpoints of a run, oldest first."""
    d = _live_dir(obs_dir)
    out: List[Dict] = []
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                ep = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(ep, dict) and ep.get("port"):
            out.append(ep)
    return out


def fetch_livez(ep: Dict, timeout: float = 1.0) -> Optional[Dict]:
    """One endpoint's /livez snapshot, or ``None`` (dead process,
    recycled port) — callers treat unreachable as 'fall back'."""
    url = f"http://{ep.get('addr', '127.0.0.1')}:{ep['port']}/livez"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            snap = json.load(r)
        return snap if isinstance(snap, dict) else None
    except (OSError, ValueError):
        return None


def live_job_health(obs_dir: str, now: Optional[float] = None,
                    stall_factor: Optional[float] = None,
                    stall_grace_s: Optional[float] = None,
                    timeout: float = 1.0) -> Dict:
    """Job health from the live feeds, file fallback. Same shape as
    :func:`~.analyze.job_health` plus ``source``: ``"live"`` when at
    least one sidecar answered (each answering worker judged from its
    feed's own heartbeat ages — a wedged loop thread cannot stop the
    sidecar from truthfully reporting the growing silence), ``"file"``
    when none did (the events file's verdict)."""
    from dgl_operator_tpu_torch.obs.analyze import (DEFAULT_STALL_FACTOR,
                                              DEFAULT_STALL_GRACE_S,
                                              job_health)
    stall_factor = (DEFAULT_STALL_FACTOR if stall_factor is None
                    else stall_factor)
    stall_grace_s = (DEFAULT_STALL_GRACE_S if stall_grace_s is None
                     else stall_grace_s)
    snaps = [(ep, fetch_livez(ep, timeout=timeout))
             for ep in live_endpoints(obs_dir)]
    live = [(ep, s) for ep, s in snaps if s]
    if not live:
        out = job_health(obs_dir, now=now, stall_factor=stall_factor,
                         stall_grace_s=stall_grace_s)
        out["source"] = "file"
        return out
    now = time.time() if now is None else now
    workers: Dict[str, Dict] = {}
    stalled: List[str] = []
    for ep, s in live:
        w = f"{s.get('host', ep.get('host', '?'))}:" \
            f"{s.get('pid', ep.get('pid', '?'))}:" \
            f"{s.get('role', ep.get('role', '?'))}"
        last = s.get("last_heartbeat_ts")
        if last is None:
            continue   # serving/driver feeds carry no heartbeat
        med = s.get("median_interval_s") or stall_grace_s
        window = max(stall_factor * med, stall_grace_s)
        silent = max(now - float(last), 0.0)
        if s.get("done"):
            status = "done"
        elif silent > window:
            status = "stalled"
            stalled.append(w)
        else:
            status = "ok"
        workers[w] = {"status": status, "last_step": s.get("step"),
                      "last_heartbeat_ts": last,
                      "silent_s": round(silent, 3),
                      "stall_window_s": round(window, 3),
                      "terminal": ({"event": "train_done"}
                                   if s.get("done") else None)}
    # dead workers (host_died — the elastic shrink trigger) and
    # numerics-faulted workers (the sentry halted them, obs/quality.py)
    # can only come from the FILE plane: a dead host's sidecar is gone
    # with the process and a halted trainer's sidecar stops with it,
    # so the live view alone would misread permanent loss as mere
    # silence. Merge the events-file verdict in.
    dead: List[str] = []
    dead_hosts: List[str] = []
    numerics: List[str] = []
    try:
        fsnap = job_health(obs_dir, now=now, stall_factor=stall_factor,
                           stall_grace_s=stall_grace_s)
        dead = list(fsnap.get("dead") or [])
        dead_hosts = list(fsnap.get("dead_hosts") or [])
        numerics = list(fsnap.get("numerics") or [])
        for w in dead:
            workers.setdefault(w, fsnap["workers"].get(w) or
                               {"status": "dead"})
            workers[w]["status"] = "dead"
        for w in numerics:
            workers.setdefault(w, fsnap["workers"].get(w) or
                               {"status": "numerics_fault"})
            workers[w]["status"] = "numerics_fault"
        stalled = [w for w in stalled
                   if w not in dead and w not in numerics]
    except Exception:  # noqa: BLE001 — the live view stands alone
        pass
    return {"checked_ts": now, "workers": workers, "stalled": stalled,
            "dead": dead, "dead_hosts": dead_hosts,
            "numerics": numerics,
            "healthy": not stalled and not dead and not numerics,
            "source": "live"}


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
