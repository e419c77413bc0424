"""Fleet router — the replicated serving plane's front end.

N interchangeable :class:`~dgl_operator_tpu_torch.serve.server.ServingPlane`
replicas over one partition book become one endpoint:

- **Consistent-hash routing by owner partition**: a request's first
  seed resolves to its owner partition through the book's
  ``node_map``, and the partition keys a hash ring over the replicas,
  so one partition's queries land on one replica (a warm halo cache),
  and adding or removing a replica remaps only its arcs.
- **Health-weighted balancing**: each replica's ``/livez`` gives a
  weight (readiness, shedding, SLO verdict, windowed p99 against the
  target); a candidate below ``degraded_frac`` of the best weight goes
  to the back of the chain before it starts failing requests.
- **Failover with drain and regrow**: a failed forward probes the
  replica's ``/healthz``; an unreachable replica is marked down
  (``fleet_replica_down``) and the request retries on the next ring
  candidate, so a replica's death drops no request; the probe loop
  readmits it when ``/healthz`` answers ready again
  (``fleet_replica_regrow``).
- **Canary promotion**: :class:`CanaryController` swaps a staged
  candidate export (``runtime/checkpoint.py::ServingPromotion``) onto
  one replica, mirrors a ``canary_frac`` slice of traffic to it, and
  judges it by the engine's non-finite-logit count and the prediction
  divergence from the incumbent's replies: it commits the promotion
  through the fence or rolls it back with the incumbent untouched.

The chaos drills of the fleet are the replicas' ``replica:die``
(``serve/server.py``) and the staged candidate's ``promote:bad``
(``runtime/checkpoint.py``). A router plane registers its endpoint
under the run's ``<obs_dir>/live/`` (``obs/live.py::register_endpoint``),
where ``obs/top.py`` finds it.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

import numpy as np

from dgl_operator_tpu_torch.autotune.knobs import default_of
from dgl_operator_tpu_torch.autotune.knobs import validate as knobs_validate
from dgl_operator_tpu_torch.obs import get_obs, tracectx
from dgl_operator_tpu_torch.obs.live import register_endpoint
from dgl_operator_tpu_torch.runtime.checkpoint import load_params
from dgl_operator_tpu_torch.serve.server import (DEADLINE_HEADER,
                                                 PRIORITY_HEADER)

# transport faults a dead replica can raise through urllib
# (RemoteDisconnected is both an OSError and an HTTPException)
_NET_ERRORS = (OSError, http.client.HTTPException)


def _http_json(method: str, host: str, port: int, path: str,
               body=None, headers: Optional[Dict[str, str]] = None,
               timeout: float = 10.0):
    """One JSON round trip; returns ``(status, payload)``. HTTP error
    statuses return normally (their body decoded); transport faults
    raise."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://{host}:{port}{path}",
                                 data=data, method=method)
    req.add_header("Content-Type", "application/json")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            payload = json.loads(e.read() or b"{}")
        except ValueError:
            payload = {}
        return e.code, payload


def _ring_hash(key: str) -> int:
    return int.from_bytes(
        hashlib.sha256(key.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring with virtual nodes, a function of the member
    names alone (sha256, no process seed): every router derives the
    same partition → replica map."""

    def __init__(self, names: Sequence[str], vnodes: int = 64):
        if not names:
            raise ValueError("hash ring needs at least one member")
        self.vnodes = int(vnodes)
        self._points: List[tuple] = sorted(
            (_ring_hash(f"{name}#{v}"), name)
            for name in names for v in range(self.vnodes))

    def candidates(self, key: str) -> List[str]:
        """Every member in ring order from ``key``'s point: element 0
        owns the key, the rest are its failover chain."""
        h = _ring_hash(key)
        lo, hi = 0, len(self._points)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._points[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        seen: List[str] = []
        n = len(self._points)
        for i in range(n):
            name = self._points[(lo + i) % n][1]
            if name not in seen:
                seen.append(name)
        return seen


class Replica:
    """One serving replica as the router sees it; ``plane`` is the
    in-process :class:`ServingPlane` when there is one (the canary needs
    it to swap params)."""

    def __init__(self, name: str, host: str, port: int, plane=None):
        self.name = name
        self.host = host
        self.port = int(port)
        self.plane = plane
        self.state = "up"  # up | down
        self.weight = 1.0
        self.forwarded = 0
        self.last_livez: Optional[dict] = None

    def describe(self) -> dict:
        return {"state": self.state, "weight": round(self.weight, 4),
                "host": self.host, "port": self.port,
                "forwarded": self.forwarded}


def weight_of(livez: Optional[dict]) -> float:
    """A replica's balancing weight from its ``/livez``: 0 when not
    ready, scaled down while shedding or in SLO breach, and in
    proportion when the windowed p99 overshoots the target, floored at
    0.1 so a slow replica keeps a trickle."""
    if not livez or not livez.get("ready", False):
        return 0.0
    w = 1.0
    slo = livez.get("slo") or {}
    if livez.get("shedding"):
        w *= 0.2
    elif not slo.get("ok", True):
        w *= 0.5
    p99 = livez.get("p99_ms")
    target = (slo.get("targets") or {}).get("p99_ms")
    if p99 and target and p99 > target:
        w *= max(float(target) / float(p99), 0.1)
    return round(w, 4)


class FleetRouter:
    """Fan requests out to a replica fleet: consistent-hash placement by
    the first seed's owner partition (``node_map``, the book's gid →
    partition array; without it the seed list is hashed),
    health-weighted balancing and retry-on-survivor failover."""

    def __init__(self, replicas: Sequence[Replica],
                 node_map: Optional[np.ndarray] = None,
                 vnodes: int = 64, degraded_frac: float = 0.5,
                 max_attempts: Optional[int] = None,
                 probe_timeout_s: float = 2.0,
                 request_timeout_s: float = 60.0):
        knobs_validate("replicas", len(replicas))
        self._replicas: Dict[str, Replica] = {r.name: r for r in replicas}
        if len(self._replicas) != len(replicas):
            raise ValueError("replica names must be unique")
        self.ring = HashRing(sorted(self._replicas), vnodes=vnodes)
        self.node_map = None if node_map is None else np.asarray(node_map)
        self.degraded_frac = float(degraded_frac)
        self.max_attempts = (int(max_attempts) if max_attempts
                             else len(replicas))
        self.probe_timeout_s = float(probe_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        self.canary: Optional["CanaryController"] = None
        self._mirror_tick = 0
        self._lock = threading.Lock()
        self._probe_thread: Optional[threading.Thread] = None
        self._stop_probe = threading.Event()
        m = get_obs().metrics
        self._m_requests = m.counter(
            "fleet_requests_total",
            "requests forwarded per serving replica", labels=("replica",))
        self._m_retries = m.counter(
            "fleet_retries_total",
            "forwards retried on a survivor after a replica fault")
        self._m_failovers = m.counter(
            "fleet_failovers_total",
            "replicas the router marked down (drained to survivors)")
        self._m_shed = m.counter(
            "fleet_shed_total",
            "503s passed through to clients while the fleet sheds")
        self._m_up = m.gauge("fleet_replicas_up",
                             "serving replicas currently routable")
        self._m_up.set(self.replicas_up())

    # ---------------------------------------------------------- state
    def replica(self, name: str) -> Replica:
        return self._replicas[name]

    def replicas(self) -> List[Replica]:
        return [self._replicas[n] for n in sorted(self._replicas)]

    def replicas_up(self) -> int:
        return sum(1 for r in self._replicas.values() if r.state == "up")

    def fleet_state(self) -> dict:
        """The router's ``/livez``: each replica's routing state and the
        canary's verdict."""
        out = {"role": "router", "replicas_up": self.replicas_up(),
               "replicas": {n: r.describe()
                            for n, r in sorted(self._replicas.items())}}
        if self.canary is not None:
            out["canary"] = self.canary.state()
        return out

    def update_health(self, payloads: Dict[str, Optional[dict]]) -> None:
        """Fold ``/livez`` payloads (replica name → payload) into the
        balancing weights."""
        for name, payload in payloads.items():
            rep = self._replicas.get(name)
            if rep is None:
                continue
            rep.last_livez = payload
            if rep.state == "up":
                rep.weight = weight_of(payload)

    # ------------------------------------------------------- placement
    def _part_of(self, nodes: np.ndarray) -> str:
        if self.node_map is not None and len(nodes):
            gid = int(nodes[0])
            if 0 <= gid < len(self.node_map):
                return f"part-{int(self.node_map[gid])}"
        return "nodes-" + ",".join(str(int(v)) for v in nodes[:8])

    def route(self, nodes) -> List[Replica]:
        """A request's failover chain: ring order from its owner
        partition's point, the replicas holding ``degraded_frac`` of the
        best weight first, the degraded ones after, in ring order."""
        nodes = np.atleast_1d(np.asarray(nodes, np.int64))
        names = self.ring.candidates(self._part_of(nodes))
        up = [self._replicas[n] for n in names
              if self._replicas[n].state == "up"]
        if not up:
            return []
        best = max(r.weight for r in up)
        cut = self.degraded_frac * best
        return ([r for r in up if r.weight >= cut]
                + [r for r in up if r.weight < cut])

    # ------------------------------------------------------ forwarding
    def forward(self, nodes, priority: int = 0,
                deadline_ms: Optional[float] = None):
        """Route one ``/predict``; returns ``(status, payload)``. A
        transport fault probes the replica (down and drained if it does
        not answer) and retries the same request on the next survivor.
        A 503 (a survivor shedding) passes through: it is backpressure,
        and retrying it would feed the overload."""
        nodes = np.atleast_1d(np.asarray(nodes, np.int64))
        headers = {PRIORITY_HEADER: str(int(priority))}
        if deadline_ms is not None:
            headers[DEADLINE_HEADER] = str(float(deadline_ms))
        attempts = 0
        for rep in self.route(nodes):
            if attempts >= self.max_attempts:
                break
            attempts += 1
            if attempts > 1:
                self._m_retries.inc()
            # one span per attempt, whose context the replica's
            # serve_http span hangs under: router → replica → engine is
            # one tree, the retry leg of a failover included
            with tracectx.span("fleet_forward", cat="serve",
                               replica=rep.name, attempt=attempts) as fwd:
                headers[tracectx.TRACE_HEADER] = fwd.header()
                try:
                    code, payload = _http_json(
                        "POST", rep.host, rep.port, "/predict",
                        {"nodes": [int(v) for v in nodes]},
                        headers=headers, timeout=self.request_timeout_s)
                except _NET_ERRORS as exc:
                    self._on_forward_failure(rep, exc)
                    continue
            rep.forwarded += 1
            self._m_requests.inc(replica=rep.name)
            if code == 503:
                self._m_shed.inc()
                return code, payload
            if code == 200:
                self._maybe_mirror(rep, nodes, payload)
            return code, payload
        self._m_shed.inc()
        return 503, {"error": "no routable replica", "attempts": attempts,
                     "replicas_up": self.replicas_up()}

    def _on_forward_failure(self, rep: Replica, exc: Exception) -> None:
        """A forward died on the wire: one ``/healthz`` probe tells a
        blip (stay up) from a dead replica (down and drained)."""
        try:
            code, _ = _http_json("GET", rep.host, rep.port, "/healthz",
                                 timeout=self.probe_timeout_s)
            alive = code == 200
        except _NET_ERRORS:
            alive = False
        if not alive:
            self.mark_down(rep.name, reason=f"forward failed: {exc}")

    def mark_down(self, name: str, reason: str = "") -> None:
        rep = self._replicas[name]
        with self._lock:
            if rep.state == "down":
                return
            rep.state = "down"
            rep.weight = 0.0
        self._m_failovers.inc()
        self._m_up.set(self.replicas_up())
        get_obs().emit("fleet_replica_down", replica=name,
                       reason=str(reason)[:200],
                       survivors=self.replicas_up())

    def readmit(self, name: str) -> None:
        rep = self._replicas[name]
        with self._lock:
            if rep.state == "up":
                return
            rep.state = "up"
            rep.weight = 1.0
        self._m_up.set(self.replicas_up())
        get_obs().emit("fleet_replica_regrow", replica=name,
                       replicas_up=self.replicas_up())

    # ----------------------------------------------------- probe loop
    def probe_once(self) -> None:
        """One health sweep: a down replica that answers ``/healthz``
        ready is readmitted (regrow); an up one refreshes its weight
        from ``/livez``, or is drained when it stopped answering."""
        for rep in list(self._replicas.values()):
            try:
                code, hz = _http_json("GET", rep.host, rep.port,
                                      "/healthz",
                                      timeout=self.probe_timeout_s)
                alive = code == 200 and bool(hz.get("ok", True))
            except _NET_ERRORS:
                alive = False
            if alive and rep.state == "down":
                self.readmit(rep.name)
            elif not alive and rep.state == "up":
                self.mark_down(rep.name, reason="probe failed")
                continue
            if alive:
                try:
                    _, lz = _http_json("GET", rep.host, rep.port, "/livez",
                                       timeout=self.probe_timeout_s)
                    self.update_health({rep.name: lz})
                except _NET_ERRORS:
                    pass

    def start_probes(self, interval_s: float = 0.5) -> "FleetRouter":
        def loop():
            while not self._stop_probe.wait(interval_s):
                try:
                    self.probe_once()
                except Exception as exc:  # noqa: BLE001 — probing never stops routing
                    get_obs().emit("fleet_probe_failed",
                                   error=str(exc)[:300])
        self._stop_probe.clear()
        self._probe_thread = threading.Thread(target=loop,
                                              name="fleet-probe",
                                              daemon=True)
        self._probe_thread.start()
        return self

    def stop_probes(self) -> None:
        self._stop_probe.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5.0)
            self._probe_thread = None

    # --------------------------------------------------------- canary
    def _maybe_mirror(self, rep: Replica, nodes: np.ndarray,
                      payload: dict) -> None:
        canary = self.canary
        if canary is None or not canary.active:
            return
        if rep.name == canary.replica_name:
            # the canary's own traffic is its exposure, not a comparison
            return
        with self._lock:
            self._mirror_tick += 1
            tick = self._mirror_tick
        if tick % canary.every:
            return
        canary.mirror(nodes, payload.get("predictions"))


class CanaryController:
    """One candidate export through canary → verdict.

    :meth:`start` swaps the staged candidate onto one replica's engine
    (the incumbent params kept for a rollback); the router then mirrors
    every ``1/frac``-th request another replica served to the canary
    with priority 1 (above the shed floor). After ``min_mirrors``
    comparisons :meth:`decide` judges:

    - **NaN sentry**: any growth of the canary engine's
      ``nonfinite_logits`` since the swap;
    - **divergence**: the share of mirrored seeds whose canary
      prediction differs from the incumbent's reply, over
      ``divergence_threshold`` (the replicas' sampling streams differ
      per request, so it is a tolerance, not an equality).

    Bad: ``ServingPromotion.rollback`` and the incumbent restored on the
    canary; good: ``ServingPromotion.commit`` and the candidate swapped
    onto every up replica."""

    def __init__(self, router: FleetRouter, promotion,
                 frac: Optional[float] = None,
                 divergence_threshold: float = 0.5,
                 min_mirrors: int = 12):
        self.router = router
        self.promotion = promotion
        frac = float(default_of("canary_frac") if frac is None else frac)
        knobs_validate("canary_frac", frac)
        self.frac = frac
        self.every = max(1, int(round(1.0 / frac)) if frac > 0 else 1)
        self.divergence_threshold = float(divergence_threshold)
        self.min_mirrors = int(min_mirrors)
        self.active = False
        self.verdict: Optional[str] = None
        self.replica_name: Optional[str] = None
        self.mirrored = 0
        self.seeds = 0
        self.disagreed = 0
        self.nonfinite = 0
        self._candidate = None
        self._incumbent = None
        self._nonfinite_base = 0
        self._lock = threading.Lock()
        self._m_mirrors = get_obs().metrics.counter(
            "fleet_canary_mirrors_total",
            "live requests mirrored to the canary replica")
        router.canary = self

    def state(self) -> dict:
        div = round(self.disagreed / self.seeds, 4) if self.seeds else 0.0
        return {"active": self.active, "replica": self.replica_name,
                "verdict": self.verdict, "mirrored": self.mirrored,
                "divergence": div, "frac": self.frac}

    def start(self, candidate_path: str,
              replica: Optional[str] = None) -> None:
        """Load the staged candidate (its sidecar verified) and swap it
        onto the canary replica's engine."""
        if self.active:
            raise RuntimeError("a canary is already running")
        if replica is None:
            replica = next((r.name for r in self.router.replicas()
                            if r.state == "up" and r.plane is not None),
                           None)
        if replica is None:
            raise RuntimeError("no up replica with an in-process plane "
                               "to canary on")
        rep = self.router.replica(replica)
        if rep.plane is None:
            raise RuntimeError(f"replica {replica} has no in-process "
                               "plane")
        self._candidate = load_params(candidate_path)
        engine = rep.plane.engine
        self._nonfinite_base = engine.nonfinite_logits
        self._incumbent = engine.swap_params(self._candidate)
        self.replica_name = replica
        self.mirrored = self.seeds = self.disagreed = self.nonfinite = 0
        self.verdict = None
        self.active = True
        get_obs().emit("fleet_canary_start", replica=replica,
                       path=candidate_path, frac=self.frac)

    def mirror(self, nodes, incumbent_preds) -> None:
        """Replay one incumbent-served request on the canary and score
        the disagreement; a canary that cannot answer counts as full
        disagreement."""
        if not self.active or incumbent_preds is None:
            return
        rep = self.router.replica(self.replica_name)
        self._m_mirrors.inc()
        nodes = np.atleast_1d(np.asarray(nodes, np.int64))
        try:
            code, payload = _http_json(
                "POST", rep.host, rep.port, "/predict",
                {"nodes": [int(v) for v in nodes]},
                headers={PRIORITY_HEADER: "1"},
                timeout=self.router.request_timeout_s)
            canary_preds = (payload.get("predictions")
                            if code == 200 else None)
        except _NET_ERRORS:
            canary_preds = None
        if canary_preds is None or len(canary_preds) != len(nodes):
            disagreed = len(nodes)
        else:
            disagreed = int(sum(int(a) != int(b) for a, b in
                                zip(incumbent_preds, canary_preds)))
        with self._lock:
            self.mirrored += 1
            self.seeds += len(nodes)
            self.disagreed += disagreed
            due = self.mirrored >= self.min_mirrors
        if due:
            self.decide()

    def decide(self) -> str:
        """Run the detectors and settle the candidate (once)."""
        with self._lock:
            if not self.active:
                return self.verdict or "idle"
            self.active = False
        engine = self.router.replica(self.replica_name).plane.engine
        nonfinite = engine.nonfinite_logits - self._nonfinite_base
        divergence = (self.disagreed / self.seeds) if self.seeds else 0.0
        self.nonfinite = int(nonfinite)
        if nonfinite > 0 or divergence > self.divergence_threshold:
            engine.swap_params(self._incumbent)
            self.promotion.rollback(
                reason=f"nonfinite={nonfinite}, "
                       f"divergence={divergence:.4f}")
            self.verdict = "rollback"
        else:
            self.promotion.commit()
            for other in self.router.replicas():
                if (other.name != self.replica_name
                        and other.state == "up"
                        and other.plane is not None):
                    other.plane.engine.swap_params(self._candidate)
            self.verdict = "promote"
        get_obs().emit("fleet_canary_verdict", verdict=self.verdict,
                       replica=self.replica_name, mirrored=self.mirrored,
                       divergence=round(divergence, 4),
                       nonfinite=int(nonfinite))
        return self.verdict


class RouterHandler(BaseHTTPRequestHandler):
    server_version = "torch-route/0.1"

    def _reply(self, code: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        get_obs().emit("serve_http", line=(fmt % args),
                       client=self.client_address[0])

    def do_GET(self):
        router: FleetRouter = self.server.router
        if self.path == "/livez":
            self._reply(200, router.fleet_state())
        elif self.path == "/healthz":
            up = router.replicas_up()
            self._reply(200 if up else 503,
                        {"ok": up > 0, "replicas_up": up})
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/predict":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            nodes = req.get("nodes", req.get("node"))
            if nodes is None:
                raise ValueError("body must carry 'nodes' or 'node'")
            priority = int(self.headers.get(PRIORITY_HEADER, 0))
            dl = self.headers.get(DEADLINE_HEADER)
            deadline_ms = None if dl is None else float(dl)
        except (ValueError, TypeError, json.JSONDecodeError) as exc:
            self._reply(400, {"error": str(exc)})
            return
        # the caller's context (or a new root at the fleet's front
        # door): every forward attempt hangs under one request span
        ctx = tracectx.TraceContext.from_header(
            self.headers.get(tracectx.TRACE_HEADER))
        with tracectx.use(ctx), tracectx.span("route_http", cat="serve"):
            code, payload = self.server.router.forward(
                nodes, priority=priority, deadline_ms=deadline_ms)
        self._reply(code, payload)


class RouterPlane:
    """HTTP front end over a :class:`FleetRouter`, the fleet's one
    public endpoint."""

    def __init__(self, router: FleetRouter, host: str = "127.0.0.1",
                 port: int = 0):
        self.router = router
        self.httpd = ThreadingHTTPServer((host, port), RouterHandler)
        self.httpd.router = router
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self, probe_interval_s: float = 0.5) -> "RouterPlane":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="fleet-http", daemon=True)
        self._thread.start()
        if probe_interval_s > 0:
            self.router.start_probes(probe_interval_s)
        register_endpoint(self.port, "router")
        get_obs().emit("fleet_listening", port=self.port,
                       replicas=len(self.router.replicas()))
        return self

    def stop(self) -> None:
        self.router.stop_probes()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
