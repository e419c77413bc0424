"""HTTP front end of the serving plane.

Endpoints:

- ``POST /predict``: body ``{"nodes": [gid, ...]}`` (or ``{"node":
  gid}``); replies ``{"predictions": [...], "latency_ms": ...}``.
  Requests ride the micro-batcher, so concurrent queries coalesce into
  one padded forward on the engine's device.
- ``GET /healthz``: readiness: 200 once the engine has warmed up
  (``ServeEngine.ready``), 503 with the same payload before, so a
  router keeps traffic away from a cold engine.
- ``GET /metrics``: the process registry's Prometheus text exposition
  plus the derived p50/p95/p99 gauges (``serve_quantile_seconds``).
- ``GET /livez``: the rolling-window snapshot (``obs/live.py``): qps,
  windowed quantiles, SLO state, shed status.

A request may carry an ``X-Tpu-Trace`` header (``obs/tracectx.py``):
its span tree — handler, batch, engine fanout, forward — then hangs
under the caller's span. An SLO breach (``obs/slo.py``) flips the
micro-batcher to load shedding: requests below the shed floor get 503
until the burn rate recovers.

A chaos plan's ``replica:die:<n>`` rule (``launcher/chaos.py``) scoped to
a plane's name kills that plane after it accepts ``<n>`` predict
requests, the last of them dropped unanswered.

The server is a ``ThreadingHTTPServer``: each handler thread only waits
on its request's future, while the batcher's thread drives the engine
on the engine's device.

Usage::

    python -m dgl_operator_tpu_torch.serve.server \\
        --part-config ws/dataset/graph.json \\
        --params ws/serving_params.npz --fanouts 10,25 --port 8378

The model's widths come from the params export (:func:`infer_sage_dims`).
The server runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

import numpy as np

from dgl_operator_tpu_torch._device import resolve_device
from dgl_operator_tpu_torch.launcher import chaos
from dgl_operator_tpu_torch.obs import get_obs, tracectx
from dgl_operator_tpu_torch.obs.live import LiveFeed
from dgl_operator_tpu_torch.obs.metrics import render_quantile_gauges
from dgl_operator_tpu_torch.obs.slo import SLOMonitor
from dgl_operator_tpu_torch.runtime.checkpoint import load_params
from dgl_operator_tpu_torch.serve.batcher import MicroBatcher, Overloaded
from dgl_operator_tpu_torch.serve.engine import ServeConfig, ServeEngine

DEFAULT_PORT = 8378
# a request never waits forever on a wedged engine: one cold start plus
# the batcher's deadline
REQUEST_TIMEOUT_S = 120.0
# request class for the batcher's shed floor (router probes and canary
# mirrors ride above bulk traffic during an overload) and an optional
# client-declared queue deadline
PRIORITY_HEADER = "X-Tpu-Priority"
DEADLINE_HEADER = "X-Tpu-Deadline-Ms"


def infer_sage_dims(params) -> Tuple[int, int, int]:
    """``(num_layers, hidden, out_feats)`` from a DistSAGE params tree
    in the flax layout (either package's serving export)."""
    tree = params.get("params", params)
    layers = sorted(k for k in tree if k.startswith("FanoutSAGEConv_"))
    if not layers:
        raise ValueError(
            "params carry no FanoutSAGEConv_* layers; pass a DistSAGE "
            "serving export (runtime/checkpoint.py export_for_serving)")
    L = len(layers)
    hidden = int(tree["FanoutSAGEConv_0"]["self"]["kernel"].shape[1])
    out = int(tree[f"FanoutSAGEConv_{L - 1}"]["self"]["kernel"].shape[1])
    return L, hidden, out


class ServeHandler(BaseHTTPRequestHandler):
    # the ThreadingHTTPServer instance carries .engine, .batcher, .plane
    server_version = "torch-serve/0.1"

    def _reply(self, code: int, payload, content_type="application/json"):
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # into the event list
        get_obs().emit("serve_http", line=(fmt % args),
                       client=self.client_address[0])

    def do_GET(self):
        if self.path == "/healthz":
            # readiness, not liveness: an engine that has not warmed up
            # must not take router traffic
            ready = self.server.engine.ready
            self._reply(200 if ready else 503,
                        {"ok": ready, **self.server.engine.stats(),
                         "replica": self.server.plane.name,
                         "shedding": self.server.batcher.shedding,
                         "queue_seeds": self.server.batcher.pending_seeds})
        elif self.path == "/livez":
            self._reply(200, self.server.plane.livez())
        elif self.path == "/metrics":
            obs = get_obs()
            obs.flush()
            snap = obs.metrics.snapshot()
            text = (obs.metrics.to_prometheus()
                    + render_quantile_gauges(snap))
            self._reply(200, text.encode(),
                        content_type="text/plain; version=0.0.4")
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
                raise ValueError("body must carry 'nodes' (list) or "
                                 "'node' (single id)")
            nodes = np.atleast_1d(np.asarray(nodes, np.int64))
        except (ValueError, TypeError, json.JSONDecodeError) as exc:
            self._reply(400, {"error": str(exc)})
            return
        if self.server.plane.note_accept():
            # a dead plane answers nothing: the router must see a failed
            # forward and retry a survivor
            self.close_connection = True
            return
        try:
            priority = int(self.headers.get(PRIORITY_HEADER, 0))
            dl = self.headers.get(DEADLINE_HEADER)
            deadline_s = None if dl is None else float(dl) / 1e3
        except (TypeError, ValueError) as exc:
            self._reply(400, {"error": f"bad priority/deadline header: "
                                       f"{exc}"})
            return
        # a caller's header roots this request's span tree under the
        # caller's span; a headerless request starts a new trace
        ctx = tracectx.TraceContext.from_header(
            self.headers.get(tracectx.TRACE_HEADER))
        t0 = time.perf_counter()
        try:
            with tracectx.use(ctx), \
                    tracectx.span("serve_http", cat="serve",
                                  seeds=len(nodes)):
                fut = self.server.batcher.submit(
                    nodes, priority=priority, deadline_s=deadline_s)
                preds = fut.result(timeout=REQUEST_TIMEOUT_S)
        except Overloaded as exc:
            # admission control: reject fast with a back-off signal
            self._reply(503, {"error": str(exc)[:200], "shedding": True})
            return
        except Exception as exc:  # noqa: BLE001 — surface to the client
            if self.server.plane.dead:
                # killed mid-request: answer nothing, as a crashed
                # process would, so the router retries a survivor
                self.close_connection = True
                return
            get_obs().metrics.counter(
                "serve_errors_total",
                "requests failed in the engine/batcher").inc()
            self._reply(500, {"error": str(exc)[:500]})
            return
        self._reply(200, {
            "predictions": [int(v) for v in preds],
            "latency_ms": round((time.perf_counter() - t0) * 1e3, 3)})


class ServingPlane:
    """Engine, batcher, HTTP server and SLO monitor, bundled for
    programmatic use and the CLI. ``port=0`` binds an ephemeral port
    (``.port`` reports it). The monitor thread folds the live feed into
    the SLO windows every ``slo_interval_s`` and drives the batcher's
    shed switch; ``slo_interval_s=0`` disables the thread
    (:meth:`slo_check` runs one step)."""

    def __init__(self, engine: ServeEngine, host: str = "127.0.0.1",
                 port: int = DEFAULT_PORT,
                 slo: Optional[SLOMonitor] = None,
                 slo_interval_s: float = 0.5, name: str = ""):
        self.engine = engine
        self.batcher: MicroBatcher = engine.make_batcher(start=True)
        self.feed = LiveFeed()
        self.slo = slo if slo is not None else SLOMonitor()
        self.slo_interval_s = float(slo_interval_s)
        self.httpd = ThreadingHTTPServer((host, port), ServeHandler)
        self.httpd.engine = engine
        self.httpd.batcher = self.batcher
        self.httpd.plane = self
        self.port = self.httpd.server_address[1]
        # the replica's name in a fleet (serve/router.py)
        self.name = name or f"serve-{self.port}"
        self.dead = False
        self._accepted = 0
        self._lock = threading.Lock()
        # the chaos replica:die threshold of this replica's name
        plan = chaos.proc_plan()
        self._die_after = (plan.replica_die_after(self.name)
                           if plan is not None else None)
        self._thread: Optional[threading.Thread] = None
        self._slo_thread: Optional[threading.Thread] = None
        self._stop_slo = threading.Event()

    def livez(self) -> dict:
        """The ``/livez`` payload: the rolling-window snapshot, the
        replica's identity and its SLO and shed state."""
        obs = get_obs()
        out = self.feed.snapshot(registry=obs.metrics)
        out.update(role="serve", port=self.port, replica=self.name,
                   ready=self.engine.ready,
                   shedding=self.batcher.shedding, slo=self.slo.state())
        return out

    def note_accept(self) -> bool:
        """Count one accepted ``/predict``; True when the request must be
        dropped unanswered: the plane is dead, or the chaos
        ``replica:die:<n>`` threshold fires on it (the plane then dies
        mid-request, as a crash would)."""
        with self._lock:
            if self.dead:
                return True
            self._accepted += 1
            if (self._die_after is None
                    or self._accepted < self._die_after):
                return False
            self._die_after = None
        chaos.count_fault("replica", "die", replica=self.name,
                          after=self._accepted)
        # killed from a side thread: shutdown() joins serve_forever, and
        # this handler thread must return, dropping its connection, for
        # the router to see the failure at once
        threading.Thread(target=self.kill, daemon=True).start()
        return True

    def kill(self) -> None:
        """Abrupt replica death: close the listening socket without
        draining, so in-flight connections break and new ones are
        refused, as a crashed process looks to the router's probes; the
        batcher stops without running what is queued. Idempotent."""
        with self._lock:
            if self.dead:
                return
            self.dead = True
        self._stop_slo.set()
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
        except OSError:
            pass
        self.batcher.stop(drain=False)
        get_obs().emit("serve_replica_died", replica=self.name,
                       port=self.port, requests=self._accepted)

    def slo_check(self) -> list:
        """One SLO evaluation: snapshot → burn windows → shed switch."""
        breaches = self.slo.evaluate(
            self.feed.snapshot(registry=get_obs().metrics))
        reason = ", ".join(
            f"{b['target']}={b['value']}>{b['threshold']}"
            if b["target"] == "p99_ms" else b["target"]
            for b in breaches)
        self.batcher.set_shedding(bool(breaches), reason=reason)
        return breaches

    def _slo_loop(self) -> None:
        while not self._stop_slo.wait(self.slo_interval_s):
            try:
                self.slo_check()
            except Exception as exc:  # noqa: BLE001 — monitoring never stops serving
                get_obs().emit("slo_check_failed", error=str(exc)[:300])

    def start(self) -> "ServingPlane":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="serve-http",
            daemon=True)
        self._thread.start()
        if self.slo_interval_s > 0:
            self._stop_slo.clear()
            self._slo_thread = threading.Thread(
                target=self._slo_loop, name="serve-slo", daemon=True)
            self._slo_thread.start()
        get_obs().emit("serve_listening", port=self.port)
        return self

    def stop(self) -> None:
        """Stop serving (a killed plane only joins its threads)."""
        self._stop_slo.set()
        if self._slo_thread is not None:
            self._slo_thread.join(timeout=5.0)
            self._slo_thread = None
        if not self.dead:
            self.httpd.shutdown()
            self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if not self.dead:
            self.batcher.stop()

    def serve_forever(self) -> None:
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m dgl_operator_tpu_torch.serve.server",
        description="Online GNN inference server over a partitioned "
                    "graph and a params-only serving export")
    ap.add_argument("--part-config", required=True,
                    help="partition book JSON (partition_graph output)")
    ap.add_argument("--params", required=True,
                    help="serving export (export_for_serving .npz, or "
                         "the directory holding serving_params.npz)")
    ap.add_argument("--fanouts", default="10,25",
                    help="comma-separated per-layer fanouts, outermost "
                         "last (must match training)")
    ap.add_argument("--batch-size", type=int, default=64,
                    help="seeds per padded micro-batch")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="micro-batcher coalescing deadline")
    ap.add_argument("--halo-cache-frac", type=float, default=0.25)
    ap.add_argument("--cap-policy", default="worst",
                    choices=("worst", "auto"))
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    ap.add_argument("--device", default=None,
                    help="where the engine runs: the CUDA card unless "
                         "'cpu' is given")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    from dgl_operator_tpu_torch.models.sage import DistSAGE

    params = load_params(args.params)
    L, hidden, out_feats = infer_sage_dims(params)
    fanouts = tuple(int(f) for f in args.fanouts.split(","))
    if len(fanouts) != L:
        raise SystemExit(f"--fanouts names {len(fanouts)} layers but "
                         f"the params carry {L}")
    tree = params.get("params", params)
    in_feats = int(tree["FanoutSAGEConv_0"]["self"]["kernel"].shape[0])
    cfg = ServeConfig(fanouts=fanouts, batch_size=args.batch_size,
                      max_wait_ms=args.max_wait_ms,
                      halo_cache_frac=args.halo_cache_frac,
                      cap_policy=args.cap_policy)
    model = DistSAGE(in_feats, hidden, out_feats, num_layers=L,
                     dropout=0.0, device=device)
    engine = ServeEngine(model, args.part_config, params=params, cfg=cfg,
                         device=device)
    plane = ServingPlane(engine, host=args.host, port=args.port)
    print(f"serving on {args.host}:{plane.port} ({engine.num_parts} "
          f"partitions, batch {args.batch_size}, {device}, warm-up "
          f"{engine.warmup_seconds:.2f}s)", flush=True)
    plane.serve_forever()


if __name__ == "__main__":
    main()
