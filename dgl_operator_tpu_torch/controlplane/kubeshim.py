"""kubeshim — production manager loop around the native reconciler.

The reference's manager is a controller-runtime process: it watches
DGLJobs and owned pods, calls ``Reconcile`` per event, serves metrics on
:8080 and health probes on :8081, and takes a leader-election lease
(main.go:51-112). Here the same role is played by a thin store shim
around the compiled ``tpu-operator reconcile`` binary: snapshot the
cluster through ``kubectl -o json``, feed the state to the binary,
apply the returned actions, patch the job status, repeat.
Level-triggered polling replaces informer edges (the reconciler is a
pure function of cluster state, so re-running is always safe — same
property the reference relies on for its requeues).

Endpoints (parity: main.go:57,98-105):
- ``:8081/healthz``, ``:8081/readyz`` — liveness/readiness.
- ``:8080/metrics`` — Prometheus text: reconcile count/errors/duration.

Leader election (parity: main.go ``LeaderElection`` option): a
coordination.k8s.io Lease held by one replica; non-holders idle. Enable
with ``--leader-elect``.

The kubectl binary honours ``TPU_OPERATOR_KUBECTL`` so tests can
substitute a recording stub — the same seam the launcher fabric uses.

The port's copy of the JAX package's ``controlplane/kubeshim.py``: the
same ``kubectl`` calls against the same store, around the port's own
``tpu-operator`` build. ``yaml`` is imported only for ``--config``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import queue
import socket
import subprocess
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from dgl_operator_tpu_torch.controlplane import controller as _controller
from dgl_operator_tpu_torch.launcher import console

GROUP = "tpu.graph"
PLURAL = "tpugraphjobs"
KIND_NAME = "TPUGraphJob"

# One selector-scoped list covers every owned kind except the
# name-addressed ConfigMap — two kubectl round-trips per snapshot
# (gang-scheduled jobs add a third for their PodGroup family).
_OWNED_KINDS = "pods,services,serviceaccounts,roles,rolebindings"


class KubectlError(RuntimeError):
    pass


def _now_rfc3339() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%fZ")


def _parse_rfc3339(ts: str) -> Optional[datetime.datetime]:
    """Tolerant RFC3339 parse: with or without fractional seconds or an
    explicit offset — other k8s clients write both forms."""
    try:
        t = datetime.datetime.fromisoformat(ts.replace("Z", "+00:00"))
    except ValueError:
        return None
    if t.tzinfo is None:
        t = t.replace(tzinfo=datetime.timezone.utc)
    return t


class KubectlStore:
    """Cluster snapshot/apply surface over kubectl, mirroring
    FakeCluster.state()/apply() so the reconciler sees one schema.

    ``namespace`` is the watch scope: a single namespace, or "" to
    watch TPUGraphJobs cluster-wide. Per-job operations always run in
    the job's own namespace."""

    def __init__(self, namespace: str = "",
                 kubectl: Optional[str] = None):
        self.namespace = namespace
        self.kubectl = kubectl or os.environ.get(
            "TPU_OPERATOR_KUBECTL", "kubectl")

    # ---- low-level ---------------------------------------------------
    def _run(self, namespace: Optional[str], args: List[str],
             input_text: Optional[str] = None) -> str:
        cmd = [self.kubectl]
        if namespace:
            cmd += ["-n", namespace]
        cmd += args
        # kubectl against a healthy apiserver answers in seconds; five
        # minutes is a dead connection, and a shim verb that never
        # returns wedges the whole reconcile loop (tpu-lint TPU005)
        proc = subprocess.run(cmd, input=input_text, capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise KubectlError(
                f"{' '.join(cmd)} failed: {proc.stderr.strip()}")
        return proc.stdout

    def _get_json(self, namespace: Optional[str],
                  args: List[str]) -> Optional[Dict[str, Any]]:
        # --ignore-not-found keeps rc 0 + empty output for absent
        # objects; every OTHER failure (apiserver down, RBAC, TLS)
        # raises, so a transient read error can never masquerade as an
        # empty cluster and trigger destructive rebuild actions.
        out = self._run(namespace,
                        args + ["-o", "json", "--ignore-not-found"])
        out = out.strip()
        if not out:
            return None
        return json.loads(out)

    # ---- snapshot ----------------------------------------------------
    def list_jobs(self) -> List[Dict[str, Any]]:
        args = ["get", PLURAL]
        if not self.namespace:
            args.append("--all-namespaces")
        got = self._get_json(self.namespace or None, args)
        if not got:
            return []
        return got.get("items", [])

    def get_job(self, namespace: str,
                name: str) -> Optional[Dict[str, Any]]:
        return self._get_json(namespace, ["get", PLURAL, name])

    def watch(self, resource: str, on_object, stop: threading.Event,
              selector: Optional[str] = None) -> None:
        """Stream ``kubectl get <resource> --watch -o json`` objects to
        ``on_object`` until ``stop`` is set — the informer analogue
        (the reference watches via controller-runtime informers,
        SetupWithManager :447-458). Reconnects with backoff
        when the stream drops, like client-go's reflector, and logs the
        stream's stderr so a permanently failing watch (missing RBAC
        verb, absent CRD) is visible instead of a silent fallback to
        resync-only reconciles."""
        backoff = 1.0
        while not stop.is_set():
            cmd = [self.kubectl]
            if self.namespace:
                cmd += ["-n", self.namespace]
            else:
                cmd.append("--all-namespaces")
            cmd += ["get", resource, "--watch", "-o", "json"]
            if selector:
                cmd += ["-l", selector]
            try:
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE,
                                        text=True)
            except OSError as e:
                console.log(
                    f"watch {resource}: spawn failed: {e}",
                    event="watch_spawn_failed", resource=resource,
                    error=str(e))
                stop.wait(5.0)
                continue

            err_tail: List[str] = []

            def _drain_stderr(p=proc, tail=err_tail):
                # keep the pipe from filling (a blocked stderr write
                # would wedge the stdout event stream); remember the
                # last lines for the drop log
                for line in p.stderr:
                    tail.append(line.rstrip())
                    del tail[:-5]

            def _kill(p=proc):
                # unblocks the stdout read below when stop is set — a
                # quiet stream would otherwise pin this thread and the
                # child. Exits when the child dies, so reconnects don't
                # accumulate waiter threads.
                while not stop.wait(1.0):
                    if p.poll() is not None:
                        return
                try:
                    p.kill()
                except OSError:
                    pass

            drainer = threading.Thread(target=_drain_stderr, daemon=True)
            drainer.start()
            threading.Thread(target=_kill, daemon=True).start()
            streamed = False
            try:
                dec = json.JSONDecoder()
                buf = ""
                while not stop.is_set():
                    chunk = proc.stdout.read(4096)
                    if not chunk:
                        break
                    streamed = True
                    buf += chunk
                    while True:
                        s = buf.lstrip()
                        if not s:
                            buf = ""
                            break
                        try:
                            obj, end = dec.raw_decode(s)
                        except json.JSONDecodeError:
                            buf = s
                            break
                        buf = s[end:]
                        on_object(obj)
            finally:
                try:
                    proc.kill()
                except OSError:
                    pass
                proc.wait()
                # let the drainer flush the child's buffered stderr or
                # a fast-failing watch logs an empty reason
                drainer.join(timeout=2.0)
                if err_tail and not stop.is_set():
                    console.log(
                        f"watch {resource} dropped: "
                        f"{' | '.join(err_tail)[-300:]}",
                        event="watch_dropped", resource=resource)
            # reflector-style reconnect: quick after a healthy stream,
            # backing off to 30 s while the watch keeps failing
            backoff = 1.0 if streamed else min(backoff * 2, 30.0)
            stop.wait(backoff)

    def state(self, job: Dict[str, Any]) -> Dict[str, Any]:
        name = job["metadata"]["name"]
        ns = job["metadata"].get("namespace", "default")
        sel = f"app={name}"
        owned = self._get_json(ns, ["get", _OWNED_KINDS, "-l", sel]) \
            or {"items": []}
        by_kind: Dict[str, List[Dict[str, Any]]] = {}
        for item in owned.get("items", []):
            by_kind.setdefault(item.get("kind", ""), []).append(item)

        def names(kind: str) -> List[str]:
            return sorted(i["metadata"]["name"]
                          for i in by_kind.get(kind, []))

        cm = self._get_json(ns, ["get", "configmap", f"{name}-config"])
        # PodGroups: only for gang-scheduled jobs (no extra round-trip
        # on the default path), and group-qualified — a cluster with
        # BOTH volcano and scheduler-plugins CRDs must list the family
        # this job uses, or the idempotency gate never sees the object.
        # A cluster missing the CRD must not break the snapshot either:
        # the create is re-attempted and its admission error surfaces
        # loudly in apply().
        pg_names: List[str] = []
        gang = job.get("spec", {}).get("gangScheduler", "")
        if gang:
            plural = ("podgroups.scheduling.volcano.sh"
                      if gang == "volcano"
                      else "podgroups.scheduling.x-k8s.io")
            try:
                pgs = self._get_json(ns, ["get", plural, "-l", sel]) \
                    or {"items": []}
                pg_names = sorted(i["metadata"]["name"]
                                  for i in pgs.get("items", []))
            except KubectlError:
                pg_names = []
        return {
            "job": job,
            "pods": sorted(by_kind.get("Pod", []),
                           key=lambda p: p["metadata"]["name"]),
            "configMap": cm,
            "existing": {
                "serviceAccounts": names("ServiceAccount"),
                "roles": names("Role"),
                "roleBindings": names("RoleBinding"),
                "services": names("Service"),
                "podGroups": pg_names,
            },
        }

    # ---- apply -------------------------------------------------------
    def apply(self, namespace: str,
              actions: List[Dict[str, Any]]) -> None:
        for a in actions:
            op = a["op"]
            if op == "create":
                try:
                    self._run(namespace, ["create", "-f", "-"],
                              input_text=json.dumps(a["object"]))
                except KubectlError as e:
                    # two reconcile edges racing on the same object is
                    # benign; every other create failure (quota,
                    # admission, schema) must surface
                    if "AlreadyExists" not in str(e) and \
                            "already exists" not in str(e):
                        raise
            elif op == "update":
                self._run(namespace, ["apply", "-f", "-"],
                          input_text=json.dumps(a["object"]))
            elif op == "delete":
                self._run(namespace,
                          ["delete", a["kind"].lower(), a["name"],
                           "--ignore-not-found"])

    def update_status(self, namespace: str, job_name: str,
                      status: Dict[str, Any]) -> None:
        patch = json.dumps({"status": status})
        self._run(namespace,
                  ["patch", PLURAL, job_name, "--type=merge",
                   "--subresource=status", "-p", patch])


class LeaderLease:
    """coordination.k8s.io Lease acquire/renew over kubectl — the
    manager-side equivalent of controller-runtime's LeaderElection
    (reference main.go:84-90, leader_election_role.yaml grants).

    Writes are compare-and-swap: takeover and renewal go through
    ``kubectl replace`` carrying the observed ``resourceVersion``, so
    two standbys racing on a stale lease cannot both win — the loser's
    replace is rejected with a Conflict. A background thread
    (:meth:`start`) renews at duration/3 so leadership survives long
    reconcile passes; losing the lease flips :meth:`is_leader` off."""

    def __init__(self, store: KubectlStore, namespace: str,
                 name: str = "tpu-graph-operator-leader",
                 duration_s: int = 15,
                 identity: Optional[str] = None):
        self.store = store
        self.namespace = namespace or "default"
        self.name = name
        self.duration_s = duration_s
        self.identity = identity or f"{socket.gethostname()}-{os.getpid()}"
        self._stop = threading.Event()
        self._leader = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # (string, first-seen monotonic) of an unparseable renewTime —
        # lets takeover proceed if the same opaque value persists past
        # a full lease duration (holder is dead, not just foreign)
        self._bad_renew: Optional[tuple] = None

    def _lease_obj(self,
                   resource_version: Optional[str]) -> Dict[str, Any]:
        meta: Dict[str, Any] = {"name": self.name,
                                "namespace": self.namespace}
        if resource_version is not None:
            meta["resourceVersion"] = resource_version
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": meta,
            "spec": {"holderIdentity": self.identity,
                     "leaseDurationSeconds": self.duration_s,
                     "renewTime": _now_rfc3339()},
        }

    @staticmethod
    def _benign(e: KubectlError) -> bool:
        s = str(e)
        return ("AlreadyExists" in s or "already exists" in s
                or "Conflict" in s or "conflict" in s)

    def try_acquire(self) -> bool:
        """Acquire, renew, or CAS-take-over a stale lease. True iff
        this process is the holder afterwards."""
        cur = self.store._get_json(
            self.namespace, ["get", "lease", self.name])
        if cur is None:
            try:
                self.store._run(self.namespace, ["create", "-f", "-"],
                                input_text=json.dumps(
                                    self._lease_obj(None)))
            except KubectlError as e:
                if self._benign(e):
                    return False  # lost the creation race
                raise
            return True
        spec = cur.get("spec", {})
        holder = spec.get("holderIdentity")
        if holder and holder != self.identity:
            renew = spec.get("renewTime")
            age = self.duration_s + 1.0
            if renew:
                t = _parse_rfc3339(renew)
                if t is None:
                    # Unparseable renewTime from a foreign client:
                    # treat the lease as fresh rather than seizing it
                    # from a possibly-live holder — but only until the
                    # SAME opaque value has persisted a full lease
                    # duration (a live holder would have renewed it;
                    # a dead one must not deadlock leadership forever).
                    now = time.monotonic()
                    if (self._bad_renew is not None
                            and self._bad_renew[0] == renew
                            and now - self._bad_renew[1]
                            > self.duration_s):
                        age = self.duration_s + 1.0
                    else:
                        if (self._bad_renew is None
                                or self._bad_renew[0] != renew):
                            self._bad_renew = (renew, now)
                        age = 0.0
                else:
                    self._bad_renew = None
                    age = (datetime.datetime.now(
                        datetime.timezone.utc) - t).total_seconds()
            if age <= spec.get("leaseDurationSeconds",
                               self.duration_s):
                return False  # held by a live peer
        rv = cur.get("metadata", {}).get("resourceVersion")
        try:
            self.store._run(
                self.namespace, ["replace", "-f", "-"],
                input_text=json.dumps(self._lease_obj(rv)))
        except KubectlError as e:
            if self._benign(e):
                return False  # another replica CAS'd first
            raise
        return True

    # ---- background renewal -----------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    if self.try_acquire():
                        self._leader.set()
                    else:
                        self._leader.clear()
                except Exception as e:  # apiserver blip: drop leadership
                    console.log(f"leader election: {e}",
                                event="leader_election_error",
                                error=str(e))
                    self._leader.clear()
                self._stop.wait(self.duration_s / 3.0)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def is_leader(self) -> bool:
        return self._leader.is_set()


class Metrics:
    def __init__(self) -> None:
        self.reconciles = 0
        self.errors = 0
        self.duration_sum = 0.0
        self.lock = threading.Lock()

    def observe(self, seconds: float, error: bool) -> None:
        with self.lock:
            self.reconciles += 1
            self.duration_sum += seconds
            if error:
                self.errors += 1

    def render(self) -> str:
        # reconcile duration is exposed as a proper Prometheus summary
        # (matching _sum/_count pair) so scrapers can compute
        # rate(sum)/rate(count) averages.
        with self.lock:
            return (
                "# TYPE tpu_operator_reconcile_total counter\n"
                f"tpu_operator_reconcile_total {self.reconciles}\n"
                "# TYPE tpu_operator_reconcile_errors_total counter\n"
                f"tpu_operator_reconcile_errors_total {self.errors}\n"
                "# TYPE tpu_operator_reconcile_duration_seconds summary\n"
                "tpu_operator_reconcile_duration_seconds_sum "
                f"{self.duration_sum:.6f}\n"
                "tpu_operator_reconcile_duration_seconds_count "
                f"{self.reconciles}\n")


def _serve(port: int, routes: Dict[str, Any],
           host: str = "0.0.0.0") -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            body = routes.get(self.path)
            if body is None:
                self.send_response(404)
                self.end_headers()
                return
            text = body() if callable(body) else body
            data = text.encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):  # quiet
            pass

    srv = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


class Manager:
    """The operator main loop: for each TPUGraphJob in scope,
    snapshot → reconcile (native binary) → apply → status patch."""

    def __init__(self, store: KubectlStore,
                 watcher_image: str = "tpu-watcher:latest",
                 metrics_port: int = 8080, health_port: int = 8081,
                 serve: bool = True,
                 lease: Optional[LeaderLease] = None,
                 metrics_host: str = "0.0.0.0"):
        _controller.ensure_built()
        self.store = store
        self.watcher_image = watcher_image
        self.metrics = Metrics()
        self.lease = lease
        self.servers: List[ThreadingHTTPServer] = []
        if serve:
            # metrics_host=127.0.0.1 puts /metrics behind the
            # kube-rbac-proxy sidecar (config/default/
            # manager_auth_proxy_patch.yaml), the reference's guarded-
            # metrics layout; port 0 = metrics disabled (the
            # controller-runtime bind-address sentinel)
            if metrics_port:
                self.servers.append(_serve(metrics_port, {
                    "/metrics": self.metrics.render}, host=metrics_host))
            self.servers.append(_serve(health_port, {
                "/healthz": "ok\n", "/readyz": "ok\n"}))

    def reconcile_job(self, job: Dict[str, Any],
                      max_iters: int = 20) -> Dict[str, Any]:
        """Reconcile one job to a fixed point. The native binary is one
        Reconcile pass; requeue / actions / a phase edge replay the way
        controller-runtime's workqueue re-queues on watched-object
        changes (reconcile_until parity with the test controller)."""
        ns = job["metadata"].get("namespace", "default")
        t0 = time.time()
        error = True
        try:
            result: Dict[str, Any] = {}
            for _ in range(max_iters):
                state = self.store.state(job)
                result = _controller.run_reconciler(
                    state, self.watcher_image)
                self.store.apply(ns, result.get("actions", []))
                status = result.get("status")
                status_changed = bool(status) and status != job.get(
                    "status")
                if status_changed:
                    self.store.update_status(
                        ns, job["metadata"]["name"], status)
                    job = dict(job, status=status)
                if (not result.get("actions")
                        and not result.get("requeue")
                        and not status_changed):
                    break
            error = False
            return result
        finally:
            self.metrics.observe(time.time() - t0, error)

    def run_once(self) -> int:
        jobs = self.store.list_jobs()
        for job in jobs:
            try:
                self.reconcile_job(job)
            except Exception as e:  # job-scoped: log, move on, retry
                console.log(
                    f"reconcile {job['metadata'].get('name')}: {e}",
                    event="reconcile_error",
                    job=job["metadata"].get("name"), error=str(e))
        return len(jobs)

    def run_forever(self, interval: float = 2.0) -> None:
        if self.lease is not None:
            self.lease.start()
        while True:
            if self.lease is not None and not self.lease.is_leader():
                time.sleep(interval)
                continue
            try:
                self.run_once()
            except Exception as e:  # transient list failure: retry
                console.log(f"manager pass failed: {e}",
                            event="manager_pass_failed",
                            error=str(e))
            time.sleep(interval)

    # ---- watch-driven loop (informer analogue) -----------------------
    def _start_watches(self, stop: threading.Event) -> "queue.Queue":
        """Two streams — jobs and owned pods — feed one workqueue of
        (namespace, job-name) keys: the shape of the reference's
        SetupWithManager Owns(Pod) + field-indexer mapping
        (dgljob_controller.go:436-458)."""
        q: "queue.Queue" = queue.Queue()

        def enqueue_job(obj):
            meta = obj.get("metadata", {})
            if obj.get("kind") == KIND_NAME:
                q.put((meta.get("namespace", "default"),
                       meta.get("name", "")))
            elif obj.get("kind") == "Pod":
                app = meta.get("labels", {}).get("app")
                if app:   # owned pods carry app=<job> (MakeMeta)
                    q.put((meta.get("namespace", "default"), app))
            elif obj.get("kind", "").endswith("List"):
                for item in obj.get("items", []):
                    enqueue_job(item)

        # the pod stream is selector-scoped to operator-owned pods
        # (every FinishPod stamps tpu.graph/replica-type), so traffic
        # is O(owned changes), not O(cluster pod churn)
        for resource, sel in ((PLURAL, None),
                              ("pods", "tpu.graph/replica-type")):
            threading.Thread(
                target=self.store.watch,
                args=(resource, enqueue_job, stop, sel),
                daemon=True).start()
        return q

    def run_watching(self, resync: float = 30.0,
                     stop: Optional[threading.Event] = None) -> None:
        """Event-driven reconcile: watched job/pod changes trigger the
        affected job only; a periodic full resync (informer cache-
        resync parity) backstops missed events. O(changes) kubectl
        traffic instead of O(jobs) every tick.
        """
        stop = stop or threading.Event()
        if self.lease is not None:
            self.lease.start()
        q = self._start_watches(stop)
        last_full = 0.0
        while not stop.is_set():
            if self.lease is not None and not self.lease.is_leader():
                stop.wait(1.0)
                continue
            pending = set()
            try:
                pending.add(q.get(timeout=1.0))
                while True:
                    pending.add(q.get_nowait())
            except queue.Empty:
                pass
            try:
                if time.time() - last_full > resync:
                    self.run_once()
                    last_full = time.time()
                    continue
                for ns, name in pending:
                    if stop.is_set():
                        break
                    # job-scoped isolation, like run_once: one job's
                    # transient failure must not drop the other
                    # drained events
                    try:
                        job = self.store.get_job(ns, name)
                        if job is not None:
                            self.reconcile_job(job)
                    except Exception as e:
                        console.log(f"reconcile {name}: {e}",
                                    event="reconcile_error",
                                    job=name, error=str(e))
            except Exception as e:  # transient: keep watching
                console.log(f"watch pass failed: {e}",
                            event="watch_pass_failed",
                            error=str(e))

    def shutdown(self) -> None:
        for s in self.servers:
            s.shutdown()


def resolve_serving_options(metrics_bind_address: Optional[str],
                            metrics_port: Optional[int],
                            health_port: Optional[int],
                            leader_elect: bool,
                            config_path: Optional[str]):
    """Layered manager options, flags > file > defaults — the
    reference's ComponentConfig pattern (ctrl.Options loaded from
    --config, flag overrides; config/manager/
    controller_manager_config.yaml). Returns
    (metrics_host, metrics_port, health_port, leader_elect)."""
    file_cfg: Dict[str, Any] = {}
    if config_path:
        import yaml
        with open(config_path) as f:
            file_cfg = yaml.safe_load(f) or {}
    # (x or {}): a present-but-empty YAML section loads as None, which
    # must behave like an absent one, not crash .get
    bind = metrics_bind_address or (file_cfg.get("metrics")
                                    or {}).get("bindAddress")
    metrics_host = "0.0.0.0"
    if bind:
        b = str(bind)
        if b == "0":        # controller-runtime's disable sentinel —
            # same precedence as below: a file-supplied "0" must not
            # discard an explicitly flagged --metrics-port
            if metrics_bind_address is not None or metrics_port is None:
                metrics_host, metrics_port = "0.0.0.0", 0
        else:
            host, sep, port_s = b.rpartition(":")
            if not sep or not port_s.isdigit():
                raise ValueError(
                    "metrics bindAddress needs host:port or '0' "
                    f"(disable), got {b!r}")
            metrics_host = host or "0.0.0.0"
            # the flag's documented contract: an explicit
            # --metrics-bind-address overrides --metrics-port; a
            # file-supplied bindAddress only fills an unset port
            if metrics_bind_address is not None or metrics_port is None:
                metrics_port = int(port_s)
    if metrics_port is None:
        metrics_port = 8080
    if health_port is None:
        hb = (file_cfg.get("health") or {}).get("healthProbeBindAddress")
        health_port = int(str(hb).rpartition(":")[2]) if hb else 8081
    leader_elect = leader_elect or bool(
        (file_cfg.get("leaderElection") or {}).get("leaderElect"))
    return metrics_host, metrics_port, health_port, leader_elect


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="tpu-graph-operator manager (kube shim)")
    ap.add_argument("--namespace", default=os.environ.get(
        "WATCH_NAMESPACE", ""),
        help="namespace to watch; empty = all namespaces")
    ap.add_argument("--watcher-image", default="tpu-watcher:latest")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--metrics-port", type=int, default=None)
    ap.add_argument("--metrics-bind-address", default=None,
                    help="host:port for /metrics (127.0.0.1:8080 puts "
                         "it behind the kube-rbac-proxy sidecar); "
                         "overrides --metrics-port")
    ap.add_argument("--config", default=None,
                    help="manager config YAML (ComponentConfig parity: "
                         "reference config/manager/"
                         "controller_manager_config.yaml) — flags win "
                         "over file values")
    ap.add_argument("--health-port", type=int, default=None)
    ap.add_argument("--leader-elect", action="store_true")
    ap.add_argument("--leader-elect-namespace",
                    default=os.environ.get("POD_NAMESPACE", "default"))
    ap.add_argument("--once", action="store_true",
                    help="single pass over all jobs, then exit")
    ap.add_argument("--watch", action="store_true",
                    help="event-driven loop: kubectl --watch streams "
                         "trigger affected jobs (informer analogue); "
                         "--interval becomes the full-resync period")
    args = ap.parse_args(argv)
    (metrics_host, metrics_port, health_port,
     leader_elect) = resolve_serving_options(
        args.metrics_bind_address, args.metrics_port, args.health_port,
        args.leader_elect, args.config)
    store = KubectlStore(namespace=args.namespace)
    lease = None
    if leader_elect:
        lease = LeaderLease(store, args.leader_elect_namespace)
    mgr = Manager(store, watcher_image=args.watcher_image,
                  metrics_port=metrics_port,
                  health_port=health_port, serve=not args.once,
                  lease=lease, metrics_host=metrics_host)
    if args.once:
        mgr.run_once()
        return 0
    if args.watch:
        mgr.run_watching(resync=max(args.interval, 10.0))
        return 0
    mgr.run_forever(args.interval)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
