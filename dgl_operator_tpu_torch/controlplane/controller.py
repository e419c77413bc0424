"""Reconcile loop driving the native ``tpu-operator`` binary.

One :meth:`Controller.reconcile` call = one edge of the level-triggered
loop (DGLJobReconciler.Reconcile parity): snapshot cluster state, run
the compiled reconciler, apply its actions to the store, write back the
job status. ``reconcile_until`` re-runs to a fixed point the way
controller-runtime's workqueue re-queues on every watched-object change.

The port's copy of the JAX package's ``controlplane/controller.py``. Its
binaries are built from the port's own sources
(``native/controlplane/``) at first use, by the host compiler, into
``dgl_operator_tpu_torch/_build/`` (``ops/_build.py::build_host_exe``);
``TPU_OPERATOR_NATIVE_BIN_DIR`` names a directory of prebuilt binaries
instead, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Callable, Dict, Optional, Tuple

from dgl_operator_tpu_torch.controlplane.api import TPUGraphJob
from dgl_operator_tpu_torch.controlplane.cluster import FakeCluster
from dgl_operator_tpu_torch.obs import get_obs

# each binary's sources and the headers they include, under native/
_SOURCES: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "tpu-operator": (("controlplane/operator_main.cc",
                      "controlplane/reconciler.cc",
                      "controlplane/json.cc"),
                     ("controlplane/reconciler.hpp",
                      "controlplane/json.hpp")),
    "tpu-watcher": (("controlplane/watcher_main.cc",), ()),
}


class BuildError(RuntimeError):
    """Native control-plane build failed; the message carries the
    compiler's output."""


class ReconcileExhausted(RuntimeError):
    """``reconcile_until`` ran out of iterations without converging to
    a fixed point (or the requested phase) — the loop is live-locked or
    the target is unreachable, which silent best-effort return used to
    mask."""

    def __init__(self, msg: str, phase: str):
        super().__init__(msg)
        self.phase = phase


def job_health_feed(obs_dir: str,
                    timeout: float = 1.0) -> Callable[[], Dict]:
    """The controller's stall signal, live-first: a zero-arg health
    callable for :meth:`Controller.reconcile_until` that queries the
    trainers' /livez sidecars (``obs/live.py`` — a wedged loop thread
    cannot silence its own sidecar) and falls back to the file-based
    ``job_health()`` events scan when no sidecar answers. The returned
    snapshot carries ``source: live|file`` so operators can tell which
    plane produced a restart decision."""
    def feed() -> Dict:
        from dgl_operator_tpu_torch.obs.live import live_job_health
        return live_job_health(obs_dir, timeout=timeout)

    return feed


def _collect_on_exhaustion(reason: str) -> None:
    """Best-effort job-view materialization when a reconcile loop gives
    up: the controller has no hostfile to fetch over, but a
    single-host/local view is exactly what ``tpu-doctor`` needs to
    diagnose the live-lock — so build it from the run's own obs dir
    and mark the failure-path collection."""
    obs = get_obs()
    if not obs.directory:
        return
    try:
        from dgl_operator_tpu_torch.obs.collect import (job_dir_of,
                                                  merge_job_view)
        obs.flush()
        man = merge_job_view(job_dir_of(obs.directory),
                             sources=[("local", obs.directory)])
        obs.emit("obs_collect_on_failure", reason=reason,
                 events=man["events"], procs=man["procs"])
    except Exception as exc:  # noqa: BLE001 — never worsen the failure
        obs.emit("obs_collect_failed", error=str(exc)[:300])


# a directory of prebuilt binaries (a sanitized build, say) the whole
# Python control plane then drives unchanged, instead of its own build
BIN_DIR_ENV = "TPU_OPERATOR_NATIVE_BIN_DIR"


def _build_binary(name: str):
    """Build ``name`` from the port's sources unless this exact build is
    on disk (named by a hash of its sources); returns the
    ``BuildResult``."""
    from dgl_operator_tpu_torch.ops._build import build_host_exe
    sources, headers = _SOURCES[name]
    try:
        return build_host_exe(name, sources, headers)
    except RuntimeError as exc:
        raise BuildError(f"native control-plane build of {name} "
                         f"failed: {exc}") from exc


def _binary(name: str) -> str:
    """The binary ``name``: under ``TPU_OPERATOR_NATIVE_BIN_DIR`` when
    it is set, else this package's build of it (built at first use)."""
    if os.environ.get(BIN_DIR_ENV):
        return os.path.abspath(os.path.join(os.environ[BIN_DIR_ENV],
                                            name))
    return _build_binary(name).path


def operator_binary() -> str:
    return _binary("tpu-operator")


def watcher_binary() -> str:
    return _binary("tpu-watcher")


def ensure_built() -> Dict[str, float]:
    """Build the control-plane binaries from the port's sources unless
    this exact build is already there, and return each one's compile
    seconds (0.0 for a build found on disk). A failing build raises
    :class:`BuildError` with the compiler's output. With
    ``TPU_OPERATOR_NATIVE_BIN_DIR`` set nothing is built: a directory
    that lacks the binaries raises rather than fall back to the
    default build."""
    if os.environ.get(BIN_DIR_ENV):
        if os.path.exists(operator_binary()) and os.path.exists(
                watcher_binary()):
            return {}
        raise BuildError(
            f"{BIN_DIR_ENV}={os.environ[BIN_DIR_ENV]} names no built "
            "binaries; refusing to fall back to the default build")
    return {name: _build_binary(name).seconds for name in _SOURCES}


def run_reconciler(state: Dict[str, Any],
                   watcher_image: str) -> Dict[str, Any]:
    """One pass of the compiled reconciler over a cluster snapshot.
    Single owner of the binary's CLI + result contract — used by both
    the test Controller and the production kubeshim Manager."""
    # one reconcile edge is pure in-memory JSON work — two minutes
    # means the binary is wedged (sanitizer deadlock, bad stdin pipe)
    proc = subprocess.run(
        [operator_binary(), "--watcher-image", watcher_image,
         "reconcile"],
        input=json.dumps(state), capture_output=True, text=True,
        timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(
            f"tpu-operator reconcile failed: {proc.stderr}")
    return json.loads(proc.stdout)


class Controller:
    def __init__(self, cluster: FakeCluster,
                 watcher_image: str = "tpu-watcher:latest"):
        ensure_built()
        self.cluster = cluster
        self.watcher_image = watcher_image

    def reconcile(self, job: TPUGraphJob) -> Dict[str, Any]:
        """One reconcile pass; returns the raw result
        {actions, status, requeue} after applying it. Counted, and any
        phase edge lands in the event log — the reference's only
        record of a transition is a transient `kubectl get -w` line."""
        obs = get_obs()
        prev_phase = job.status.get("phase", "")
        state = self.cluster.state(job.to_dict(),
                                   f"{job.name}-config")
        result = run_reconciler(state, self.watcher_image)
        self.cluster.apply(result.get("actions", []))
        status = result.get("status")
        if status:
            job.status = status
        obs.metrics.counter("controller_reconciles_total",
                            "reconcile passes").inc()
        new_phase = job.status.get("phase", "")
        if new_phase != prev_phase:
            obs.emit("phase_transition", job=job.name,
                     from_phase=prev_phase, to_phase=new_phase)
            obs.metrics.counter(
                "controller_phase_transitions_total",
                "job phase edges observed by the reconcile loop",
                labels=("from_phase", "to_phase")).inc(
                    from_phase=prev_phase or "(new)",
                    to_phase=new_phase)
        return result

    def reconcile_until(self, job: TPUGraphJob,
                        phase: Optional[str] = None,
                        max_iters: int = 20,
                        backoff_limit: Optional[int] = None,
                        backoff_base: float = 0.0,
                        backoff_cap: float = 5.0,
                        sleep: Callable[[float], None] = time.sleep,
                        health: Optional[Callable[[], Dict[str, Any]]]
                        = None) -> str:
        """Re-reconcile to a fixed point (no actions, stable phase), or
        until the job phase matches ``phase``. Mirrors the edge-triggered
        requeue behavior of the real controller manager.

        Failure semantics (the reference's Evicted→restart loop, made
        bounded): every pass where the job sits in ``Failed`` and the
        reconciler still requeues counts as a *restart* (the reconciler
        deletes the failed launcher for retry on that edge);
        ``backoff_limit`` caps those restarts — past it the loop stops
        re-spawning, stamps ``reason: BackoffLimitExceeded`` into the
        status, and returns ``"Failed"`` (the job is now terminally
        failed, k8s Job backoffLimit semantics). ``None`` = unbounded
        (the seed behavior).

        Requeue pacing: consecutive requeued passes back off
        ``backoff_base * 2^k`` capped at ``backoff_cap`` (reset on any
        phase edge). Default base 0 keeps tests and converging loops
        full-speed; the production manager passes real values. ``sleep``
        is injectable for tests.

        Health (the observability plane's stall signal): ``health`` is
        a zero-arg callable returning a job-health snapshot
        (``obs.analyze.job_health`` shape — at minimum a ``stalled``
        list, plus the elastic plane's ``dead`` list). While the job
        is ``Training``, a snapshot naming stalled workers makes the
        controller act as the kubelet cannot: a stalled trainer's pod
        still *looks* Running, so the launcher pod is marked Failed
        with reason ``Stalled`` and the reconciler's eviction-style
        self-heal replaces it (delete + recreate; the relaunched
        driver resumes from the phase ledger and checkpoints) — the
        job restarts instead of hanging until some deadline. A
        snapshot naming DEAD workers (``host_died`` — permanent loss,
        not a wedge) restarts with reason ``HostDead`` instead: the
        relaunched elastic driver re-plans around the dead host
        (``tpurun --elastic``, launcher/elastic.py) rather than
        waiting for it. Detections are counted
        (``controller_stalls_detected_total`` /
        ``controller_hosts_dead_total``) and evented (``job_stalled``
        / ``job_host_dead``).

        Restart accounting: EVERY restart edge
        counts toward ``backoff_limit`` — Failed→requeue passes AND
        health-triggered restarts (a stalled→restart cycle that never
        recovers used to loop until ``max_iters``). Past the limit the
        job is terminally Failed with ``reason: BackoffLimitExceeded``
        and a message naming the dead/stalled workers plus the top
        tpu-doctor findings from the run's telemetry.

        Termination: returns the phase on convergence or target-phase
        match; raises :class:`ReconcileExhausted` when ``max_iters``
        passes did neither — exhaustion is an error, not a result.
        """
        obs = get_obs()
        last_phase = job.status.get("phase", "")
        restarts = 0
        requeues = 0
        unhealthy: list = []
        for _ in range(max_iters):
            acted_on_health = False
            if health is not None and \
                    job.status.get("phase") == "Training":
                acted = self._act_on_health(job, health() or {})
                if acted:
                    acted_on_health = True
                    unhealthy = acted
                    restarts += 1
                    obs.metrics.counter(
                        "controller_restarts_total",
                        "Failed->requeue launcher restarts").inc()
                    if backoff_limit is not None \
                            and restarts > backoff_limit:
                        return self._backoff_exhausted(
                            job, restarts, backoff_limit, unhealthy)
            result = self.reconcile(job)
            new_phase = job.status.get("phase", "")
            if phase is not None and new_phase == phase:
                return new_phase
            if (not result.get("actions") and not result.get("requeue")
                    and new_phase == last_phase):
                return new_phase
            if new_phase == "Failed" and result.get("requeue"):
                # a health action this pass already counted its
                # restart — the Failed edge it provoked is the same
                # cycle, not a second one
                if not acted_on_health:
                    restarts += 1
                    obs.metrics.counter(
                        "controller_restarts_total",
                        "Failed->requeue launcher restarts").inc()
                if backoff_limit is not None and restarts > backoff_limit:
                    return self._backoff_exhausted(
                        job, restarts, backoff_limit, unhealthy)
            if result.get("requeue"):
                requeues += 1
                obs.metrics.counter("controller_requeues_total",
                                    "reconcile passes that requeued"
                                    ).inc()
                if backoff_base > 0:
                    d = min(backoff_base * (2 ** (requeues - 1)),
                            backoff_cap)
                    obs.metrics.counter(
                        "controller_backoffs_total",
                        "requeue backoff sleeps").inc()
                    sleep(d)
            if new_phase != last_phase:
                requeues = 0
            last_phase = new_phase
        obs.emit("reconcile_exhausted", job=job.name,
                 max_iters=max_iters, phase=last_phase)
        _collect_on_exhaustion(
            f"reconcile_exhausted: {job.name} stuck at "
            f"{last_phase!r} after {max_iters} iterations")
        raise ReconcileExhausted(
            f"reconcile_until exhausted {max_iters} iterations at phase "
            f"{last_phase!r}" + (f" without reaching {phase!r}"
                                 if phase is not None else ""),
            last_phase)

    def _backoff_exhausted(self, job: TPUGraphJob, restarts: int,
                           backoff_limit: int,
                           unhealthy: list) -> str:
        """Terminal Failed stamp shared by both restart-counting
        paths: names the workers whose stall/death burned the budget
        (the operator's first question) and appends the top tpu-doctor
        findings from the run's own telemetry (the second)."""
        obs = get_obs()
        job.status["phase"] = "Failed"
        job.status["reason"] = "BackoffLimitExceeded"
        msg = (f"job restarted {restarts - 1} time(s); "
               f"backoff_limit={backoff_limit} exhausted")
        if unhealthy:
            msg += ("; unhealthy workers never recovered: "
                    + ", ".join(str(w) for w in unhealthy))
        brief = self._doctor_brief()
        if brief:
            msg += "; doctor: " + brief
        job.status["message"] = msg
        obs.metrics.counter(
            "controller_backoff_exhausted_total",
            "jobs terminally Failed by backoff_limit").inc()
        obs.emit("backoff_limit_exceeded", job=job.name,
                 restarts=restarts - 1, backoff_limit=backoff_limit,
                 unhealthy=list(unhealthy))
        return "Failed"

    def _doctor_brief(self, limit: int = 3) -> str:
        """Top doctor findings from the run's obs dir, one line —
        best-effort (an exhaustion message must never fail to stamp
        because analytics did)."""
        obs = get_obs()
        if not obs.directory:
            return ""
        try:
            obs.flush()
            from dgl_operator_tpu_torch.obs.analyze import analyze_job
            findings = analyze_job(obs.directory).get("findings", [])
            return "; ".join(
                f"[{f['severity']}] {f['kind']}: {f['message']}"
                for f in findings[:limit])
        except Exception:  # noqa: BLE001 — diagnosis is best-effort
            return ""

    def _act_on_health(self, job: TPUGraphJob,
                       snap: Dict[str, Any]) -> list:
        """Turn an unhealthy snapshot into a restart edge; returns the
        workers acted on (empty = healthy, no action). The kubelet
        cannot see a wedged-but-alive trainer, so the controller plays
        it: the launcher pod (the restart unit — a relaunched driver
        resumes via ledger + checkpoints) is marked Failed, which the
        reconciler handles like an eviction: transient, pod replaced,
        job back to Training when the replacement runs. Controllers
        without a cluster store stamp the job status directly.

        The reason separates the elastic split (launcher/elastic.py):
        ``Stalled`` = wedged but maybe recoverable in place;
        ``HostDead`` = the health plane saw a ``host_died`` event —
        permanent loss, and the relaunched ``tpurun --elastic`` driver
        re-places the dead host's partitions over the survivors
        instead of waiting for all hosts to return."""
        stalled = list(snap.get("stalled") or [])
        dead = list(snap.get("dead") or [])
        numerics = list(snap.get("numerics") or [])
        replicas = list(snap.get("replicas_down") or [])
        if not stalled and not dead and not numerics and not replicas:
            return []
        obs = get_obs()
        if stalled:
            obs.metrics.counter(
                "controller_stalls_detected_total",
                "stalled-job detections from the health snapshot").inc()
            obs.emit("job_stalled", job=job.name, stalled=stalled)
        if dead:
            obs.metrics.counter(
                "controller_hosts_dead_total",
                "dead-worker detections from the health snapshot "
                "(host_died — the elastic shrink trigger)").inc(
                    len(dead))
            obs.emit("job_host_dead", job=job.name, dead=dead,
                     dead_hosts=list(snap.get("dead_hosts") or []))
        if numerics:
            # a worker the numerics sentry halted (obs/quality.py):
            # the relaunched driver resumes from the last-known-good
            # checkpoint; the restart edge counts toward backoff_limit
            # like every other (a model that NaNs on every relaunch
            # must terminally fail, with the doctor brief naming the
            # bad step via the numerics_fault finding)
            obs.metrics.counter(
                "controller_numerics_total",
                "numerics-fault detections from the health "
                "snapshot").inc(len(numerics))
            obs.emit("job_numerics_fault", job=job.name,
                     numerics=numerics)
        if replicas:
            # a serving replica the router marked down and never
            # readmitted (serve/router.py): the fleet drained its
            # traffic to survivors, so the job keeps serving — but the
            # process itself needs replacing, and the restart counts
            # toward backoff_limit like every other (a replica that
            # dies on every relaunch must terminally fail)
            obs.metrics.counter(
                "controller_replicas_dead_total",
                "serving-replica-down detections from the health "
                "snapshot").inc(len(replicas))
            obs.emit("job_replica_dead", job=job.name,
                     replicas=replicas)
        reason = ("HostDead" if dead
                  else "NumericsFault" if numerics
                  else "Stalled" if stalled else "ReplicaDead")
        cluster = getattr(self, "cluster", None)
        launcher = f"{job.name}-launcher"
        if cluster is not None and launcher in getattr(cluster, "pods",
                                                       {}):
            cluster.set_pod_phase(launcher, "Failed", reason=reason)
        else:
            job.status["phase"] = "Failed"
            job.status["reason"] = reason
            job.status.setdefault(
                "message",
                (f"dead workers: {', '.join(dead)}" if dead
                 else f"numerics faults: {', '.join(numerics)}"
                 if numerics
                 else f"stalled workers: {', '.join(stalled)}"
                 if stalled
                 else f"dead replicas: {', '.join(replicas)}"))
        return dead + numerics + stalled + replicas
