"""The port's control plane (``dgl_operator_tpu_torch/controlplane/``)
and its own build of the native reconciler and watcher
(``native/controlplane/``), then parity with the JAX package's.

The JAX package's ``tests/test_controlplane.py`` cases run on the port:
a TPUGraphJob driven through Partitioning -> Partitioned -> Training ->
Completed against a cluster with no kubelet (pod phases set by hand),
the objects the controller materializes, the compiled ``tpu-watcher``
barrier against the fake cluster's status directory, the
``reconcile_until`` loop policy and the build diagnostics. Then both
controllers, each on its own package's binaries, go through the full
phase sequence, a failure, a backoff exhaustion and a health-triggered
restart side by side, with equal cluster objects and job status after
every step. The JAX binaries are compiled from the JAX package's
sources with ``g++`` into a temporary directory and named to the JAX
controller by ``TPU_OPERATOR_NATIVE_BIN_DIR`` for its calls only; the
JAX tree's own build is never made or run. ``jax_controlplane_bins`` and
``jax_bin_dir`` are shared with ``tests/test_torch_kubeshim.py``.
"""

import contextlib
import copy
import json
import os
import re
import subprocess
import time

import pytest

from dgl_operator_tpu.controlplane import FakeCluster as JFakeCluster
from dgl_operator_tpu.controlplane import simple_job as j_simple_job
from dgl_operator_tpu.controlplane.controller import Controller as JController
from dgl_operator_tpu_torch.controlplane import (Controller, FakeCluster,
                                                 TPUGraphJob, replica_spec,
                                                 simple_job, watcher_binary)
from dgl_operator_tpu_torch.controlplane import controller as controller_mod
from dgl_operator_tpu_torch.controlplane.api import DEFAULT_LAUNCHER_COMMAND
from dgl_operator_tpu_torch.controlplane.controller import (
    BIN_DIR_ENV, BuildError, ReconcileExhausted, ensure_built)
from dgl_operator_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CP = os.path.join(REPO, "dgl_operator_tpu", "native", "controlplane")
_JAX_BINS = {}


def jax_controlplane_bins(tmp_path_factory) -> str:
    """A directory holding the JAX package's ``tpu-operator`` and
    ``tpu-watcher``, compiled from its sources with the port's host
    compiler into a temporary directory, once per test process."""
    if "dir" not in _JAX_BINS:
        out = tmp_path_factory.mktemp("jax_controlplane")
        for name, sources in (
                ("tpu-operator", ("operator_main.cc", "reconciler.cc",
                                  "json.cc")),
                ("tpu-watcher", ("watcher_main.cc",))):
            proc = subprocess.run(
                [_build.host_cxx(), *_build.HOST_EXE_CXXFLAGS, "-o",
                 str(out / name),
                 *[os.path.join(JAX_CP, s) for s in sources]],
                capture_output=True, text=True, timeout=300)
            assert proc.returncode == 0, proc.stdout + proc.stderr
        _JAX_BINS["dir"] = str(out)
    return _JAX_BINS["dir"]


@contextlib.contextmanager
def jax_bin_dir(path: str):
    """``TPU_OPERATOR_NATIVE_BIN_DIR`` set to ``path`` inside the block
    (the JAX controller's calls), unset again after it (the port's)."""
    old = os.environ.get(BIN_DIR_ENV)
    os.environ[BIN_DIR_ENV] = path
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(BIN_DIR_ENV, None)
        else:
            os.environ[BIN_DIR_ENV] = old


@pytest.fixture(scope="module", autouse=True)
def _built():
    os.environ.pop(BIN_DIR_ENV, None)
    ensure_built()


def _make(tmp_path, num_workers=2, **kw):
    cluster = FakeCluster(status_dir=str(tmp_path / "podstatus"))
    ctl = Controller(cluster)
    job = simple_job("sage", num_workers, **kw)
    return cluster, ctl, job


# ------------------------------------------------------------ reconcile
def test_first_reconcile_creates_infra_and_gated_pods(tmp_path):
    cluster, ctl, job = _make(tmp_path)
    ctl.reconcile(job)
    # ConfigMap + RBAC for launcher AND partitioner (TPU-API mode)
    assert "sage-config" in cluster.config_maps
    assert {"sage-launcher", "sage-partitioner"} <= set(
        cluster.service_accounts)
    assert {"sage-launcher", "sage-partitioner"} <= set(cluster.roles)
    # launcher + partitioner exist; workers are phase-gated (created
    # only after Partitioned, dgljob_controller.go:282-302)
    assert cluster.pod_names() == ["sage-launcher", "sage-partitioner"]
    cm = cluster.config_maps["sage-config"]["data"]
    assert "exec" in cm["exec.sh"]
    assert cm["hostfile"] == ""   # no worker IPs yet


def test_launcher_pod_shape(tmp_path):
    cluster, ctl, job = _make(tmp_path)
    ctl.reconcile(job)
    launcher = cluster.pods["sage-launcher"]
    inits = [c["name"] for c in launcher["spec"]["initContainers"]]
    # barrier order parity (dgljob_controller.go:1098-1194)
    assert inits == ["watcher-partitioner", "watcher-worker"]
    modes = {c["name"]: dict((e["name"], e["value"]) for e in c["env"])
             for c in launcher["spec"]["initContainers"]}
    assert modes["watcher-partitioner"]["WATCHERMODE"] == "finished"
    assert modes["watcher-partitioner"]["WATCHERFILE"].endswith("partfile")
    assert modes["watcher-worker"]["WATCHERMODE"] == "ready"
    env = dict((e["name"], e["value"])
               for e in launcher["spec"]["containers"][0]["env"])
    assert env["TPU_OPERATOR_EXEC_PATH"] == "/etc/tpugraph/exec.sh"
    assert launcher["spec"]["serviceAccountName"] == "sage-launcher"


def test_partitioner_runs_launcher_command_with_phase_env(tmp_path):
    cluster, ctl, job = _make(tmp_path)
    ctl.reconcile(job)
    part = cluster.pods["sage-partitioner"]
    c = part["spec"]["containers"][0]
    # copied from the launcher (:1025-1034): by default the port's
    # driver, started by module
    assert c["command"] == list(DEFAULT_LAUNCHER_COMMAND) == \
        ["python3", "-m", "dgl_operator_tpu_torch.launcher.tpurun"]
    assert cluster.pods["sage-launcher"]["spec"]["containers"][0][
        "command"] == c["command"]
    env = dict((e["name"], e["value"]) for e in c["env"])
    assert env["TPU_OPERATOR_PHASE_ENV"] == "Partitioner"


def test_full_phase_sequence(tmp_path):
    """The dgljob_controller_test.go:151-213 sequence."""
    cluster, ctl, job = _make(tmp_path, num_workers=2)
    ctl.reconcile(job)

    # partitioner running -> Partitioning
    cluster.set_pod_phase("sage-partitioner", "Running")
    assert ctl.reconcile_until(job, "Partitioning") == "Partitioning"

    # partitioner succeeded -> Partitioned; NOW workers + services appear
    cluster.set_pod_phase("sage-partitioner", "Succeeded")
    assert ctl.reconcile_until(job, "Partitioned") == "Partitioned"
    ctl.reconcile(job)   # edge that creates the gated workers
    assert {"sage-worker-0", "sage-worker-1"} <= set(cluster.pod_names())
    assert {"sage-worker-0", "sage-worker-1"} <= set(cluster.services)

    # workers get IPs and run -> hostfile filled; launcher runs -> Training
    cluster.set_pod_phase("sage-worker-0", "Running")
    cluster.set_pod_phase("sage-worker-1", "Running")
    cluster.set_pod_phase("sage-launcher", "Running")
    assert ctl.reconcile_until(job, "Training") == "Training"
    hostfile = cluster.config_maps["sage-config"]["data"]["hostfile"]
    lines = hostfile.strip().splitlines()
    assert len(lines) == 2
    ip, port, podname, slots = lines[0].split()
    assert port == "30050" and podname == "sage-worker-0"
    assert slots == "slots=1" and ip.startswith("10.1.0.")
    rs = job.status["replicaStatuses"]
    assert rs["Worker"]["running"] == 2 and rs["Worker"]["ready"] == "2/2"
    assert rs["Launcher"]["ready"] == "1/1"

    # launcher succeeds -> Completed; cleanPodPolicy deletes workers
    cluster.set_pod_phase("sage-launcher", "Succeeded")
    assert ctl.reconcile_until(job, "Completed") == "Completed"
    assert job.status["completionTime"]
    ctl.reconcile(job)   # terminated-job cleanup pass
    assert "sage-worker-0" not in cluster.pods
    assert "sage-worker-1" not in cluster.pods
    assert not cluster.services


def test_clean_pod_policy_none_keeps_workers(tmp_path):
    cluster, ctl, job = _make(tmp_path, clean_pod_policy="None")
    ctl.reconcile(job)
    cluster.set_pod_phase("sage-partitioner", "Succeeded")
    ctl.reconcile_until(job, "Partitioned")
    ctl.reconcile(job)
    cluster.set_pod_phase("sage-worker-0", "Running")
    cluster.set_pod_phase("sage-worker-1", "Running")
    cluster.set_pod_phase("sage-launcher", "Running")
    ctl.reconcile_until(job, "Training")
    cluster.set_pod_phase("sage-launcher", "Succeeded")
    ctl.reconcile_until(job, "Completed")
    ctl.reconcile(job)
    assert {"sage-worker-0", "sage-worker-1"} <= set(cluster.pod_names())


def test_failed_pod_fails_job_and_requeues_launcher(tmp_path):
    cluster, ctl, job = _make(tmp_path)
    ctl.reconcile(job)
    cluster.set_pod_phase("sage-launcher", "Failed")
    assert ctl.reconcile_until(job, "Failed") == "Failed"
    # first terminated pass: no completionTime yet -> requeue + delete
    # the failed launcher for retry (:146-172)
    job.status.pop("completionTime", None)
    result = ctl.reconcile(job)
    assert result["requeue"]
    assert "sage-launcher" not in cluster.pods


def test_skip_mode_launcher_only(tmp_path):
    """partitionMode: Skip — no partitioner, no stall in Pending (the
    reference leaves Skip jobs Pending forever, genJobPhase:1472-1482;
    deliberate fix here)."""
    cluster = FakeCluster()
    ctl = Controller(cluster)
    job = TPUGraphJob(
        name="solo", partition_mode="Skip",
        replica_specs={"Launcher": replica_spec(
            1, command=["tpurun", "--train-entry-point", "t.py"])})
    ctl.reconcile(job)
    assert cluster.pod_names() == ["solo-launcher"]
    launcher = cluster.pods["solo-launcher"]
    assert "initContainers" not in launcher["spec"]   # no barriers
    cluster.set_pod_phase("solo-launcher", "Running")
    assert ctl.reconcile_until(job, "Training") == "Training"
    cluster.set_pod_phase("solo-launcher", "Succeeded")
    assert ctl.reconcile_until(job, "Completed") == "Completed"


def test_worker_pod_tpu_shape(tmp_path):
    cluster, ctl, job = _make(tmp_path, slots_per_worker=4)
    ctl.reconcile(job)
    cluster.set_pod_phase("sage-partitioner", "Succeeded")
    ctl.reconcile_until(job, "Partitioned")
    ctl.reconcile(job)
    w = cluster.pods["sage-worker-1"]
    c = w["spec"]["containers"][0]
    env = dict((e["name"], e["value"]) for e in c["env"])
    assert env["TPU_OPERATOR_RANK"] == "1"
    assert env["TPU_OPERATOR_COORDINATOR"] == "sage-worker-0:8476"
    assert c["resources"]["limits"]["google.com/tpu"] == 4
    ports = {p["name"]: p["containerPort"] for p in c["ports"]}
    assert ports == {"fabric": 30050, "coordinator": 8476}
    # slots land in the hostfile too
    cluster.set_pod_phase("sage-worker-0", "Running")
    cluster.set_pod_phase("sage-worker-1", "Running")
    ctl.reconcile(job)
    hostfile = cluster.config_maps["sage-config"]["data"]["hostfile"]
    assert "slots=4" in hostfile


def test_worker_tpu_slice_scheduling(tmp_path):
    """spec.tpu wires worker pods for a real multi-host GKE TPU slice
    (reference worker wiring contract:
    dgljob_controller.go:897-1063, live hostfile :1416-1437): node
    selectors for accelerator + topology, per-worker TPU_WORKER_ID and
    the full TPU_WORKER_HOSTNAMES gang list."""
    cluster, ctl, job = _make(tmp_path, num_workers=4,
                              slots_per_worker=8,
                              tpu_accelerator="tpu-v5-lite-podslice")
    ctl.reconcile(job)
    cluster.set_pod_phase("sage-partitioner", "Succeeded")
    ctl.reconcile_until(job, "Partitioned")
    ctl.reconcile(job)
    for i in range(4):
        w = cluster.pods[f"sage-worker-{i}"]
        # topology derived: 4 workers x 8 chips = 32 -> 4x8
        assert w["spec"]["nodeSelector"] == {
            "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice",
            "cloud.google.com/gke-tpu-topology": "4x8"}
        env = dict((e["name"], e["value"])
                   for e in w["spec"]["containers"][0]["env"])
        assert env["TPU_WORKER_ID"] == str(i)
        assert env["TPU_WORKER_HOSTNAMES"] == (
            "sage-worker-0,sage-worker-1,sage-worker-2,sage-worker-3")
        assert env["TPU_OPERATOR_COORDINATOR"] == "sage-worker-0:8476"
        limits = w["spec"]["containers"][0]["resources"]["limits"]
        assert limits["google.com/tpu"] == 8


def test_worker_tpu_topology_explicit_and_irregular(tmp_path):
    # explicit topology wins over derivation
    cluster, ctl, job = _make(tmp_path, num_workers=2,
                              slots_per_worker=4,
                              tpu_accelerator="tpu-v5p-slice",
                              tpu_topology="2x2x1")
    ctl.reconcile(job)
    cluster.set_pod_phase("sage-partitioner", "Succeeded")
    ctl.reconcile_until(job, "Partitioned")
    ctl.reconcile(job)
    sel = cluster.pods["sage-worker-0"]["spec"]["nodeSelector"]
    assert sel["cloud.google.com/gke-tpu-topology"] == "2x2x1"
    # non-v5e family WITHOUT explicit topology: never guess a 2-D shape
    # (v4/v5p topologies are 3-D; a wrong selector wedges the gang)
    cluster_p = FakeCluster(status_dir=str(tmp_path / "psp"))
    ctl_p = Controller(cluster_p)
    job_p = simple_job("vp", 2, slots_per_worker=4,
                       tpu_accelerator="tpu-v5p-slice")
    ctl_p.reconcile(job_p)
    cluster_p.set_pod_phase("vp-partitioner", "Succeeded")
    ctl_p.reconcile_until(job_p, "Partitioned")
    ctl_p.reconcile(job_p)
    assert cluster_p.pods["vp-worker-0"]["spec"]["nodeSelector"] == {
        "cloud.google.com/gke-tpu-accelerator": "tpu-v5p-slice"}
    # irregular chip count (3 workers x 4 = 12): accelerator selector
    # only, no topology guess
    cluster2 = FakeCluster(status_dir=str(tmp_path / "ps2"))
    ctl2 = Controller(cluster2)
    job2 = simple_job("odd", 3, slots_per_worker=4,
                      tpu_accelerator="tpu-v5-lite-podslice")
    ctl2.reconcile(job2)
    cluster2.set_pod_phase("odd-partitioner", "Succeeded")
    ctl2.reconcile_until(job2, "Partitioned")
    ctl2.reconcile(job2)
    sel2 = cluster2.pods["odd-worker-0"]["spec"]["nodeSelector"]
    assert sel2 == {
        "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice"}
    # without spec.tpu nothing TPU-slice-specific is stamped
    cluster3 = FakeCluster(status_dir=str(tmp_path / "ps3"))
    ctl3 = Controller(cluster3)
    job3 = simple_job("plain", 2)
    ctl3.reconcile(job3)
    cluster3.set_pod_phase("plain-partitioner", "Succeeded")
    ctl3.reconcile_until(job3, "Partitioned")
    ctl3.reconcile(job3)
    w = cluster3.pods["plain-worker-0"]
    assert "nodeSelector" not in w["spec"]
    env = dict((e["name"], e["value"])
               for e in w["spec"]["containers"][0]["env"])
    assert "TPU_WORKER_ID" not in env


# -------------------------------------------------------------- watcher
def _run_watcher(watch_file, status_dir, mode, timeout_ms=5000):
    return subprocess.run(
        [watcher_binary(), "--watch-file", str(watch_file),
         "--status-dir", str(status_dir), "--mode", mode,
         "--timeout-ms", str(timeout_ms), "--poll-ms", "20"],
        capture_output=True, text=True)


def _write_watchfile(path, names):
    path.write_text("".join(f"10.0.0.{i} 30050 {n}\n"
                            for i, n in enumerate(names)))


def test_watcher_ready_mode(tmp_path):
    wf = tmp_path / "hostfile"
    sd = tmp_path / "status"
    sd.mkdir()
    _write_watchfile(wf, ["j-worker-0", "j-worker-1", "j-launcher"])
    (sd / "j-worker-0").write_text("Running\n")
    (sd / "j-worker-1").write_text("Pending\n")
    # not all ready -> times out
    assert _run_watcher(wf, sd, "ready", timeout_ms=200).returncode == 1
    (sd / "j-worker-1").write_text("Running\n")
    res = _run_watcher(wf, sd, "ready")
    assert res.returncode == 0, res.stderr
    # launcher line was ignored: no status file for it was ever needed


def test_watcher_finished_mode_and_failure(tmp_path):
    wf = tmp_path / "partfile"
    sd = tmp_path / "status"
    sd.mkdir()
    _write_watchfile(wf, ["j-partitioner"])
    (sd / "j-partitioner").write_text("Running\n")
    assert _run_watcher(wf, sd, "finished", timeout_ms=200).returncode == 1
    (sd / "j-partitioner").write_text("Succeeded\n")
    assert _run_watcher(wf, sd, "finished").returncode == 0
    (sd / "j-partitioner").write_text("Failed\n")
    res = _run_watcher(wf, sd, "finished")
    assert res.returncode == 1 and "Failed" in res.stderr


def test_watcher_unblocks_live(tmp_path):
    """Barrier opens while the watcher is polling (the real initContainer
    flow: operator flips pod status mid-wait)."""
    wf = tmp_path / "hostfile"
    sd = tmp_path / "status"
    sd.mkdir()
    _write_watchfile(wf, ["j-worker-0"])
    (sd / "j-worker-0").write_text("Pending\n")
    proc = subprocess.Popen(
        [watcher_binary(), "--watch-file", str(wf), "--status-dir",
         str(sd), "--mode", "ready", "--timeout-ms", "5000",
         "--poll-ms", "20"])
    time.sleep(0.15)
    assert proc.poll() is None   # still waiting
    (sd / "j-worker-0").write_text("Running\n")
    assert proc.wait(timeout=5) == 0


def test_watcher_batch_backend_one_subprocess_per_tick(tmp_path):
    """--status-batch-cmd (the production backend):
    one LIST subprocess per 500 ms tick regardless of pod count —
    with every pod already Running, the barrier opens after exactly
    ONE invocation for three watched pods (per-pod fan-out would show
    three)."""
    wf = tmp_path / "hostfile"
    _write_watchfile(wf, ["j-worker-0", "j-worker-1", "j-worker-2",
                          "j-launcher"])
    count = tmp_path / "calls"
    status = tmp_path / "status.txt"
    status.write_text("j-worker-0 Running\nj-worker-1 Running\n"
                      "j-worker-2 Running\n")
    batch = f"echo x >> {count} && cat {status}"
    res = subprocess.run(
        [watcher_binary(), "--watch-file", str(wf),
         "--status-batch-cmd", batch, "--mode", "ready",
         "--timeout-ms", "5000", "--poll-ms", "20"],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    assert count.read_text().count("x") == 1

    # a pod missing from the list keeps the barrier shut (empty phase
    # is never "ready"), and Failed still aborts loudly
    status.write_text("j-worker-0 Running\nj-worker-1 Running\n")
    count.write_text("")
    res = subprocess.run(
        [watcher_binary(), "--watch-file", str(wf),
         "--status-batch-cmd", batch, "--mode", "ready",
         "--timeout-ms", "100", "--poll-ms", "20"],
        capture_output=True, text=True)
    assert res.returncode == 1
    # still one list per tick while blocked: invocations ~= ticks (6
    # at 100 ms / 20 ms, with scheduling slack), nowhere near 3x ticks
    n_calls = count.read_text().count("x")
    assert 2 <= n_calls <= 8, n_calls
    status.write_text("j-worker-0 Running\nj-worker-1 Running\n"
                      "j-worker-2 Failed\n")
    res = subprocess.run(
        [watcher_binary(), "--watch-file", str(wf),
         "--status-batch-cmd", batch, "--mode", "ready",
         "--timeout-ms", "5000", "--poll-ms", "20"],
        capture_output=True, text=True)
    assert res.returncode == 1 and "Failed" in res.stderr


def test_watcher_initcontainer_sets_watch_selector(tmp_path):
    """The reconciler scopes the image's one-LIST backend to the job's
    pods via WATCH_SELECTOR=app=<job> on both watcher initContainers."""
    cluster, ctl, job = _make(tmp_path)
    ctl.reconcile(job)
    pod = cluster.pods["sage-launcher"]
    watchers = [c for c in pod["spec"]["initContainers"]
                if c["name"].startswith("watcher")]
    assert len(watchers) == 2
    for init in watchers:
        env = {e["name"]: e["value"] for e in init["env"]}
        assert env["WATCH_SELECTOR"] == "app=sage"


# ---------------------------------------------- end-to-end with watcher
def test_reconcile_drives_real_watcher_barrier(tmp_path):
    """The launcher's init barrier opens exactly when the cluster state
    says it should — reconciler + compiled watcher together."""
    cluster, ctl, job = _make(tmp_path)
    ctl.reconcile(job)
    cluster.set_pod_phase("sage-partitioner", "Running")
    ctl.reconcile(job)

    # render partfile the way the pod would see it
    partfile = tmp_path / "partfile"
    partfile.write_text(
        cluster.config_maps["sage-config"]["data"]["partfile"])
    proc = subprocess.Popen(
        [watcher_binary(), "--watch-file", str(partfile), "--status-dir",
         cluster.status_dir, "--mode", "finished", "--timeout-ms",
         "5000", "--poll-ms", "20"])
    time.sleep(0.1)
    assert proc.poll() is None            # partitioner still running
    cluster.set_pod_phase("sage-partitioner", "Succeeded")
    assert proc.wait(timeout=5) == 0      # barrier opens
    assert ctl.reconcile_until(job, "Partitioned") == "Partitioned"


# --------------------------------------------------------- gang sched
def test_gang_scheduling_podgroup_before_workers(tmp_path):
    """With spec.gangScheduler set, the PodGroup is
    created BEFORE any worker pod (a half-scheduled TPU worker gang
    wedges jax.distributed rendezvous forever), minMember equals the
    worker count, and every worker carries the scheduler + group
    markers. Reference ships only the RBAC for this
    (dgl-operator.yaml:3148-3154)."""
    cluster, ctl, job = _make(tmp_path, num_workers=3,
                              gang_scheduler="volcano")
    ctl.reconcile(job)
    cluster.set_pod_phase("sage-partitioner", "Succeeded")
    ctl.reconcile_until(job, "Partitioned")
    ctl.reconcile(job)   # the scale-out edge

    # PodGroup exists with the all-or-nothing gate
    assert "sage-gang" in cluster.pod_groups
    pg = cluster.pod_groups["sage-gang"]
    assert pg["apiVersion"] == "scheduling.volcano.sh/v1beta1"
    assert pg["spec"]["minMember"] == 3

    # creation ORDER: PodGroup event precedes every worker-pod create
    events = cluster.events
    pg_at = events.index("create:PodGroup/sage-gang")
    worker_creates = [i for i, e in enumerate(events)
                      if e.startswith("create:Pod/sage-worker-")]
    assert worker_creates and all(pg_at < i for i in worker_creates)

    # workers are stamped into the gang
    for i in range(3):
        w = cluster.pods[f"sage-worker-{i}"]
        assert w["spec"]["schedulerName"] == "volcano"
        assert w["metadata"]["annotations"][
            "scheduling.k8s.io/group-name"] == "sage-gang"
        assert w["metadata"]["labels"][
            "scheduling.x-k8s.io/pod-group"] == "sage-gang"
    # launcher/partitioner are NOT gang members (they must be able to
    # run before the gang is placeable)
    assert "schedulerName" not in cluster.pods["sage-launcher"]["spec"]

    # idempotent: another reconcile does not redundantly recreate it
    n_pg = sum(1 for e in cluster.events
               if e == "create:PodGroup/sage-gang")
    ctl.reconcile(job)
    assert sum(1 for e in cluster.events
               if e == "create:PodGroup/sage-gang") == n_pg


def test_gang_scheduling_coscheduling_flavor_and_off_default(tmp_path):
    cluster, ctl, job = _make(tmp_path, num_workers=2,
                              gang_scheduler="coscheduling")
    ctl.reconcile(job)
    cluster.set_pod_phase("sage-partitioner", "Succeeded")
    ctl.reconcile_until(job, "Partitioned")
    ctl.reconcile(job)
    pg = cluster.pod_groups["sage-gang"]
    assert pg["apiVersion"] == "scheduling.x-k8s.io/v1alpha1"
    assert cluster.pods["sage-worker-0"]["spec"][
        "schedulerName"] == "scheduler-plugins-scheduler"

    # spec.schedulerName overrides the flavor default
    cluster3, ctl3, job3 = _make(tmp_path / "ovr", num_workers=1,
                                 gang_scheduler="coscheduling",
                                 scheduler_name="my-batch-scheduler")
    ctl3.reconcile(job3)
    cluster3.set_pod_phase("sage-partitioner", "Succeeded")
    ctl3.reconcile_until(job3, "Partitioned")
    ctl3.reconcile(job3)
    assert cluster3.pods["sage-worker-0"]["spec"][
        "schedulerName"] == "my-batch-scheduler"

    # default job: no PodGroup, no schedulerName (existing behavior)
    cluster2, ctl2, job2 = _make(tmp_path / "off", num_workers=2)
    ctl2.reconcile(job2)
    cluster2.set_pod_phase("sage-partitioner", "Succeeded")
    ctl2.reconcile_until(job2, "Partitioned")
    ctl2.reconcile(job2)
    assert not cluster2.pod_groups
    assert "schedulerName" not in cluster2.pods["sage-worker-0"]["spec"]


def test_evicted_pod_self_heals(tmp_path):
    """Exceeds reference parity: DGLJob declares the Evicted phase but
    nothing ever sets or handles it (dgljob_types.go:48). Here a
    kubelet eviction (Failed pod with status.reason Evicted) drives the
    job to Evicted, the reconciler deletes the evicted pod, recreates
    it on the next pass, and the job returns to Training once the
    replacement runs — eviction is transient, not terminal."""
    cluster, ctl, job = _make(tmp_path, num_workers=2,
                              clean_pod_policy="None")
    ctl.reconcile(job)
    cluster.set_pod_phase("sage-partitioner", "Succeeded")
    ctl.reconcile_until(job, "Partitioned")
    ctl.reconcile(job)
    cluster.set_pod_phase("sage-worker-0", "Running")
    cluster.set_pod_phase("sage-worker-1", "Running")
    cluster.set_pod_phase("sage-launcher", "Running")
    ctl.reconcile_until(job, "Training")

    # node pressure evicts a worker
    cluster.set_pod_phase("sage-worker-1", "Failed", reason="Evicted")
    assert ctl.reconcile_until(job, "Evicted") == "Evicted"
    rs = job.status["replicaStatuses"]["Worker"]
    assert rs["evicted"] == 1 and rs["failed"] == 1
    # the eviction-healing path (not cleanPodPolicy — it is None here)
    # deleted exactly the evicted pod
    assert cluster.events.count("delete:Pod/sage-worker-1") == 1
    assert "sage-worker-0" in cluster.pods

    # next pass recreates the worker; when it runs, Training resumes
    ctl.reconcile(job)
    assert "sage-worker-1" in cluster.pods
    assert cluster.pods["sage-worker-1"]["status"]["phase"] == "Pending"
    cluster.set_pod_phase("sage-worker-1", "Running")
    assert ctl.reconcile_until(job, "Training") == "Training"


class ScriptedController(Controller):
    """Controller with a scripted reconcile stream (no cluster, no
    binary) — isolates reconcile_until's loop policy."""

    def __init__(self, script):
        self.script = list(script)
        self.i = 0

    def reconcile(self, job):
        r = self.script[min(self.i, len(self.script) - 1)]
        self.i += 1
        if "phase" in r:
            job.status["phase"] = r["phase"]
        return {"actions": r.get("actions", []),
                "requeue": r.get("requeue", False)}


# ---------------------------------------- reconcile_until loop policy
def test_reconcile_until_converged_returns_phase():
    ctl = ScriptedController([
        {"phase": "Training", "actions": ["a"], "requeue": True},
        {"phase": "Training"},          # fixed point
    ])
    job = simple_job("s", 1)
    assert ctl.reconcile_until(job) == "Training"


def test_reconcile_until_exhausted_raises():
    """max_iters running out is an error, not a best-effort return —
    a live-locked loop used to hand back whatever phase it reached."""
    ctl = ScriptedController([
        {"phase": "Pending", "actions": ["churn"], "requeue": True}])
    job = simple_job("s", 1)
    with pytest.raises(ReconcileExhausted) as ei:
        ctl.reconcile_until(job, "Training", max_iters=4)
    assert ei.value.phase == "Pending"
    assert "Training" in str(ei.value)
    assert ctl.i == 4


def test_reconcile_until_converged_at_wrong_phase_returns_it():
    """Convergence at a phase other than the target still RETURNS (the
    caller's equality assert distinguishes) — only non-convergence
    raises."""
    ctl = ScriptedController([{"phase": "Failed"}])
    job = simple_job("s", 1)
    assert ctl.reconcile_until(job, "Completed", max_iters=5) == "Failed"


def test_reconcile_until_capped_backoff_on_requeue():
    sleeps = []
    ctl = ScriptedController([
        {"phase": "Pending", "actions": ["x"], "requeue": True}])
    job = simple_job("s", 1)
    job.status["phase"] = "Pending"    # no phase edge: pure requeue churn
    with pytest.raises(ReconcileExhausted):
        ctl.reconcile_until(job, max_iters=5, backoff_base=0.1,
                            backoff_cap=0.4, sleep=sleeps.append)
    # exponential, capped: 0.1 0.2 0.4 0.4 0.4
    assert sleeps == pytest.approx([0.1, 0.2, 0.4, 0.4, 0.4])
    # a phase edge resets the ladder
    sleeps2 = []
    ctl2 = ScriptedController([
        {"phase": "Pending", "actions": ["x"], "requeue": True},
        {"phase": "Starting", "actions": ["x"], "requeue": True},
        {"phase": "Starting", "actions": ["x"], "requeue": True},
        {"phase": "Starting", "actions": ["x"], "requeue": True},
    ])
    job2 = simple_job("s2", 1)
    job2.status["phase"] = "Pending"
    with pytest.raises(ReconcileExhausted):
        ctl2.reconcile_until(job2, max_iters=4, backoff_base=0.1,
                             backoff_cap=10.0, sleep=sleeps2.append)
    assert sleeps2 == pytest.approx([0.1, 0.2, 0.1, 0.2])


def test_reconcile_until_backoff_limit_declares_failed():
    """The Evicted→restart loop is bounded: past backoff_limit
    Failed-phase requeues the job is terminally Failed with
    reason=BackoffLimitExceeded instead of restarting forever."""
    ctl = ScriptedController([
        {"phase": "Failed", "actions": ["del-launcher"], "requeue": True}])
    job = simple_job("s", 1)
    assert ctl.reconcile_until(job, max_iters=50,
                               backoff_limit=2) == "Failed"
    assert job.status["reason"] == "BackoffLimitExceeded"
    assert ctl.i == 3      # 2 allowed restarts + the limit-tripping pass


def test_reconcile_until_backoff_limit_not_tripped_by_recovery():
    """A job that leaves Failed before the limit keeps its normal
    lifecycle — the limit counts Failed requeues, not total passes."""
    ctl = ScriptedController([
        {"phase": "Failed", "actions": ["x"], "requeue": True},
        {"phase": "Training", "actions": ["y"], "requeue": True},
        {"phase": "Training"},
    ])
    job = simple_job("s", 1)
    assert ctl.reconcile_until(job, max_iters=10,
                               backoff_limit=1) == "Training"
    assert "reason" not in job.status


# ------------------------------------------------- build diagnostics
def test_ensure_built_surfaces_compiler_output(tmp_path, monkeypatch):
    """A failing native build raises BuildError carrying the compiler's
    diagnostics, and builds into the package's ``_build`` directory,
    hash-named: an edited source is a new binary."""
    native = tmp_path / "native" / "controlplane"
    native.mkdir(parents=True)
    for name in ("operator_main.cc", "reconciler.cc", "json.cc",
                 "reconciler.hpp", "json.hpp", "watcher_main.cc"):
        (native / name).write_text(
            open(os.path.join(_build.NATIVE, "controlplane", name)).read())
    (native / "reconciler.cc").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "NATIVE", str(tmp_path / "native"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(BuildError) as ei:
        ensure_built()
    msg = str(ei.value)
    assert "tpu-operator" in msg and "reconciler.cc" in msg
    assert "error" in msg
    assert not [f for f in os.listdir(tmp_path / "_build")
                if f.startswith("tpu-operator")]


def test_ensure_built_names_hashed_binaries():
    """The built binaries live under ``dgl_operator_tpu_torch/_build``,
    each named by a hash of its sources, and a second call reuses them."""
    seconds = ensure_built()
    assert set(seconds) == {"tpu-operator", "tpu-watcher"}
    again = ensure_built()
    assert again == {"tpu-operator": 0.0, "tpu-watcher": 0.0}
    for path in (controller_mod.operator_binary(), watcher_binary()):
        assert os.path.dirname(path) == _build.BUILD_DIR
        assert re.fullmatch(r"tpu-(operator|watcher)-[0-9a-f]{16}",
                            os.path.basename(path))
        assert os.access(path, os.X_OK)


def test_bin_dir_without_binaries_raises(tmp_path, monkeypatch):
    """``TPU_OPERATOR_NATIVE_BIN_DIR`` keeps its JAX meaning: a named
    directory is used as it is, and one without binaries raises rather
    than fall back to the default build."""
    monkeypatch.setenv(BIN_DIR_ENV, str(tmp_path))
    with pytest.raises(BuildError, match=BIN_DIR_ENV):
        ensure_built()
    with pytest.raises(BuildError):
        Controller(FakeCluster())
    assert controller_mod.operator_binary() == str(tmp_path /
                                                   "tpu-operator")


def test_reconciler_binary_rejects_malformed_input():
    """The compiled reconciler fails loudly (non-zero exit, stderr) on
    broken input instead of hanging or emitting garbage actions — the
    kubeshim Manager surfaces that as a job-scoped error."""
    from dgl_operator_tpu_torch.controlplane.controller import operator_binary
    for bad in ("{not json", '{"job": [1,2', ""):
        proc = subprocess.run(
            [operator_binary(), "--watcher-image", "x", "reconcile"],
            input=bad, capture_output=True, text=True, timeout=30)
        assert proc.returncode != 0, repr(bad)
        assert proc.stderr.strip(), f"no diagnostic for {bad!r}"
    # a null job (deleted between list and reconcile) is a clean no-op
    proc = subprocess.run(
        [operator_binary(), "--watcher-image", "x", "reconcile"],
        input='{"job": null}', capture_output=True, text=True,
        timeout=30)
    assert proc.returncode == 0
    out = json.loads(proc.stdout)
    assert out.get("actions", []) == []


# ------------------------------------------------- parity with the JAX
TIME_KEYS = ("startTime", "completionTime")


def _stamped(status: dict) -> dict:
    """The status with its wall-clock stamps (each binary reads the
    clock itself) checked for shape and replaced by a marker."""
    out = copy.deepcopy(status)
    for k in TIME_KEYS:
        if out.get(k) is not None:
            assert re.fullmatch(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ", out[k])
            out[k] = "<time>"
    return out


def _result_stamped(result):
    """A reconcile result (``{actions, status, requeue}``) with its
    status stamped; any other result as it is."""
    if isinstance(result, dict) and isinstance(result.get("status"), dict):
        return {**result, "status": _stamped(result["status"])}
    return result


class Pair:
    """One job on each package's controller and fake cluster, driven in
    lockstep; :meth:`same` holds the clusters' objects, their action
    audit trails and the job statuses equal."""

    def __init__(self, tmp_path, jax_bins, name="pj", num_workers=2, **kw):
        self.jax_bins = jax_bins
        cmd = ["tpurun", "--train-entry-point", "train.py"]
        self.port = FakeCluster(status_dir=str(tmp_path / "port_status"))
        self.pctl = Controller(self.port)
        self.pjob = simple_job(name, num_workers, launcher_command=cmd,
                               **kw)
        self.jax = JFakeCluster(status_dir=str(tmp_path / "jax_status"))
        with jax_bin_dir(jax_bins):
            self.jctl = JController(self.jax)
        self.jjob = j_simple_job(name, num_workers, launcher_command=cmd,
                                 **kw)
        assert self.pjob.to_dict() == self.jjob.to_dict()

    def both(self, fn):
        """``fn(cluster, controller, job)`` on each side (the JAX side
        with its binaries); returns both results, the status of a raw
        reconcile result stamped as :meth:`same` stamps the jobs'. The
        two sides read the clock apart, so a second can turn between
        them (most often under load)."""
        got = fn(self.port, self.pctl, self.pjob)
        with jax_bin_dir(self.jax_bins):
            want = fn(self.jax, self.jctl, self.jjob)
        return _result_stamped(got), _result_stamped(want)

    def same(self, what: str) -> None:
        for bucket in ("pods", "config_maps", "services",
                       "service_accounts", "roles", "role_bindings",
                       "pod_groups", "events"):
            assert getattr(self.port, bucket) == getattr(self.jax, bucket), \
                f"{what}: {bucket}"
        assert _stamped(self.pjob.status) == _stamped(self.jjob.status), what
        assert sorted(os.listdir(self.port.status_dir)) == \
            sorted(os.listdir(self.jax.status_dir)), what


@pytest.fixture(scope="module")
def jax_bins(tmp_path_factory):
    return jax_controlplane_bins(tmp_path_factory)


def test_reconcile_until_matches_jax_through_the_phases(tmp_path, jax_bins):
    """The full phase sequence, then a failed launcher and its requeue:
    the same objects and status after every step."""
    p = Pair(tmp_path, jax_bins)
    steps = [
        ("first pass", lambda c, k, j: k.reconcile(j)),
        ("partitioner running", lambda c, k, j: c.set_pod_phase(
            "pj-partitioner", "Running")),
        ("Partitioning", lambda c, k, j: k.reconcile_until(
            j, "Partitioning")),
        ("partitioner done", lambda c, k, j: c.set_pod_phase(
            "pj-partitioner", "Succeeded")),
        ("Partitioned", lambda c, k, j: k.reconcile_until(j, "Partitioned")),
        ("scale out", lambda c, k, j: k.reconcile(j)),
        ("workers run", lambda c, k, j: [c.set_pod_phase(n, "Running") for n
                                         in ("pj-worker-0", "pj-worker-1",
                                             "pj-launcher")]),
        ("Training", lambda c, k, j: k.reconcile_until(j, "Training")),
        ("evicted worker", lambda c, k, j: c.set_pod_phase(
            "pj-worker-1", "Failed", reason="Evicted")),
        ("Evicted", lambda c, k, j: k.reconcile_until(j, "Evicted")),
        ("replacement", lambda c, k, j: k.reconcile(j)),
        ("replacement runs", lambda c, k, j: c.set_pod_phase(
            "pj-worker-1", "Running")),
        ("Training again", lambda c, k, j: k.reconcile_until(j, "Training")),
        ("launcher fails", lambda c, k, j: c.set_pod_phase(
            "pj-launcher", "Failed")),
        ("Failed", lambda c, k, j: k.reconcile_until(j, "Failed")),
        ("requeue", lambda c, k, j: (j.status.pop("completionTime", None),
                                     k.reconcile(j))[1]),
    ]
    for what, fn in steps:
        got, want = p.both(fn)
        assert got == want, what
        p.same(what)
    assert p.pjob.status["phase"] == "Failed"
    assert "pj-launcher" not in p.port.pods


def test_completion_and_cleanup_match_jax(tmp_path, jax_bins):
    p = Pair(tmp_path, jax_bins, name="cj", num_workers=1,
             gang_scheduler="volcano", slots_per_worker=4,
             tpu_accelerator="tpu-v5-lite-podslice")
    for what, fn in [
            ("first pass", lambda c, k, j: k.reconcile(j)),
            ("partitioned", lambda c, k, j: c.set_pod_phase(
                "cj-partitioner", "Succeeded")),
            ("Partitioned", lambda c, k, j: k.reconcile_until(
                j, "Partitioned")),
            ("gang", lambda c, k, j: k.reconcile(j)),
            ("run", lambda c, k, j: [c.set_pod_phase(n, "Running") for n in
                                     ("cj-worker-0", "cj-launcher")]),
            ("Training", lambda c, k, j: k.reconcile_until(j, "Training")),
            ("done", lambda c, k, j: c.set_pod_phase("cj-launcher",
                                                     "Succeeded")),
            ("Completed", lambda c, k, j: k.reconcile_until(j, "Completed")),
            ("cleanup", lambda c, k, j: k.reconcile(j))]:
        got, want = p.both(fn)
        assert got == want, what
        p.same(what)
    assert "cj-worker-0" not in p.port.pods and p.port.pod_groups


def _to_training(p: "Pair", name: str, workers: int) -> None:
    """Both sides from the first pass to Training, compared at each
    step."""
    names = [f"{name}-worker-{i}" for i in range(workers)] + \
        [f"{name}-launcher"]
    for what, fn in [
            ("first pass", lambda c, k, j: k.reconcile(j)),
            ("partitioned", lambda c, k, j: c.set_pod_phase(
                f"{name}-partitioner", "Succeeded")),
            ("Partitioned", lambda c, k, j: k.reconcile_until(
                j, "Partitioned")),
            ("scale out", lambda c, k, j: k.reconcile(j)),
            ("run", lambda c, k, j: [c.set_pod_phase(n, "Running")
                                     for n in names]),
            ("Training", lambda c, k, j: k.reconcile_until(j, "Training"))]:
        got, want = p.both(fn)
        assert got == want, what
        p.same(what)


@pytest.mark.parametrize("limit", [0, 1])
def test_backoff_exhaustion_matches_jax(tmp_path, jax_bins, limit):
    """A health feed that names a dead worker on every pass: each
    restart counts toward ``backoff_limit``; with no restart allowed the
    job stops Failed with BackoffLimitExceeded naming the worker, and
    both packages end on the same pass with the same clusters."""
    p = Pair(tmp_path, jax_bins, name="bj", num_workers=1)
    _to_training(p, "bj", 1)
    snap = {"dead": ["m:2:trainer-0"], "dead_hosts": ["bj-worker-0"]}
    got, want = p.both(lambda c, k, j: k.reconcile_until(
        j, max_iters=10, backoff_limit=limit, health=lambda: snap))
    assert got == want == "Failed"
    p.same(f"backoff limit {limit}")
    if limit == 0:
        assert p.pjob.status["reason"] == "BackoffLimitExceeded"
        assert "m:2:trainer-0" in p.pjob.status["message"]
    assert p.port.pods["bj-launcher"]["status"]["reason"] == "HostDead"


@pytest.mark.parametrize("snap,reason", [
    ({"dead": ["m:2:trainer-1"], "dead_hosts": ["pj-worker-1"]},
     "HostDead"),
    ({"stalled": ["m:3:trainer-0"]}, "Stalled")])
def test_health_restart_matches_jax(tmp_path, jax_bins, snap, reason):
    """A Training job whose health feed names a dead (or stalled)
    worker: each controller marks its launcher Failed with the reason,
    the reconciler replaces it, and the clusters stay equal."""
    p = Pair(tmp_path, jax_bins)
    _to_training(p, "pj", 2)

    def unhealthy(c, k, j):
        """Three passes whose first health snapshot is ``snap``; returns
        the phase reached and every pod phase the controller set."""
        feeds = iter([snap])
        marked = []
        orig = c.set_pod_phase

        def spy(name, phase, **kw):
            marked.append((name, phase, kw.get("reason")))
            return orig(name, phase, **kw)

        c.set_pod_phase = spy
        try:
            phase = k.reconcile_until(j, max_iters=3,
                                      health=lambda: next(feeds, {}))
        except ReconcileExhausted as exc:
            phase = exc.phase
        finally:
            del c.set_pod_phase
        return phase, marked

    got, want = p.both(unhealthy)
    assert got == want
    assert got[1] == [("pj-launcher", "Failed", reason)]
    p.same("health restart")
