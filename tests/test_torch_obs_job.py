"""The job plane end to end on the CPU: the port's drivers leave the JAX
package's job view, and both packages read it alike.

``tpurun`` phases 3-5 over ``LocalFabric`` start the port's
``examples/train_dist.py`` by path (two hosts, a 2-part book, the device
sampler in the owner layout, narrow widths) under ``obs_run``; then
``collect_obs`` merges ``obs/job/``. The view holds one ``heartbeat`` a
call and the ``train_done`` of the trainer, its epoch span, the phase
histograms, the utilization gauges from the counted cost and the comm
ledger's ops; the port's doctor and the JAX doctor give one report and
exit 0, the critical-path split sums to 1 and the profiler summary has
the pinned keys. ``tpukerun`` likewise leaves its phases and the KGE
child's records. The live plane's endpoints, written by either
package, are found, fetched and judged alike by both, and ``top``'s
rows agree.
"""

import contextlib
import io
import json
import os

import pytest

from dgl_operator_tpu.obs import analyze as j_analyze
from dgl_operator_tpu.obs import doctor as j_doctor
from dgl_operator_tpu.obs import live as j_live
from dgl_operator_tpu.obs import prof as j_prof
from dgl_operator_tpu.obs import top as j_top
from dgl_operator_tpu.obs import xray as j_xray
import dgl_operator_tpu_torch.obs as pobs
from dgl_operator_tpu_torch.examples import partition_kg
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.partition import partition_graph
from dgl_operator_tpu_torch.launcher import tpukerun, tpurun
from dgl_operator_tpu_torch.launcher.chaos import CHAOS_ENV
from dgl_operator_tpu_torch.obs import analyze as p_analyze
from dgl_operator_tpu_torch.obs import doctor as p_doctor
from dgl_operator_tpu_torch.obs import live as p_live
from dgl_operator_tpu_torch.obs import prof as p_prof
from dgl_operator_tpu_torch.obs import top as p_top
from dgl_operator_tpu_torch.obs import xray as p_xray
from dgl_operator_tpu_torch.obs.collect import job_dir_of
from dgl_operator_tpu_torch.parallel.bootstrap import (PHASE_ENV, HostEntry,
                                                       write_hostfile)

PORT_EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "dgl_operator_tpu_torch", "examples")
ENVS = (pobs.OBS_DIR_ENV, pobs.OBS_RUN_ENV, pobs.OBS_ROLE_ENV, PHASE_ENV,
        CHAOS_ENV, "TPU_OPERATOR_LIVE_PORT", "TPU_OPERATOR_WORKSPACE",
        "TPU_OPERATOR_TUNED_MANIFEST")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ENVS:
        monkeypatch.delenv(name, raising=False)


def _hostfile(path, n):
    write_hostfile(str(path), [HostEntry("127.0.0.1", 30050 + i,
                                         f"w{i}-worker", 1)
                               for i in range(n)])


def _doctor(mod, obs_dir):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main([obs_dir, "--json"])
    return rc, json.loads(buf.getvalue())


def _events(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


@pytest.fixture(scope="module")
def tpurun_job(tmp_path_factory):
    root = tmp_path_factory.mktemp("job")
    mp = pytest.MonkeyPatch()
    try:
        for name in ENVS:
            mp.delenv(name, raising=False)
        ws = root / "ws"
        g = datasets.synthetic_node_clf(num_nodes=600, num_edges=3000,
                                        feat_dim=8, num_classes=4,
                                        seed=5).graph
        partition_graph(g, "g", 2, str(ws / "dataset"))
        conf = root / "conf"
        conf.mkdir()
        _hostfile(conf / "hostfile", 2)
        tpurun.main(["--graph-name", "g", "--num-partitions", "2",
                     "--train-entry-point",
                     os.path.join(PORT_EXAMPLES, "train_dist.py"),
                     "--workspace", str(ws), "--conf-dir", str(conf),
                     "--num-epochs", "2", "--batch-size", "16",
                     "--fabric", "local",
                     "--train-args", "--device cpu --fan_out 3,3 "
                     "--num_hidden 8 --eval_every 0 --prefetch 0 "
                     "--sampler device --feats_layout owner"])
    finally:
        mp.undo()
    return str(ws / "obs")


def test_tpurun_leaves_the_job_view(tpurun_job):
    jd = job_dir_of(tpurun_job)
    assert {"events.jsonl", "metrics.json", "metrics.prom", "trace.json",
            "manifest.json"} <= set(os.listdir(jd))
    events = _events(os.path.join(jd, "events.jsonl"))
    trainer = [e for e in events if e.get("role") == "trainer-0"]
    beats = [e for e in trainer if e["event"] == "heartbeat"]
    done = [e for e in trainer if e["event"] == "train_done"]
    assert len(done) == 1
    # one heartbeat a call, the calls' steps 1, 2, ...
    assert [e["step"] for e in beats] == list(range(1, done[0]["step"] + 1))
    assert {"tpurun_start", "epoch"} <= {e["event"] for e in events}
    # the driver's line after the collection is in the run's own file
    assert "obs_collected" in {e["event"] for e in _events(
        os.path.join(tpurun_job, "events.jsonl"))}
    with open(os.path.join(jd, "trace.json")) as f:
        trace = json.load(f)["traceEvents"]
    names = {e["name"] for e in trace}
    assert {"epoch 0", "epoch 1", "train",
            "phase 5: launch the training"} <= names
    with open(os.path.join(jd, "metrics.prom")) as f:
        prom = f.read()
    for fam in ("train_phase_seconds_bucket", "train_mfu ",
                "prof_peak_flops ", 'comm_bytes_total{op="grad_pmean"',
                'comm_bytes_total{op="halo_ring"', "train_steps_total "):
        assert fam in prom, fam
    summary = p_prof.prof_summary(tpurun_job)
    assert tuple(summary)[:len(p_prof.PROF_KEYS)] == p_prof.PROF_KEYS
    assert 0 < summary["train_mfu"] <= 1
    assert not [e for e in events if e["event"] == "jit_compile"
                and e.get("steady")]
    # the live sidecar of each trainer registered itself
    assert len(p_live.live_endpoints(tpurun_job)) >= 1


def test_both_doctors_read_the_port_job_alike(tpurun_job):
    j_rc, j_rep = _doctor(j_doctor, tpurun_job)
    p_rc, p_rep = _doctor(p_doctor, tpurun_job)
    assert p_rc == j_rc == 0
    assert p_rep == j_rep
    assert os.path.exists(os.path.join(job_dir_of(tpurun_job),
                                       "report.json"))
    assert j_analyze.analyze_job(tpurun_job) \
        == p_analyze.analyze_job(tpurun_job)
    xr = p_xray.xray_summary(tpurun_job)
    assert xr == j_xray.xray_summary(tpurun_job)
    assert abs(sum(xr[f"critpath_frac_{c}"]
                   for c in p_xray.CATEGORIES) - 1.0) < 1e-6
    assert p_prof.prof_summary(tpurun_job) == j_prof.prof_summary(
        tpurun_job)
    # nobody answers on the dead trainers' ports: the file rows
    assert p_top.gather_rows(tpurun_job, timeout=0.2) \
        == j_top.gather_rows(tpurun_job, timeout=0.2)


def test_tpukerun_leaves_the_kge_job_view(tmp_path, monkeypatch):
    ws = tmp_path / "ws"
    ws.mkdir()
    partition_kg.main(["--graph_name", "toykg", "--workspace", str(ws),
                       "--num_parts", "1", "--dataset_scale", "1e-4"])
    conf = tmp_path / "conf"
    conf.mkdir()
    _hostfile(conf / "hostfile", 1)
    tpukerun.main(["--graph-name", "toykg", "--num-partitions", "1",
                   "--train-entry-point",
                   os.path.join(PORT_EXAMPLES, "train_kge.py"),
                   "--workspace", str(ws), "--conf-dir", str(conf),
                   "--fabric", "local", "--hidden-dim", "8",
                   "--batch-size", "32", "--neg-sample-size", "8",
                   "--max-step", "4", "--log-interval", "2",
                   "--save-path", str(tmp_path / "ckpts"),
                   "--train-args", "--device cpu"])
    obs_dir = str(ws / "obs")
    assert pobs.OBS_DIR_ENV not in os.environ
    jd = job_dir_of(obs_dir)
    events = _events(os.path.join(jd, "events.jsonl"))
    roles = {e["role"] for e in events}
    assert {"tpukerun", "trainer-0"} <= roles
    assert "tpukerun_start" in {e["event"] for e in events}
    # the KGE child's sentry records
    assert any(e["event"] == "model_health" and e["role"] == "trainer-0"
               for e in events)
    with open(os.path.join(jd, "metrics.json")) as f:
        procs = json.load(f)["procs"]
    assert any(p.endswith(":trainer-0") for p in procs)
    assert any(p.endswith(":tpukerun") for p in procs)
    j_rc, j_rep = _doctor(j_doctor, obs_dir)
    p_rc, p_rep = _doctor(p_doctor, obs_dir)
    assert p_rep == j_rep and p_rc == j_rc


# ---------------------------------------------------------------------
# the live plane, across the packages
# ---------------------------------------------------------------------
@pytest.mark.parametrize("server", ["jax", "port"])
def test_live_endpoints_are_read_alike(tmp_path, server):
    live = {"jax": j_live, "port": p_live}
    obs_dir = str(tmp_path / "obs")
    obs_mod = __import__("dgl_operator_tpu.obs" if server == "jax"
                         else "dgl_operator_tpu_torch.obs",
                         fromlist=["obs_run"])
    with obs_mod.obs_run(obs_dir, role="trainer-3", console=False):
        feed = live[server].LiveFeed()
        feed.tick(7)
        srv = live[server].LiveServer(feed=feed, role="trainer-3").start()
        try:
            eps = [live[pkg].live_endpoints(obs_dir) for pkg in live]
            assert eps[0] == eps[1] and len(eps[0]) == 1
            assert eps[0][0]["port"] == srv.port
            snaps = [live[pkg].fetch_livez(eps[0][0]) for pkg in live]
            for s in snaps:
                assert s["step"] == 7 and s["role"] == "trainer-3"
            now = snaps[0]["last_heartbeat_ts"] + 1.0
            health = [live[pkg].live_job_health(obs_dir, now=now)
                      for pkg in live]
            assert health[0] == health[1]
            assert health[0]["source"] == "live" and health[0]["healthy"]
        finally:
            srv.stop()
    assert p_live.live_endpoints(obs_dir) == []


# ---------------------------------------------------------------------
# the flight recorder on the chaos death path
# ---------------------------------------------------------------------
HOST_DIE = """
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig
g = datasets.synthetic_node_clf(num_nodes=400, num_edges=2000, feat_dim=8,
                                num_classes=4, seed=3).graph
cfg = TrainConfig(num_epochs=1, batch_size=32, fanouts=(3, 3),
                  eval_every=0, dropout=0.0)
SampledTrainer(DistSAGE(8, 8, 4, device="cpu"), g, cfg,
               device="cpu").train()
print("survived")
"""


def test_host_die_leaves_the_flight_dump(tmp_path):
    """``host:die`` exits through ``os._exit``: the dump happens before
    it, names the reason and holds the heartbeats up to the death, and
    both packages' loaders and doctors read it alike."""
    import subprocess
    import sys

    repo = os.path.dirname(PORT_EXAMPLES.rstrip(os.sep))
    hf = tmp_path / "hosts"
    hf.write_text("127.0.0.1 30050 w0 slots=1\n127.0.0.1 30051 w1 "
                  "slots=1\n")
    obs_dir = tmp_path / "obs"
    ws = tmp_path / "ws"
    ws.mkdir()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(repo),
               TPU_OPERATOR_RANK="1", TPU_OPERATOR_HOSTFILE_PATH=str(hf),
               TPU_OPERATOR_WORKSPACE=str(ws),
               TPU_OPERATOR_OBS_DIR=str(obs_dir))
    env[CHAOS_ENV] = "host:die:3@host=w1"
    proc = subprocess.run([sys.executable, "-c", HOST_DIE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 113, proc.stderr[-2000:]
    from dgl_operator_tpu.obs.flight import load_flights as j_load
    from dgl_operator_tpu_torch.obs.flight import load_flights
    flights = load_flights(str(obs_dir))
    assert flights == j_load(str(obs_dir)) and len(flights) == 1
    dump = flights[0]
    assert dump["reason"] == "host_died" and dump["pid"] != os.getpid()
    beats = [s["step"] for s in dump["samples"] if s["kind"] == "heartbeat"]
    assert beats == [1, 2, 3]
    died = [e for e in _events(str(obs_dir / "events.jsonl"))
            if e["event"] == "host_died"]
    assert len(died) == 1 and died[0]["step"] == 3
    j_rc, j_rep = _doctor(j_doctor, str(obs_dir))
    p_rc, p_rep = _doctor(p_doctor, str(obs_dir))
    assert p_rep == j_rep and p_rc == j_rc
    assert p_rep["flight"][0]["reason"] == "host_died"
