"""The port's elastic control plane (``launcher/elastic.py``) and the
controller's health restarts against the JAX package's: shrink and
regrow planning, the persisted plan, the shrunk hostfile and the fenced
epoch (byte-equal files from both packages for the same book, job view
and dead set), equal ledger signatures from both ``tpurun`` drivers
under ``--placement auto`` and ``--elastic``, the job-health dead status
and the analytics' elasticity block, the controller's bounded dead-host
restarts, and ``tpurun --elastic`` end to end on the CPU: a host dies
mid-train, the driver re-places its partition on the survivor, and the
port trainers finish bit-identical to an undisturbed run.
"""

import argparse
import hashlib
import json
import os
import textwrap

import numpy as np
import pytest
import torch

from dgl_operator_tpu.controlplane.controller import Controller as JController
from dgl_operator_tpu.launcher import chaos as jchaos
from dgl_operator_tpu.launcher import elastic as jelastic
from dgl_operator_tpu.launcher import tpurun as jax_tpurun
from dgl_operator_tpu.launcher.chaos import ChaosFabric as JChaosFabric
from dgl_operator_tpu.launcher.chaos import ChaosPlan as JChaosPlan
from dgl_operator_tpu.launcher.fabric import LocalFabric as JLocalFabric
from dgl_operator_tpu.obs import analyze as janalyze
from dgl_operator_tpu_torch.autotune import placement as PL
from dgl_operator_tpu_torch.controlplane import simple_job
from dgl_operator_tpu_torch.controlplane.controller import Controller
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.partition import partition_graph
from dgl_operator_tpu_torch.launcher import chaos, elastic, tpurun
from dgl_operator_tpu_torch.launcher.chaos import ChaosFabric, ChaosPlan
from dgl_operator_tpu_torch.launcher.fabric import (BatchFabricError,
                                                    FabricHostLost,
                                                    LocalFabric)
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.obs import get_obs, obs_run
from dgl_operator_tpu_torch.obs.analyze import analyze_job, job_health
from dgl_operator_tpu_torch.parallel.bootstrap import (FENCE_EPOCH_ENV,
                                                       HOSTFILE_ENV,
                                                       PHASE_ENV, RANK_ENV,
                                                       HostEntry,
                                                       parse_hostfile,
                                                       write_hostfile)
from dgl_operator_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                       FencedOut)
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig

pytestmark = pytest.mark.elastic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = (chaos.CHAOS_ENV, chaos.WORKSPACE_ENV, FENCE_EPOCH_ENV, HOSTFILE_ENV,
        RANK_ENV, PHASE_ENV, "TPU_OPERATOR_OBS_DIR", "TPU_OPERATOR_OBS_RUN",
        "TPU_OPERATOR_OBS_ROLE", "TPU_OPERATOR_TUNED_MANIFEST",
        "TPU_OPERATOR_LIVE_PORT")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Every test starts (and ends) without chaos/elastic environment:
    the code under test writes some of it itself (export_epoch), which
    monkeypatch alone would not undo."""
    for k in KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(chaos, "_PROC_PLAN", None)
    monkeypatch.setattr(jchaos, "_PROC_PLAN", None)
    yield
    for k in KEYS:
        os.environ.pop(k, None)


@pytest.fixture(scope="module")
def part_cfg4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parts")
    g = datasets.karate_club().graph
    return partition_graph(g, "karate", 4, str(tmp))


def _entries(n, prefix="w"):
    return [HostEntry(f"10.0.0.{i}", 30050 + i, f"{prefix}{i}-worker", 1)
            for i in range(n)]


def _hb_events(path, host_intervals, n=8):
    t0 = 1000.0
    with open(path, "w") as f:
        for host, dt in host_intervals.items():
            for i in range(n):
                f.write(json.dumps({
                    "event": "heartbeat", "ts": t0 + i * dt,
                    "host": host, "pid": 7, "role": "trainer-0",
                    "step": i}) + "\n")


def _read(path):
    with open(path) as f:
        return f.read()


# ------------------------------------------------------- shrink / regrow
def test_plan_shrink_survivors_take_multiple_parts(part_cfg4):
    entries = _entries(4)
    plan = elastic.plan_shrink(part_cfg4, entries, ["w3-worker"])
    assert plan["width"] == 3 and plan["full_width"] == 4
    hosts = [plan["assignment"][str(p)] for p in range(4)]
    assert "w3-worker" not in hosts
    assert set(hosts) <= {"w0-worker", "w1-worker", "w2-worker"}
    assert max(hosts.count(h) for h in set(hosts)) == 2
    assert plan == jelastic.plan_shrink(part_cfg4, entries, ["w3-worker"])
    with pytest.raises(ValueError, match="every host is dead"):
        elastic.plan_shrink(part_cfg4, entries,
                            [e.name for e in entries])


def test_apply_elastic_entries_repeats_and_idempotence():
    entries = _entries(3)
    assignment = {"0": "w0-worker", "1": "w2-worker", "2": "w0-worker"}
    ordered = PL.apply_elastic_entries(entries, assignment)
    assert [e.name for e in ordered] == ["w0-worker", "w2-worker",
                                         "w0-worker"]
    again = PL.apply_elastic_entries(ordered, assignment)
    assert [e.name for e in again] == [e.name for e in ordered]
    with pytest.raises(ValueError, match="not in hostfile"):
        PL.apply_elastic_entries(entries, {"0": "nope", "1": "x",
                                           "2": "y"})


def test_apply_shrink_persists_plan_hostfile_and_epoch(part_cfg4,
                                                       tmp_path):
    ws = str(tmp_path)
    entries = _entries(4)
    plan = elastic.plan_shrink(part_cfg4, entries, ["w1-worker"])
    c0 = get_obs().metrics.counter("elastic_shrinks_total").value()
    hf = elastic.apply_shrink(ws, entries, plan)
    saved = elastic.load_plan(ws)
    assert saved["epoch"] == 1 and saved["dead"] == ["w1-worker"]
    assert os.environ[FENCE_EPOCH_ENV] == "1"
    assert get_obs().metrics.counter(
        "elastic_shrinks_total").value() == c0 + 1
    lines = parse_hostfile(hf)
    assert len(lines) == 4
    assert "w1-worker" not in {e.name for e in lines}
    plan2 = elastic.plan_shrink(part_cfg4, entries,
                                ["w1-worker", "w2-worker"])
    elastic.apply_shrink(ws, entries, plan2)
    assert elastic.load_plan(ws)["epoch"] == 2
    assert elastic.current_epoch(ws) == jelastic.current_epoch(ws) == 2


@pytest.mark.parametrize("dead", [["w1-worker"], ["w0-worker", "w2-worker"]])
def test_shrink_files_match_jax(part_cfg4, tmp_path, dead):
    """The same book, job view and dead set: both packages write the
    same ``elastic.json`` and ``hostfile_elastic``, byte for byte, with
    measured rates steering the plan."""
    obs = tmp_path / "obs"
    obs.mkdir()
    _hb_events(obs / "events.jsonl", {"w0-worker": 0.5, "w1-worker": 0.1,
                                      "w2-worker": 0.2, "w3-worker": 1.0})
    entries = _entries(4)
    texts = []
    for name, mod in (("port", elastic), ("jax", jelastic)):
        ws = str(tmp_path / name)
        os.makedirs(ws)
        plan = mod.plan_shrink(part_cfg4, entries, dead,
                               obs_dir=str(obs))
        hf = mod.apply_shrink(ws, entries, plan)
        assert os.environ[FENCE_EPOCH_ENV] == "1"
        texts.append((_read(mod.plan_path(ws)), _read(hf)))
    assert texts[0] == texts[1]
    assert json.loads(texts[0][0])["rates"]


def test_hosts_lost_and_detect_dead(tmp_path, monkeypatch):
    """Only a fatal host loss counts as dead: the exception chain's
    ``FabricHostLost`` (alone or inside a batch failure) and the chaos
    dead markers, restricted to the mapping's hosts."""
    lost = FabricHostLost("gone", host="w1-worker")
    batch = BatchFabricError([(0, "w2-worker", FabricHostLost("x")),
                              (1, "w0-worker", RuntimeError("flaky"))])
    assert elastic.hosts_lost_in(lost) == ["w1-worker"]
    assert elastic.hosts_lost_in(batch) == ["w2-worker"]
    assert elastic.hosts_lost_in(RuntimeError("x")) == []
    ws = str(tmp_path)
    monkeypatch.setenv(chaos.WORKSPACE_ENV, ws)
    chaos.mark_host_dead("w3-worker", ws)
    chaos.mark_host_dead("elsewhere", ws)
    assert elastic.detect_dead(ws, _entries(4), exc=lost) == \
        ["w1-worker", "w3-worker"]


def test_resolve_keeps_shrunk_mapping_while_host_dead(part_cfg4,
                                                      tmp_path,
                                                      monkeypatch):
    ws = str(tmp_path)
    hf_full = os.path.join(ws, "hostfile")
    write_hostfile(hf_full, _entries(4))
    entries = parse_hostfile(hf_full)
    monkeypatch.setenv(chaos.WORKSPACE_ENV, ws)
    chaos.mark_host_dead("w2-worker", ws)
    plan = elastic.plan_shrink(part_cfg4, entries, ["w2-worker"])
    elastic.apply_shrink(ws, entries, plan)

    args = argparse.Namespace()
    # the dead marker fails the liveness probe through the chaos fabric
    fab = ChaosFabric(LocalFabric(), ChaosPlan.parse(""))
    out = elastic.resolve(args, ws, part_cfg4, hf_full, fab)
    assert out.endswith("hostfile_elastic")
    assert args.elastic_sig == "epoch-1"
    assert args.placement_path == elastic.plan_path(ws)

    chaos.readmit_host("w2-worker", ws)
    args2 = argparse.Namespace()
    c0 = get_obs().metrics.counter("elastic_regrows_total").value()
    out2 = elastic.resolve(args2, ws, part_cfg4, hf_full, fab)
    assert out2 == hf_full
    assert elastic.load_plan(ws)["dead"] == []
    assert elastic.load_plan(ws)["epoch"] == 2
    assert args2.elastic_sig == "epoch-2"
    assert os.environ[FENCE_EPOCH_ENV] == "2"
    assert get_obs().metrics.counter(
        "elastic_regrows_total").value() == c0 + 1


@pytest.mark.parametrize("state", ["fresh", "shrunk", "regrown"])
def test_both_drivers_sign_placement_and_elastic_alike(part_cfg4, tmp_path,
                                                       monkeypatch, state):
    """``--placement auto --elastic`` over one workspace: each driver's
    placement and elastic resolution leave the same files and the same
    phase-ledger signature, at a first launch, while a host is dead and
    after it is readmitted."""
    ws = tmp_path / "ws"
    (ws / "obs").mkdir(parents=True)
    hf_full = str(tmp_path / "hostfile")
    entries = _entries(4)
    write_hostfile(hf_full, entries)
    _hb_events(ws / "obs" / "events.jsonl",
               {"w0-worker": 0.5, "w1-worker": 0.1, "w2-worker": 0.2,
                "w3-worker": 1.0})
    monkeypatch.setenv(chaos.WORKSPACE_ENV, str(ws))
    monkeypatch.setenv("TPU_OPERATOR_OBS_DIR", str(ws / "obs"))
    if state != "fresh":
        chaos.mark_host_dead("w3-worker", str(ws))
        plan = elastic.plan_shrink(part_cfg4, entries, ["w3-worker"],
                                   obs_dir=str(ws / "obs"))
        elastic.apply_shrink(str(ws), entries, plan)
        if state == "regrown":
            chaos.readmit_host("w3-worker", str(ws))
    saved = _read(elastic.plan_path(str(ws))) if state != "fresh" else None
    argv = ["--graph-name", "karate", "--num-partitions", "4",
            "--workspace", str(ws), "--placement", "auto", "--elastic"]
    got = {}
    for name, mod, el, fab in (
            ("port", tpurun, elastic,
             ChaosFabric(LocalFabric(), ChaosPlan.parse(""))),
            ("jax", jax_tpurun, jelastic,
             JChaosFabric(JLocalFabric(), JChaosPlan.parse("")))):
        if saved is not None:   # each driver starts from the same plan
            with open(elastic.plan_path(str(ws)), "w") as f:
                f.write(saved)
        args = mod.build_parser().parse_args(argv)
        hf = mod._resolve_placement(args, str(ws), part_cfg4, hf_full)
        hf = el.resolve(args, str(ws), part_cfg4, hf, fab)
        files = {os.path.basename(p): _read(p) for p in (
            hf, str(ws / "placement.json"), el.plan_path(str(ws)))
            if os.path.exists(p)}
        got[name] = (mod.PhaseLedger.signature_of(args, None),
                     args.elastic_sig, os.path.basename(hf), files,
                     os.environ[FENCE_EPOCH_ENV])
    assert got["port"] == got["jax"]
    want_epoch = {"fresh": "0", "shrunk": "1", "regrown": "2"}[state]
    assert got["port"][1] == f"epoch-{want_epoch}"
    assert got["port"][4] == want_epoch


# ------------------------------------------------ health: dead status
def _hb(host, pid, role, ts, step, event="heartbeat", **kw):
    return {"host": host, "pid": pid, "role": role, "ts": ts,
            "event": event, "step": step, **kw}


def _write_events(obs_dir, events):
    os.makedirs(obs_dir, exist_ok=True)
    with open(os.path.join(obs_dir, "events.jsonl"), "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")


def test_job_health_reports_dead_workers(tmp_path):
    obs_dir = str(tmp_path / "obs")
    evs = [_hb("m", 1, "trainer-0", 100.0 + i, i) for i in range(5)]
    evs += [_hb("m", 2, "trainer-1", 100.0 + i, i) for i in range(5)]
    evs.append(_hb("m", 2, "trainer-1", 104.5, 4, event="host_died",
                   host_name="w1-worker"))
    evs.append(_hb("m", 1, "trainer-0", 140.0, 40))
    _write_events(obs_dir, evs)
    snap = job_health(obs_dir, now=141.0)
    assert snap["dead"] == ["m:2:trainer-1"]
    assert snap["dead_hosts"] == ["w1-worker"]
    assert snap["workers"]["m:2:trainer-1"]["status"] == "dead"
    assert not snap["healthy"]
    assert "m:2:trainer-1" not in snap["stalled"]
    assert snap == janalyze.job_health(obs_dir, now=141.0)


def test_analyze_job_elasticity_block_and_findings(tmp_path):
    evs = [_hb("m", 2, "trainer-1", 100.0 + i, i) for i in range(3)]
    evs.append(_hb("m", 2, "trainer-1", 103.0, 3, event="host_died",
                   host_name="w1-worker"))
    rep = analyze_job(events=list(evs))
    f = [x for x in rep["findings"] if x["kind"] == "host_died"]
    assert len(f) == 1 and f[0]["severity"] == "critical"
    assert rep["elasticity"]["dead_hosts"] == ["w1-worker"]
    evs.append({"host": "m", "pid": 9, "role": "tpurun", "ts": 104.0,
                "event": "elastic_shrink", "dead": ["w1-worker"],
                "width": 3, "full_width": 4, "epoch": 1,
                "assignment": {}})
    evs.append({"host": "m", "pid": 9, "role": "tpurun", "ts": 105.0,
                "event": "elastic_regrow", "hosts": ["w1-worker"],
                "epoch": 2, "width": 4})
    rep2 = analyze_job(events=evs)
    f2 = [x for x in rep2["findings"] if x["kind"] == "host_died"]
    assert f2[0]["severity"] == "warning"
    el = rep2["elasticity"]
    assert el["shrinks"] == 1 and el["regrows"] == 1
    assert el["width"] == 3 and el["full_width"] == 4
    assert el["last_epoch"] == 2
    assert rep2["summary"]["host_deaths"] == 1
    assert not [x for x in rep2["findings"]
                if x["kind"] == "worker_stalled"]
    assert el == janalyze.analyze_job(events=list(evs))["elasticity"]


# --------------------------------------- controller restart accounting
def _scripted(base):
    class Scripted(base):
        """Reconcile stream without a cluster or binary — isolates
        reconcile_until's policy."""

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
    return Scripted


ScriptedController = _scripted(Controller)


def test_dead_host_restarts_count_toward_backoff_limit(tmp_path):
    """A dead→restart cycle that never recovers terminates with
    BackoffLimitExceeded naming the dead worker, the message carrying
    the doctor's findings — as the JAX controller does."""
    from dgl_operator_tpu.obs import obs_run as jobs_run

    script = [{"phase": "Training", "actions": ["heal"], "requeue": True}]

    def health():
        return {"stalled": [], "dead": ["m:2:trainer-1"],
                "dead_hosts": ["w1-worker"]}

    out = {}
    for name, cls, run in (("port", ScriptedController, obs_run),
                           ("jax", _scripted(JController), jobs_run)):
        ctl = cls(script)
        job = simple_job("el", 1, launcher_command=["tpurun"])
        job.status["phase"] = "Training"
        with run(str(tmp_path / name), role="test") as obs:
            (obs.emit if name == "port" else obs.events.emit)(
                "host_died", host_name="w1-worker", step=3)
            res = ctl.reconcile_until(job, max_iters=50, backoff_limit=2,
                                      health=health)
        out[name] = (res, dict(job.status), ctl.i)
    res, status, calls = out["port"]
    assert res == "Failed"
    assert status["reason"] == "BackoffLimitExceeded"
    assert "m:2:trainer-1" in status["message"]
    assert "doctor:" in status["message"] and "host_died" in \
        status["message"]
    assert calls == 2
    assert out["port"] == out["jax"]


def test_healthy_health_feed_keeps_normal_lifecycle():
    ctl = ScriptedController([
        {"phase": "Training", "actions": ["x"], "requeue": True},
        {"phase": "Completed"},
    ])
    job = simple_job("ok", 1)
    job.status["phase"] = "Training"
    out = ctl.reconcile_until(job, max_iters=10, backoff_limit=1,
                              health=lambda: {"stalled": [],
                                              "dead": []})
    assert out == "Completed"
    assert "reason" not in job.status


@pytest.mark.parametrize("snap,reason", [
    ({"dead": ["m:2:trainer-0"], "dead_hosts": ["w0-worker"]}, "HostDead"),
    ({"stalled": ["m:3:trainer-1"]}, "Stalled"),
    ({"numerics": ["m:4:trainer-0"]}, "NumericsFault"),
    ({"replicas_down": ["r1"]}, "ReplicaDead")])
def test_act_on_health_marks_the_launcher(snap, reason):
    """No cluster store: the job status is stamped directly with the
    same reason and message as the JAX controller's."""
    got = []
    for cls in (ScriptedController, _scripted(JController)):
        ctl = cls([{"phase": "Training"}])
        job = simple_job("hd", 1)
        job.status["phase"] = "Training"
        acted = ctl._act_on_health(job, snap)
        got.append((acted, dict(job.status)))
    assert got[0] == got[1]
    assert got[0][1]["reason"] == reason
    assert got[0][0][0] in got[0][1]["message"]


# --------------------------------------------------------- e2e tpurun
def _digest(params):
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


_ELASTIC_ENTRY = """
import argparse, hashlib, json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
ap = argparse.ArgumentParser()
for f in ("--graph_name", "--ip_config", "--part_config"):
    ap.add_argument(f)
for f in ("--num_epochs", "--batch_size", "--num_workers"):
    ap.add_argument(f, type=int)
a = ap.parse_args()
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.runtime.loop import (Preempted, SampledTrainer,
                                                 TrainConfig)
# elastic hostfile contract: line i = partition i, so the rank IS the
# partition; streams are keyed by (step position, partition) through
# the per-partition seed, never by host
part = int(os.environ["TPU_OPERATOR_RANK"])
ws = os.environ["TPU_OPERATOR_WORKSPACE"]
ds = datasets.synthetic_node_clf(num_nodes=240, num_edges=1200, feat_dim=8,
                                 num_classes=4, seed=3)
ids = np.nonzero(ds.graph.ndata["train_mask"])[0]
cfg = TrainConfig(num_epochs=a.num_epochs, batch_size=a.batch_size,
                  fanouts=(3, 3), log_every=1000, eval_every=0, dropout=0.0,
                  seed=100 + part,
                  ckpt_dir=os.path.join(ws, "ckpt", f"part-{{part}}"),
                  ckpt_every=2)
model = DistSAGE(8, 8, 4, dropout=0.0, device="cpu",
                 generator=torch.Generator().manual_seed(100 + part))
tr = SampledTrainer(model, ds.graph, cfg, train_ids=ids[part::{num_parts}],
                    device="cpu")
try:
    out = tr.train()
except Preempted:
    raise SystemExit(75)
h = hashlib.sha256()
for k in sorted(out["params"]):
    h.update(out["params"][k].detach().cpu().numpy().tobytes())
with open(os.path.join({result_dir!r}, f"result-{{part}}.json"), "w") as f:
    json.dump({{"part": part, "step": out["step"], "digest": h.hexdigest(),
               "epoch_env": os.environ.get("TPU_OPERATOR_ELASTIC_EPOCH")}},
              f)
"""


def _baseline(part, num_parts, num_epochs, batch):
    """The undisturbed same-seed run, in process: the entry's model,
    seeds and stream keys (the checkpoint knobs are math-inert)."""
    ds = datasets.synthetic_node_clf(num_nodes=240, num_edges=1200,
                                     feat_dim=8, num_classes=4, seed=3)
    ids = np.nonzero(ds.graph.ndata["train_mask"])[0]
    cfg = TrainConfig(num_epochs=num_epochs, batch_size=batch,
                      fanouts=(3, 3), log_every=1000, eval_every=0,
                      dropout=0.0, seed=100 + part)
    model = DistSAGE(8, 8, 4, dropout=0.0, device="cpu",
                     generator=torch.Generator().manual_seed(100 + part))
    tr = SampledTrainer(model, ds.graph, cfg,
                        train_ids=ids[part::num_parts], device="cpu")
    out = tr.train()
    return _digest(out["params"]), out["step"], len(ids[part::num_parts])


def test_e2e_host_die_shrinks_resumes_and_stays_bit_identical(
        tmp_path, monkeypatch):
    """``host:die:<step>`` mid-train → the elastic driver re-places the
    dead host's partition over the survivor, relaunches from the fenced
    checkpoint, the job completes at reduced width, and every
    partition's final parameters are bit-identical to an undisturbed
    same-seed run; afterwards the readmitted host regrows the mapping to
    full width."""
    num_epochs, batch = 2, 16
    ws = tmp_path / "ws"
    ws.mkdir()
    g = datasets.karate_club().graph
    partition_graph(g, "karate", 2, str(ws / "dataset"))
    conf = tmp_path / "conf"
    conf.mkdir()
    write_hostfile(str(conf / "hostfile"), _entries(2))
    entry = tmp_path / "train.py"
    entry.write_text(textwrap.dedent(_ELASTIC_ENTRY.format(
        repo=REPO, result_dir=str(tmp_path), num_parts=2)))
    argv = ["--graph-name", "karate", "--num-partitions", "2",
            "--train-entry-point", str(entry), "--workspace", str(ws),
            "--conf-dir", str(conf), "--num-epochs", str(num_epochs),
            "--batch-size", str(batch), "--fabric", "local",
            "--elastic"]

    base0, steps0, _ = _baseline(0, 2, num_epochs, batch)
    base1, steps1, n1 = _baseline(1, 2, num_epochs, batch)
    steps_per_epoch = max(n1 // batch, 1)
    assert steps_per_epoch >= 2                  # death lands mid-run
    die = steps_per_epoch + 1

    monkeypatch.setenv(chaos.CHAOS_ENV, f"host:die:{die}@host=w1-worker")
    monkeypatch.setenv("TPU_OPERATOR_RETRY_BASE_S", "0.05")
    tpurun.main(argv)                            # completes despite death

    out0 = json.loads((tmp_path / "result-0.json").read_text())
    out1 = json.loads((tmp_path / "result-1.json").read_text())
    assert out0["digest"] == base0 and out0["step"] == steps0
    assert out1["digest"] == base1 and out1["step"] == steps1
    # the relaunched incarnation ran under the fenced epoch
    assert out1["epoch_env"] == "1"

    plan = elastic.load_plan(str(ws))
    assert plan["dead"] == ["w1-worker"]
    assert plan["width"] == 1 and plan["epoch"] == 1
    placed = parse_hostfile(os.path.join(str(ws), "hostfile_elastic"))
    assert [e.name for e in placed] == ["w0-worker", "w0-worker"]

    evs = [json.loads(ln) for ln in open(ws / "obs" / "events.jsonl")]
    kinds = [e["event"] for e in evs]
    assert "host_died" in kinds and "elastic_shrink" in kinds
    died = next(e for e in evs if e["event"] == "host_died")
    assert died["host_name"] == "w1-worker" and died["step"] == die

    # fencing: the relaunched incarnation wrote under epoch-1, and a
    # zombie from epoch 0 can no longer open the directory
    part1_ckpt = ws / "ckpt" / "part-1"
    assert (part1_ckpt / "epoch-1").is_dir()
    with pytest.raises(FencedOut):
        CheckpointManager(str(part1_ckpt), fence_epoch=0)
    assert CheckpointManager(str(part1_ckpt)).latest_step() == steps1

    # --- regrow on readmission (next launch = checkpoint boundary) ---
    monkeypatch.delenv(chaos.CHAOS_ENV, raising=False)
    monkeypatch.setattr(chaos, "_PROC_PLAN", None)
    chaos.readmit_host("w1-worker", str(ws))
    tpurun.main(argv)
    plan2 = elastic.load_plan(str(ws))
    assert plan2["dead"] == [] and plan2["epoch"] == 2
    evs2 = [json.loads(ln) for ln in open(ws / "obs" / "events.jsonl")]
    regrow = [e for e in evs2 if e["event"] == "elastic_regrow"]
    assert regrow and regrow[-1]["hosts"] == ["w1-worker"]
    assert regrow[-1]["width"] == 2
    again = json.loads((tmp_path / "result-1.json").read_text())
    assert again["digest"] == base1 and again["epoch_env"] == "2"

    # the doctor: the elasticity block tells the story, and the handled
    # death reads as a warning, not critical
    from dgl_operator_tpu_torch.obs import doctor as doctor_mod
    rc = doctor_mod.main([str(ws / "obs")])
    report = json.loads((ws / "obs" / "job" / "report.json").read_text())
    el = report["elasticity"]
    assert el["dead_hosts"] == ["w1-worker"]
    assert el["shrinks"] >= 1 and el["regrows"] >= 1
    died_findings = [f for f in report["findings"]
                     if f["kind"] == "host_died"]
    assert died_findings and all(f["severity"] == "warning"
                                 for f in died_findings)
    assert rc == 0
