"""The port's chaos plan, preemption guard and drills against the JAX
package's, on the CPU.

The plan parses every spec of a table as the JAX plan does (rules,
values, ``@host=`` scoping, the fire-once ``take_*`` accessors) and
refuses the same bad specs. ``train:kill`` preempts the port's
``SampledTrainer`` at the JAX trainer's step, a fresh trainer resumes
where the JAX one does and its parameters equal an uninterrupted run's
bit for bit (dropout 0); a kill without ``ckpt_dir`` still raises; a
killed ``DistTrainer`` leaves no sampler, prefetch or writer thread
behind in either layout. ``host:die`` exits 113 from a subprocess with
the dead-host marker and no checkpoint past the last periodic one;
``ckpt:corrupt`` makes the restore fall back; ``step:slow`` bills the
``stall`` phase; ``numerics:nan`` faults both trainers at the JAX
trainer's step and partition, and the workspace's fired marker stops a
relaunch from being poisoned again. The captured K = 4 graph's poison
on a card is ``tests/test_torch_chaos_cuda.py``'s (a file the card's
machine can collect: it imports nothing of the JAX package).
"""

import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph.partition import partition_graph
from dgl_operator_tpu.launcher import chaos as jax_chaos
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.obs import quality as JQ
from dgl_operator_tpu.parallel import make_mesh
from dgl_operator_tpu.runtime import DistTrainer as JaxDistTrainer
from dgl_operator_tpu.runtime import SampledTrainer as JaxSampledTrainer
from dgl_operator_tpu.runtime import TrainConfig as JaxTrainConfig
from dgl_operator_tpu.runtime.loop import Preempted as JaxPreempted
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.launcher import chaos
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.obs import get_obs
from dgl_operator_tpu_torch.obs import quality as Q
from dgl_operator_tpu_torch.runtime.checkpoint import CheckpointManager
from dgl_operator_tpu_torch.runtime.dist import DistTrainer
from dgl_operator_tpu_torch.runtime.loop import (Preempted, SampledTrainer,
                                                 TrainConfig)
from test_torch_native import use_jax_graphcore

pytestmark = pytest.mark.chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH = dict(num_nodes=400, num_edges=2000, feat_dim=8, num_classes=4,
             seed=3)
B = 32
ENVS = ("TPU_OPERATOR_CHAOS", "TPU_OPERATOR_WORKSPACE",
        "TPU_OPERATOR_HOSTFILE_PATH", "TPU_OPERATOR_RANK",
        "TPU_OPERATOR_TUNED_MANIFEST", "TPU_OPERATOR_LIVE_PORT",
        "TPU_OPERATOR_ELASTIC_EPOCH")


@pytest.fixture(autouse=True)
def jax_library(monkeypatch, tmp_path_factory):
    use_jax_graphcore(monkeypatch, tmp_path_factory)
    for name in ENVS:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def jax_tap_sees_every_step(monkeypatch):
    """The JAX trainers' tap, ready at every push. Its poll returns only
    the newest of the entries that ripened together, so under JAX's
    asynchronous dispatch the first bad step it reports depends on
    timing; with every entry ready at its push, it observes each step,
    as the port's trainers do."""
    push = JQ.StatsTap.push

    def ready_push(self, step, loss, stats):
        jax.block_until_ready((loss, stats))
        push(self, step, loss, stats)

    monkeypatch.setattr(JQ.StatsTap, "push", ready_push)


# ---------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------
SPECS = ["train:kill:5", "seed=7;exec:fail:2@host=w1;copy:flaky:0.25",
         "exec:timeout:1;any:fail:3;exec:delay:0.5",
         "host:die:4@host=w1;host:die:9", "host:die:6",
         "ckpt:corrupt:3;ckpt:corrupt:8@host=w0", "numerics:nan:7",
         "replica:die:3@host=r1", "replica:die:2", "step:slow:0.05@host=w0",
         "promote:bad", "promote:bad;promote:bad:1",
         " train:kill:2 ; ; numerics:nan:4 ;step:slow:1"]
BAD_SPECS = ["exec:frobnicate:1", "train:fail:3", "exec:kill:2",
             "host:kill:1", "numerics:fail:3", "exec:nan:3",
             "replica:bad", "train:kill", "step:slow", "ckpt:corrupt",
             "train:kill:x", "kill:train:3", "seed=x"]
HOSTS = (None, "w0", "w1", "r1", "r9")


def _plan_view(mod, spec):
    plan = mod.ChaosPlan.parse(spec)
    view = {"rules": [repr(r) for r in plan.rules], "seed": plan.seed,
            "kill": plan.train_kill_step(),
            "nan": plan.numerics_nan_step()}
    for h in HOSTS:
        view[h] = (plan.host_die_step(h), plan.step_slow_seconds(h),
                   plan.replica_die_after(h))
    # the fire-once accessors, in one fixed order of calls
    view["promote"] = [repr(plan.take_promote_bad()) for _ in range(3)]
    view["ckpt"] = [repr(plan.take_ckpt_corrupt(s, h))
                    for s, h in ((2, None), (3, "w1"), (4, None),
                                 (9, "w1"), (9, "w0"), (12, "w0"))]
    view["injected"] = list(plan.injected)
    return view


@pytest.mark.parametrize("spec", SPECS)
def test_plan_parses_as_the_jax_plan(spec):
    assert _plan_view(chaos, spec) == _plan_view(jax_chaos, spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_are_refused_as_by_jax(spec):
    with pytest.raises(ValueError) as want:
        jax_chaos.ChaosPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        chaos.ChaosPlan.parse(spec)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_env_helpers_host_names_and_dead_markers(tmp_path, monkeypatch):
    assert chaos.proc_plan() is None and chaos.plan_from_env() is None
    monkeypatch.setenv(chaos.CHAOS_ENV, "exec:fail:1;train:kill:12")
    assert chaos.plan_from_env().train_kill_step() == \
        jax_chaos.train_kill_step() == 12
    plan = chaos.proc_plan()
    assert chaos.proc_plan() is plan       # one plan a process and spec
    monkeypatch.setenv(chaos.CHAOS_ENV, "promote:bad")
    assert chaos.proc_plan() is not plan
    hf = tmp_path / "hosts"
    hf.write_text("10.0.0.1 30050 w0 slots=1\n10.0.0.2 30050 w1 slots=1\n")
    env = {"TPU_OPERATOR_HOSTFILE_PATH": str(hf)}
    for rank in ("0", "1", "2", "x", ""):
        env["TPU_OPERATOR_RANK"] = rank
        assert chaos.my_host_name(env) == jax_chaos.my_host_name(env)
    ws = str(tmp_path / "ws")
    chaos.mark_host_dead("w1", ws)
    assert chaos.dead_hosts(ws) == jax_chaos.dead_hosts(ws) == ["w1"]
    assert jax_chaos.readmit_host("w1", ws)
    assert chaos.dead_hosts(ws) == [] and not chaos.readmit_host("w1", ws)
    assert chaos.HOST_DIED_EXIT == jax_chaos.HOST_DIED_EXIT == 113


# ---------------------------------------------------------------------
# train:kill
# ---------------------------------------------------------------------
def _jax_trainer(ckpt, epochs=3, **kw):
    g = jax_datasets.synthetic_node_clf(**GRAPH).graph
    cfg = JaxTrainConfig(num_epochs=epochs, batch_size=B, fanouts=(3, 3),
                         log_every=1000, eval_every=1000, dropout=0.0,
                         seed=0, ckpt_dir=ckpt, **kw)
    return JaxSampledTrainer(JaxDistSAGE(hidden_feats=8, out_feats=4,
                                         dropout=0.0), g, cfg)


def _port_trainer(ckpt, epochs=3, **kw):
    g = datasets.synthetic_node_clf(**GRAPH).graph
    cfg = TrainConfig(num_epochs=epochs, batch_size=B, fanouts=(3, 3),
                      log_every=1000, eval_every=0, dropout=0.0, seed=0,
                      ckpt_dir=ckpt, **kw)
    model = DistSAGE(8, 8, 4, dropout=0.0, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    return SampledTrainer(model, g, cfg, device="cpu")


def _kill_and_resume(make, preempted, tmp, latest):
    with pytest.raises(preempted, match="step 5") as exc:
        make(tmp).train()
    flushed = latest(tmp)
    out = make(tmp).train()          # the kill step has passed: inert
    return exc.value, flushed, out


def test_train_kill_flushes_and_resumes_as_jax(tmp_path, monkeypatch):
    from dgl_operator_tpu.runtime.checkpoint import \
        CheckpointManager as JaxCheckpointManager
    monkeypatch.setenv(chaos.CHAOS_ENV, "train:kill:5")
    _, j_flushed, j_out = _kill_and_resume(
        _jax_trainer, JaxPreempted, str(tmp_path / "jax"),
        lambda d: JaxCheckpointManager(d).latest_step())
    _, p_flushed, p_out = _kill_and_resume(
        _port_trainer, Preempted, str(tmp_path / "port"),
        lambda d: CheckpointManager(d).latest_step())
    assert p_flushed == j_flushed == 5
    assert p_out["step"] == j_out["step"]
    assert ([h["epoch"] for h in p_out["history"]]
            == [h["epoch"] for h in j_out["history"]] == [0, 1, 2])
    # the resumed run equals an uninterrupted one bit for bit
    monkeypatch.delenv(chaos.CHAOS_ENV)
    ref = _port_trainer(None).train()
    assert all(torch.equal(ref["params"][k], v)
               for k, v in p_out["params"].items())
    assert ([x for h in ref["history"] for x in h["losses"]][5:]
            == [x for h in p_out["history"] for x in h["losses"]])
    kinds = [e["kind"] for e in get_obs().events]
    assert "chaos_train_kill" in kinds and "preempted" in kinds


def test_train_kill_without_ckpt_dir_still_raises(monkeypatch):
    monkeypatch.setenv(chaos.CHAOS_ENV, "train:kill:2")
    with pytest.raises(Preempted, match="no ckpt_dir"):
        _port_trainer(None, epochs=1).train()


THREADS = ("sampler", "slot-sampler", "ckpt-writer", "tpu-livez")


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    from dgl_operator_tpu_torch.graph.partition import \
        partition_graph as port_partition
    g = datasets.synthetic_node_clf(**GRAPH).graph
    return port_partition(g, "chaos", 4, str(tmp_path_factory.mktemp("b")))


def _dist(book, layout, ckpt, **kw):
    cfg = TrainConfig(num_epochs=2, batch_size=16, fanouts=(3, 3),
                      log_every=1000, eval_every=0, dropout=0.0, seed=0,
                      ckpt_dir=ckpt, prefetch=2, num_samplers=4,
                      feats_layout=layout, **kw)
    model = DistSAGE(8, 8, 4, dropout=0.0, device="cpu",
                     generator=torch.Generator().manual_seed(2))
    return DistTrainer(model, book, cfg, device="cpu")


@pytest.mark.parametrize("layout", ["replicated", "owner"])
def test_killed_dist_trainer_leaves_no_thread(book, layout, tmp_path,
                                              monkeypatch):
    ckpt = str(tmp_path / "ckpt")
    spe = _dist(book, layout, ckpt).steps_per_epoch
    assert spe >= 2
    kill = spe + 1                        # mid-epoch 1
    monkeypatch.setenv(chaos.CHAOS_ENV, f"train:kill:{kill}")
    with pytest.raises(Preempted, match=f"step {kill}"):
        _dist(book, layout, ckpt).train()
    assert [t.name for t in threading.enumerate()
            if t.name.startswith(THREADS)] == []
    assert CheckpointManager(ckpt).latest_step() == kill
    out = _dist(book, layout, ckpt).train()
    assert out["step"] == 2 * spe
    assert [h["epoch"] for h in out["history"]] == [1]
    assert [t.name for t in threading.enumerate()
            if t.name.startswith(THREADS)] == []


# ---------------------------------------------------------------------
# host:die, ckpt:corrupt, step:slow
# ---------------------------------------------------------------------
HOST_DIE = """
import torch
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig
g = datasets.synthetic_node_clf(num_nodes=400, num_edges=2000, feat_dim=8,
                                num_classes=4, seed=3).graph
cfg = TrainConfig(num_epochs=1, batch_size=32, fanouts=(3, 3),
                  eval_every=0, dropout=0.0, ckpt_dir={ckpt!r},
                  ckpt_every=2)
SampledTrainer(DistSAGE(8, 8, 4, device="cpu"), g, cfg,
               device="cpu").train()
print("survived")
"""


def test_host_die_exits_113_with_the_marker(tmp_path):
    hf = tmp_path / "hosts"
    hf.write_text("127.0.0.1 30050 w0 slots=1\n127.0.0.1 30051 w1 "
                  "slots=1\n")
    ws, ckpt = tmp_path / "ws", tmp_path / "ckpt"
    ws.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO, TPU_OPERATOR_RANK="1",
               TPU_OPERATOR_HOSTFILE_PATH=str(hf),
               TPU_OPERATOR_WORKSPACE=str(ws),
               TPU_OPERATOR_CHAOS="host:die:5@host=w1")
    proc = subprocess.run([sys.executable, "-c",
                           HOST_DIE.format(ckpt=str(ckpt))], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == chaos.HOST_DIED_EXIT, proc.stderr[-2000:]
    assert "survived" not in proc.stdout
    assert chaos.dead_hosts(str(ws)) == ["w1"]
    # no checkpoint past the last periodic one (step 4's may still have
    # been in its writer when the process vanished)
    assert CheckpointManager(str(ckpt)).latest_step() in (2, 4)


def test_ckpt_corrupt_falls_back(tmp_path, monkeypatch):
    monkeypatch.setenv(chaos.CHAOS_ENV, "ckpt:corrupt:3")
    mgr = CheckpointManager(str(tmp_path))
    c = get_obs().metrics.counter("chaos_faults_injected_total",
                                  labels=("verb", "action"))
    before = c.value(verb="ckpt", action="corrupt")
    like = {"w": np.zeros(4, np.float32)}
    for step in (2, 4):
        mgr.save(step, {"w": np.full(4, step, np.float32)})
    assert c.value(verb="ckpt", action="corrupt") == before + 1
    # the newest intact checkpoint, past the stomped one
    step, state = mgr.restore(None, like)
    assert step == 2 and state["w"].tolist() == [2.0] * 4
    mgr.save(6, {"w": np.full(4, 6, np.float32)})      # fired once
    assert mgr.restore(None, like)[0] == 6


def test_step_slow_bills_stall(monkeypatch):
    monkeypatch.setenv(chaos.CHAOS_ENV, "step:slow:0.05")
    tr = _port_trainer(None, epochs=1, prefetch=0)
    out = tr.train()
    calls = out["history"][0]["calls"]
    assert out["history"][0]["stall"] >= 0.05 * calls
    spans = [s for s in get_obs().spans if s["name"] == "chaos_step_slow"]
    assert len(spans) >= calls
    monkeypatch.delenv(chaos.CHAOS_ENV)
    assert "stall" not in _port_trainer(None, epochs=1,
                                        prefetch=0).train()["history"][0]


# ---------------------------------------------------------------------
# numerics:nan
# ---------------------------------------------------------------------
NAN_AT = 4


def test_numerics_nan_faults_sampled_trainer_at_the_jax_step(
        tmp_path, monkeypatch, jax_tap_sees_every_step):
    monkeypatch.setenv(chaos.CHAOS_ENV, f"numerics:nan:{NAN_AT}")
    faults = {}
    for side in ("jax", "port"):
        ws = tmp_path / side
        ws.mkdir()
        monkeypatch.setenv(Q.WORKSPACE_ENV, str(ws))
        if side == "jax":
            tr = _jax_trainer(None, epochs=1, quality_action="halt")
            exc = JQ.NumericsFault
        else:
            tr = _port_trainer(None, epochs=1, quality_action="halt")
            exc = Q.NumericsFault
        with pytest.raises(exc) as got:
            tr.train()
        faults[side] = got.value
        assert (ws / Q.NUMERICS_FIRED_MARKER).exists()
    assert (faults["port"].step, faults["port"].partition,
            faults["port"].kind) == (faults["jax"].step,
                                     faults["jax"].partition,
                                     faults["jax"].kind)
    assert faults["port"].step == NAN_AT + 1
    # the relaunch on the same workspace is not poisoned again
    out = _port_trainer(None, epochs=1, quality_action="halt").train()
    assert np.isfinite(out["history"][0]["losses"]).all()


def test_numerics_nan_faults_dist_trainer_at_the_jax_partition(
        tmp_path, monkeypatch, jax_tap_sees_every_step):
    jg = jax_datasets.synthetic_node_clf(**GRAPH).graph
    jbook = partition_graph(jg, "synth", 4, str(tmp_path / "book"))
    cfg = dict(num_epochs=1, batch_size=8, lr=0.01, fanouts=(3, 3),
               log_every=1000, eval_every=0, quality_action="halt")
    monkeypatch.setenv(chaos.CHAOS_ENV, f"numerics:nan:{NAN_AT}")
    faults = {}
    for side in ("jax", "port"):
        ws = tmp_path / f"ws-{side}"
        ws.mkdir()
        monkeypatch.setenv(Q.WORKSPACE_ENV, str(ws))
        if side == "jax":
            tr = JaxDistTrainer(JaxDistSAGE(hidden_feats=8, out_feats=4,
                                            dropout=0.0), jbook,
                                make_mesh(num_dp=4), JaxTrainConfig(**cfg))
            init = jax.device_get(tr._init_params())
            exc = JQ.NumericsFault
            run = tr.train
        else:
            tr = DistTrainer(DistSAGE(8, 8, 4, dropout=0.0, device="cpu"),
                             jbook, TrainConfig(**cfg, dropout=0.0),
                             device="cpu")
            exc = Q.NumericsFault

            def run():
                return tr.train(init_params=init)
        with pytest.raises(exc) as got:
            run()
        faults[side] = got.value
    assert (faults["port"].step, faults["port"].partition,
            faults["port"].kind) == (faults["jax"].step,
                                     faults["jax"].partition,
                                     faults["jax"].kind)
