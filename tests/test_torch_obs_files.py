"""The port's obs file plane against the JAX package's, on the CPU.

One scripted sequence of events, spans, metrics, phase folds, profiler
ticks, comm windows and a flight dump, on a fake clock, is written once
through the JAX ``Obs`` and once through the port's: the two
directories hold the same records (``events.jsonl``, ``metrics.json``,
``trace.json``, ``flight-<pid>.json``). Then a tiny ``SampledTrainer``
run of each package leaves a directory of its own, and on every
directory each package's readers — ``merge_job_view``, ``analyze_job``,
``xray_summary``, ``prof_summary``, ``comm_summary`` and
``model_health_summary`` — and its doctor (``--json``) give the same
answers: each package reads the other's files. Last, ``obs_run``
leaves no environment behind and a run without an obs directory writes
no file.
"""

import contextlib
import io
import json
import os
import shutil
import time

import pytest
import torch

import dgl_operator_tpu.obs as jobs
from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.obs import analyze as j_analyze
from dgl_operator_tpu.obs import collect as j_collect
from dgl_operator_tpu.obs import comm as j_comm
from dgl_operator_tpu.obs import doctor as j_doctor
from dgl_operator_tpu.obs import flight as j_flight
from dgl_operator_tpu.obs import prof as j_prof
from dgl_operator_tpu.obs import quality as j_quality
from dgl_operator_tpu.obs import xray as j_xray
from dgl_operator_tpu.runtime import SampledTrainer as JaxSampledTrainer
from dgl_operator_tpu.runtime import TrainConfig as JaxTrainConfig
from dgl_operator_tpu.runtime.timers import PhaseTimer as JaxPhaseTimer
import dgl_operator_tpu_torch.obs as pobs
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.obs import analyze as p_analyze
from dgl_operator_tpu_torch.obs import collect as p_collect
from dgl_operator_tpu_torch.obs import comm as p_comm
from dgl_operator_tpu_torch.obs import doctor as p_doctor
from dgl_operator_tpu_torch.obs import flight as p_flight
from dgl_operator_tpu_torch.obs import prof as p_prof
from dgl_operator_tpu_torch.obs import quality as p_quality
from dgl_operator_tpu_torch.obs import xray as p_xray
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig
from dgl_operator_tpu_torch.runtime.timers import PhaseTimer
from test_torch_native import use_jax_graphcore

GRAPH = dict(num_nodes=400, num_edges=2000, feat_dim=8, num_classes=4,
             seed=3)
RUN = "20261018T000000-abcdef"
ENVS = (pobs.OBS_DIR_ENV, pobs.OBS_RUN_ENV, pobs.OBS_ROLE_ENV,
        "TPU_OPERATOR_CHAOS", "TPU_OPERATOR_LIVE_PORT",
        "TPU_OPERATOR_TUNED_MANIFEST", "TPU_OPERATOR_WORKSPACE")
PEAKS = {"peak_flops": 1e12, "peak_hbm_gbps": 100.0, "source": "config"}
# the two packages' modules, side by side
PKG = {
    "jax": dict(obs=jobs, analyze=j_analyze, collect=j_collect,
                comm=j_comm, doctor=j_doctor, flight=j_flight, prof=j_prof,
                quality=j_quality, xray=j_xray, timer=JaxPhaseTimer),
    "port": dict(obs=pobs, analyze=p_analyze, collect=p_collect,
                 comm=p_comm, doctor=p_doctor, flight=p_flight,
                 prof=p_prof, quality=p_quality, xray=p_xray,
                 timer=PhaseTimer),
}


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ENVS:
        monkeypatch.delenv(name, raising=False)
    for m in PKG.values():
        m["prof"].reset_profiler()
        m["flight"].reset_flight()
        m["comm"].reset_ledger()
        m["comm"].reset_axis_bytes()
    yield
    for m in PKG.values():
        m["prof"].reset_profiler()
        m["flight"].reset_flight()
        m["comm"].reset_ledger()


class FakeClock:
    """``time.time`` and ``time.perf_counter`` that move only when told:
    both packages then stamp the same records."""

    def __init__(self, now: float = 1.8e9):
        self.now = now

    def time(self):
        return self.now

    def perf(self):
        return self.now - 1.7e9


def _emitters(pkg, obs):
    if pkg == "jax":
        return obs.events.emit, obs.tracer.complete
    return obs.emit, obs.complete


@contextlib.contextmanager
def _jax_program(name):
    prev = j_comm.set_current_program(name)
    try:
        yield
    finally:
        j_comm.set_current_program(prev)


def _script(pkg, directory, clock):
    """The scripted sequence, written through ``pkg``'s obs."""
    m = PKG[pkg]
    with m["obs"].obs_run(directory, role="trainer-0", run_id=RUN,
                          console=False) as obs:
        emit, complete = _emitters(pkg, obs)
        m["flight"].get_flight()._clock = clock.time
        prof = m["prof"].get_profiler()
        prof._clock = clock.time
        prof.configure(peaks=dict(PEAKS),
                       fallback_cost={"flops": 1e6, "bytes": 1e6,
                                      "source": "analytic"},
                       predicted_hbm_mib=12.5)
        prof.set_program_cost("dp_train_step", "step", 4e9, 2e9,
                              source="flop_counter")
        prof.set_program_cost("halo_exchange_stage", "exchange", 0.0,
                              3e8, source="byte_model")
        comm = m["comm"]
        # the packages' ways to run seams under a program: a JAX
        # binding, a port call scope
        with (comm.call_scope("dp_train_step") if pkg == "port"
              else _jax_program("dp_train_step")):
            comm.register_collective("grad_pmean", "dp", 4096)
            comm.register_collective("halo_ring", "dp", 1 << 20)
        watcher = comm.CommWatcher(peaks={"peak_ici_gbps": 450.0,
                                          "peak_dcn_gbps": 0.0,
                                          "source": "config"})
        ref = None
        if pkg == "jax":
            import jax.numpy as jnp
            ref = jnp.zeros(1)
        timer = m["timer"]()
        timer.total.update(dispatch=0.5, sample=0.25, stall=0.125)
        timer.count.update(dispatch=8, sample=8, stall=8)
        timer.bytes.update(exchange=1 << 22)
        for step in range(1, 9):
            clock.now += 0.05
            t0 = clock.perf() - 0.04
            complete("train_compute", t0, t0 + 0.02, cat="pipeline",
                     step=step)
            complete("halo_exchange", t0 + 0.02, t0 + 0.03,
                     cat="pipeline", step=step)
            prof.note_call("dp_train_step")
            prof.note_call("halo_exchange_stage")
            watcher.watch(ref if pkg == "jax" else torch.zeros(1),
                          clock.perf() - 0.01, step=step,
                          program="dp_train_step")
            watcher.drain()
            emit("heartbeat", step=step, epoch=0)
            prof.on_heartbeat(step)
            m["flight"].get_flight().note("heartbeat", step=step, epoch=0)
            if step == 4:
                emit("jit_compile", fn="dp_train_step_multi", call=3,
                     seconds=0.5, steady=True)
                emit("grad_explosion", step=step, partition=1,
                     grad_norm=88.0)
        watcher.shutdown()
        timer.fold_into(obs.metrics)
        obs.metrics.counter("train_steps_total",
                            "optimizer steps executed").inc(8)
        obs.metrics.gauge("train_loss", "loss at the last epoch end").set(
            1.25)
        obs.metrics.gauge("train_quality_grad_norm", "grad norm").set(2.5)
        obs.metrics.gauge("train_seeds_per_sec",
                          "throughput of the last epoch").set(4000.0)
        obs.metrics.histogram("train_epoch_seconds", "epoch wall-clock"
                              ).observe(0.4)
        emit("epoch", epoch=0, loss=1.25, time=0.4)
        complete("epoch 0", clock.perf() - 0.4, clock.perf(), cat="train",
                 epoch=0, steps=8)
        emit("train_done", step=8)
        m["flight"].get_flight().dump("preempted")


def _records(directory):
    with open(os.path.join(directory, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    with open(os.path.join(directory, "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(directory, "trace.json")) as f:
        trace = json.load(f)["traceEvents"]
    main_tid = next(e["tid"] for e in trace if e.get("name") == "epoch 0")
    # the watcher thread's id is the process's own: masked
    trace = [dict(e, tid="watch" if e.get("tid") not in (0, main_tid)
                  else e.get("tid")) for e in trace]
    flights = sorted(n for n in os.listdir(directory)
                     if n.startswith("flight-"))
    with open(os.path.join(directory, flights[0])) as f:
        flight = json.load(f)
    return events, metrics, trace, flight


@pytest.fixture(scope="module")
def scripted(tmp_path_factory):
    root = tmp_path_factory.mktemp("scripted")
    mp = pytest.MonkeyPatch()
    dirs = {}
    try:
        for name in ENVS:
            mp.delenv(name, raising=False)
        for pkg in ("jax", "port"):
            clock = FakeClock()
            for m in PKG.values():
                m["prof"].reset_profiler()
                m["flight"].reset_flight()
                m["comm"].reset_ledger()
            # the packages' watermark readers see different devices
            mp.setattr(PKG[pkg]["prof"], "device_watermarks_mib",
                       lambda: {"dev0": 64.0})
            mp.setattr(time, "time", clock.time)
            mp.setattr(time, "perf_counter", clock.perf)
            try:
                dirs[pkg] = str(root / pkg)
                _script(pkg, dirs[pkg], clock)
            finally:
                mp.undo()
                for name in ENVS:
                    mp.delenv(name, raising=False)
    finally:
        mp.undo()
    return dirs


def test_scripted_sequence_writes_the_jax_files(scripted):
    jax_files = _records(scripted["jax"])
    port_files = _records(scripted["port"])
    for name, j, p in zip(("events", "metrics", "trace", "flight"),
                          jax_files, port_files):
        assert p == j, name
    events, metrics, trace, flight = port_files
    kinds = [e["event"] for e in events]
    assert kinds.count("heartbeat") == 8 and kinds[-1] == "train_done"
    assert all(e["run"] == RUN and e["role"] == "trainer-0"
               for e in events)
    merged = metrics["merged"]
    for fam in ("train_phase_seconds", "train_mfu", "comm_bytes_total",
                "train_hbm_watermark_mib", "prof_peak_flops"):
        assert fam in merged, fam
    assert flight["reason"] == "preempted"
    assert {e["ph"] for e in trace} >= {"X", "C", "M"}


def _readers(pkg, directory):
    """Every reader of ``pkg`` on a copy of ``directory``."""
    m = PKG[pkg]
    work = directory + f".{pkg}"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(directory, work,
                    ignore=shutil.ignore_patterns("job", ".obs.lock*"))
    jd = m["collect"].job_dir_of(work)
    view = m["collect"].merge_job_view(jd, sources=[("local", work)])
    events = m["analyze"].load_events(os.path.join(jd, "events.jsonl"))
    with open(os.path.join(jd, "metrics.json")) as f:
        procs = json.load(f)["procs"]
    out = {"view": view,
           "analyze": m["analyze"].analyze_job(work),
           "xray": m["xray"].xray_summary(work),
           "prof": m["prof"].prof_summary(work),
           "comm": m["comm"].comm_summary(work),
           "health": m["quality"].model_health_summary(events, procs)}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = m["doctor"].main([work, "--json"])
    report = json.loads(buf.getvalue())
    out["doctor"] = (rc, _mask(report, work))
    return _mask(out, work)


def _mask(obj, path):
    """``path`` and the run's host and pid out of a reader's answer."""
    text = json.dumps(obj, sort_keys=True, default=str)
    return json.loads(text.replace(path, "<dir>"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_readers_agree_on_the_scripted_files(scripted, writer):
    jax_view = _readers("jax", scripted[writer])
    port_view = _readers("port", scripted[writer])
    assert port_view == jax_view
    assert jax_view["prof"]["roofline_bound"] == "memory"
    assert jax_view["comm"]["comm_ops"] == ["grad_pmean", "halo_ring"]
    assert jax_view["health"]["grad_explosions"] == 1
    # the steady compile is a critical finding, so the doctor exits 1
    assert jax_view["doctor"][0] == 1
    kinds = {f["kind"] for f in jax_view["analyze"]["findings"]}
    assert "steady_state_recompile" in kinds


def test_both_scripted_directories_read_alike(scripted):
    assert _readers("port", scripted["port"]) \
        == _readers("port", scripted["jax"])


# ---------------------------------------------------------------------
# a tiny trainer run of each package
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("trained")
    mp = pytest.MonkeyPatch()
    try:
        for name in ENVS:
            mp.delenv(name, raising=False)
        use_jax_graphcore(mp, tmp_path_factory)
        dirs = {"jax": str(root / "jax"), "port": str(root / "port")}
        with jobs.obs_run(dirs["jax"], role="trainer-0", console=False):
            g = jax_datasets.synthetic_node_clf(**GRAPH).graph
            cfg = JaxTrainConfig(num_epochs=2, batch_size=32,
                                 fanouts=(3, 3), log_every=1000,
                                 eval_every=1000, dropout=0.0, seed=0)
            JaxSampledTrainer(JaxDistSAGE(hidden_feats=8, out_feats=4,
                                          dropout=0.0), g, cfg).train()
        with pobs.obs_run(dirs["port"], role="trainer-0", console=False):
            g = datasets.synthetic_node_clf(**GRAPH).graph
            cfg = TrainConfig(num_epochs=2, batch_size=32, fanouts=(3, 3),
                              log_every=1000, eval_every=0, dropout=0.0,
                              seed=0)
            model = DistSAGE(8, 8, 4, dropout=0.0, device="cpu",
                             generator=torch.Generator().manual_seed(1))
            SampledTrainer(model, g, cfg, device="cpu").train()
    finally:
        mp.undo()
    return dirs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_readers_agree_on_a_trainer_run(trained, writer):
    jax_view = _readers("jax", trained[writer])
    port_view = _readers("port", trained[writer])
    assert port_view == jax_view
    assert jax_view["doctor"][0] == 0
    prof = jax_view["prof"]
    assert set(p_prof.PROF_KEYS) <= set(prof)
    assert 0 < prof["train_mfu"] <= 1
    xr = jax_view["xray"]
    assert abs(sum(xr[f"critpath_frac_{c}"]
                   for c in p_xray.CATEGORIES) - 1.0) < 1e-6
    assert jax_view["analyze"]["summary"]["epochs"] == 2


def test_port_run_writes_the_jax_families(trained):
    """The port's trainer leaves the metric families, events and spans
    the JAX trainer does (values differ: two runs)."""
    def families(d):
        with open(os.path.join(d, "metrics.json")) as f:
            return set(json.load(f)["merged"])

    def kinds(d):
        with open(os.path.join(d, "events.jsonl")) as f:
            return {json.loads(ln)["event"] for ln in f}

    need = {"train_phase_seconds", "train_phase_calls_total",
            "train_steps_total", "train_epochs_total",
            "train_epoch_seconds", "train_loss", "train_seeds_per_sec",
            "train_heartbeat_step", "train_mfu", "train_roofline_frac",
            "prof_peak_flops", "train_hbm_predicted_mib",
            "critpath_frac"}
    assert need <= families(trained["jax"])
    assert need <= families(trained["port"])
    assert {"heartbeat", "epoch", "train_done"} <= kinds(trained["port"])
    with open(os.path.join(trained["port"], "trace.json")) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"train", "epoch 0", "epoch 1", "MFU"} <= names


# ---------------------------------------------------------------------
# no interference
# ---------------------------------------------------------------------
def test_obs_run_restores_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv(pobs.OBS_RUN_ENV, "outer")
    with pobs.obs_run(str(tmp_path / "a"), role="t") as obs:
        assert os.environ[pobs.OBS_DIR_ENV] == obs.directory
        assert os.environ[pobs.OBS_RUN_ENV] == "outer" == obs.run_id
        assert pobs.get_obs() is obs
        obs.emit("hello")
    assert pobs.OBS_DIR_ENV not in os.environ
    assert os.environ[pobs.OBS_RUN_ENV] == "outer"
    assert pobs.get_obs().directory is None
    # the directory was flushed on exit
    assert {"events.jsonl", "metrics.json", "metrics.prom",
            "trace.json"} <= set(os.listdir(tmp_path / "a"))


def test_no_obs_directory_writes_no_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    obs = pobs.get_obs()
    assert obs.directory is None
    g = datasets.synthetic_node_clf(**GRAPH).graph
    cfg = TrainConfig(num_epochs=1, batch_size=64, fanouts=(3, 3),
                      eval_every=0, dropout=0.0, seed=0)
    model = DistSAGE(8, 8, 4, dropout=0.0, device="cpu")
    SampledTrainer(model, g, cfg, device="cpu").train()
    obs.flush()
    p_flight.get_flight().dump("preempted")
    assert os.listdir(tmp_path) == []
    assert [e["kind"] for e in obs.events][-1] == "train_done"
    assert obs.tracer.chrome()["traceEvents"][1:] == []
