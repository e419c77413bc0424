"""The port's step profiler, comm ledger and flight recorder against the
JAX package's, on the CPU.

Formulas give the JAX numbers: ``analytic_train_cost``, the
partition-parallel trainer's memory bill (the JAX ``DistTrainer``'s own
``_configure_prof`` on the same quantities), ``gather_staging_mib``,
``diff_summaries`` and ``link_of``. ``StepProfiler.on_heartbeat`` on a
fake clock, fed the same program costs and ticks, sets the JAX
profiler's gauges; the ``FlightRecorder`` bounds its ring and dumps as
the JAX one does. Then what is the port's own: the card's peak tables,
the counted cost of a call (``StepCost``: matrix products, bytes, the
kernels' reports, nothing inside ``suspended``), a K-step call billing
K steps to the ledger, the watcher waiting only on an event, and a
capture past the warm-up calls being a steady compile that both
packages' analytics call critical.
"""

import json
import os
import threading
import types

import numpy as np
import pytest
import torch

import dgl_operator_tpu.obs as jobs
from dgl_operator_tpu.obs import analyze as j_analyze
from dgl_operator_tpu.obs import comm as j_comm
from dgl_operator_tpu.obs import flight as j_flight
from dgl_operator_tpu.obs import prof as j_prof
from dgl_operator_tpu.parallel.halo import \
    staging_buffer_bytes as jax_staging_buffer_bytes
from dgl_operator_tpu.runtime.dist import DistTrainer as JaxDistTrainer
import dgl_operator_tpu_torch.obs as pobs
from dgl_operator_tpu_torch.obs import analyze as p_analyze
from dgl_operator_tpu_torch.obs import comm as p_comm
from dgl_operator_tpu_torch.obs import flight as p_flight
from dgl_operator_tpu_torch.obs import prof as p_prof
from dgl_operator_tpu_torch.parallel.halo import staging_buffer_bytes

ENVS = (pobs.OBS_DIR_ENV, pobs.OBS_RUN_ENV, pobs.OBS_ROLE_ENV,
        p_prof.PEAK_FLOPS_ENV, p_prof.PEAK_HBM_ENV, p_comm.PEAK_ICI_ENV,
        p_comm.PEAK_DCN_ENV, "TPU_OPERATOR_TUNED_MANIFEST")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for name in ENVS:
        monkeypatch.delenv(name, raising=False)
    for mod in (j_prof, p_prof):
        mod.reset_profiler()
    for mod in (j_comm, p_comm):
        mod.reset_ledger()
        mod.reset_axis_bytes()
    yield
    for mod in (j_prof, p_prof):
        mod.reset_profiler()
    for mod in (j_comm, p_comm):
        mod.reset_ledger()


# ---------------------------------------------------------------------
# formulas
# ---------------------------------------------------------------------
@pytest.mark.parametrize("args", [(75_648, 286_000, 100, 26_000 * 25),
                                  (1, 0, 0, 0), (4_160, 512, 8, 1_536)])
def test_analytic_train_cost_matches_jax(args):
    assert p_prof.analytic_train_cost(*args) \
        == j_prof.analytic_train_cost(*args)


@pytest.mark.parametrize("depth", [0, 1, 2, 5])
def test_gather_staging_mib_matches_jax(depth):
    leaves = [4096, 1 << 20, 12, 3 << 18, 1 << 20]
    assert p_prof.gather_staging_mib(leaves, depth) \
        == j_prof.gather_staging_mib(leaves, depth)


@pytest.mark.parametrize("run,base,margin", [
    ({"train_mfu": 0.05, "train_seeds_per_sec": 900.0},
     {"train_mfu": 0.06, "train_seeds_per_sec": 1000.0}, 0.15),
    ({"train_mfu": 0.04}, {"train_mfu": 0.06,
                           "train_seeds_per_sec": 1000.0}, 0.15),
    ({"train_mfu": 0.07}, {"train_mfu": 0.0}, 0.5),
])
def test_diff_summaries_matches_jax(run, base, margin):
    assert p_prof.diff_summaries(run, base, margin) \
        == j_prof.diff_summaries(run, base, margin)


@pytest.mark.parametrize("axis", ["dp", "mp", "dcn", "dp_dcn", "DCNx"])
def test_link_of_matches_jax(axis):
    assert p_comm.link_of(axis) == j_comm.link_of(axis)


@pytest.mark.parametrize("device_mode,pipelined,fused", [
    (False, False, False), (True, False, False), (False, True, True),
    (False, True, False)])
def test_dist_memory_bill_matches_the_jax_trainer(device_mode, pipelined,
                                                  fused):
    """The port's bill against the JAX ``DistTrainer._configure_prof``
    run on the same quantities."""
    P, D, rows_pad = 4, 100, 3_000
    feats = np.zeros((P, rows_pad, D), np.float32)
    labels = np.zeros((P, rows_pad), np.int32)
    indptr = np.zeros((P, 2_001), np.int32)
    indices = np.zeros((P, 40_000), np.int32)
    caps = [64, 704, 4_000]
    cfg = types.SimpleNamespace(prefetch=2, fanouts=(10, 5))
    stub = types.SimpleNamespace(
        cfg=cfg, num_parts=P, caps=caps, feats=feats, labels=labels,
        _zero3=False, _device_mode=device_mode, _dev_indptr=indptr,
        _dev_indices=indices, _pipelined=pipelined, _pair_cap=37,
        _pipe_depth=3, _fused=fused, _feat_dtype=np.float32)
    params = {"w": np.zeros((D, 16), np.float32)}
    summary = {"params_mib_per_slot_sharded": 0.25,
               "opt_state_mib_per_slot_sharded": 0.5}
    JaxDistTrainer._configure_prof(stub, params, None, summary)
    want = j_prof.get_profiler().predicted_hbm_mib
    edges = sum(c * f for c, f in zip(caps[:-1], cfg.fanouts))
    staging = (staging_buffer_bytes(P, 37, D, depth=4 if fused else 2)
               if pipelined else 0)
    if pipelined:
        assert staging == jax_staging_buffer_bytes(
            P, 37, D, depth=4 if fused else 2)
    got = p_prof.dist_hbm_bill_mib(
        feat_bytes=feats.nbytes, label_bytes=labels.nbytes, num_slots=P,
        params_mib=0.25, opt_state_mib=0.5,
        csr_bytes=(indptr.nbytes + indices.nbytes) if device_mode else 0,
        staging_bytes=staging, edges=edges, rows=caps[-1], feat_dim=D,
        prefetch=cfg.prefetch)
    assert round(got, 3) == want
    assert j_prof.get_profiler().fallback_cost == p_prof.analytic_train_cost(
        sum(int(np.prod(v.shape)) for v in params.values()), caps[-1], D,
        edges)


# ---------------------------------------------------------------------
# the profiler's arithmetic
# ---------------------------------------------------------------------
def test_step_profiler_sets_the_jax_gauges(tmp_path, monkeypatch):
    outs, gauges = {}, {}
    for name, pk, ob in (("jax", j_prof, jobs), ("port", p_prof, pobs)):
        monkeypatch.setattr(pk, "device_watermarks_mib",
                            lambda: {"dev0": 48.5, "dev1": 12.0})
        now = [100.0]
        prof = pk.StepProfiler(clock=lambda: now[0], window_s=2.0)
        with ob.obs_run(str(tmp_path / name), role="t",
                        console=False) as obs:
            prof.configure(peaks={"peak_flops": 2e12,
                                  "peak_hbm_gbps": 50.0,
                                  "source": "config"},
                           fallback_cost={"flops": 1e9, "bytes": 4e8},
                           predicted_hbm_mib=40.0, flops_scale=1.0)
            prof.set_program_cost("step_k4", "step", 8e9, 1e9)
            prof.set_program_cost("exch", "exchange", 0.0, 2e8)
            seq = []
            for i in range(12):
                now[0] += 0.25 if i % 3 else 0.5
                prof.note_call("step_k4" if i % 4 else "step_one")
                if i % 2:
                    prof.note_call("exch")
                seq.append(prof.on_heartbeat(4 * (i + 1)))
            outs[name] = seq
            snap = obs.metrics.snapshot()
            gauges[name] = {k: snap[k]["samples"] for k in (
                "train_mfu", "train_roofline_frac",
                "train_hbm_watermark_mib", "prof_peak_flops",
                "train_hbm_predicted_mib")}
            assert prof.cost_source() is not None
    assert outs["port"] == outs["jax"]
    assert gauges["port"] == gauges["jax"]


# ---------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------
def test_flight_recorder_matches_jax(tmp_path):
    dumps, views = {}, {}
    for name, fl, ob in (("jax", j_flight, jobs), ("port", p_flight,
                                                   pobs)):
        now = [1000.0]
        rec = fl.FlightRecorder(window_s=3.0, maxlen=6,
                                clock=lambda: now[0])
        for i in range(10):
            now[0] += 0.5
            rec.note("comm", phase="start", seq=i, op="halo_ring",
                     axis="dp", program="dp_train_step", step=i)
            if i < 8:
                rec.note("comm", phase="done", seq=i, op="halo_ring",
                         step=i)
            rec.note("heartbeat", step=i, epoch=0)
        views[name] = (rec.samples(), rec.last_comm_inflight(),
                       rec.last_comm())
        with ob.obs_run(str(tmp_path / name), role="trainer-1",
                        console=False):
            path = rec.dump("host_died")
        with open(path) as f:
            dumps[name] = json.load(f)
        assert os.path.basename(path) == f"flight-{os.getpid()}.json"
        assert fl.load_flights(str(tmp_path / name)) == [dumps[name]]
    assert views["port"] == views["jax"]
    assert len(views["port"][0]) == 6            # the ring's bound
    assert views["port"][1]["seq"] == 9          # last collective in flight
    assert dumps["port"] == dumps["jax"]
    # no directory: no dump, and nothing raised
    assert p_flight.FlightRecorder().dump("preempted") is None


# ---------------------------------------------------------------------
# the card's tables
# ---------------------------------------------------------------------
def test_h100_peaks_by_compute_kind(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    for kind, flops in (("fp32", 67e12), ("tf32", 494.7e12),
                        ("bf16", 989.4e12)):
        peaks = p_prof.resolve_peaks(device="cuda:0", compute=kind)
        assert peaks == {"peak_flops": flops, "peak_hbm_gbps": 3350.0,
                         "source": f"auto:h100-{kind}"}
    assert p_prof.compute_kind("bfloat16") == "bf16"
    assert p_prof.compute_kind(None) in ("fp32", "tf32")
    links = p_comm.resolve_link_peaks(device="cuda:0")
    # NVLink one way; no table names the inter-host network
    assert links == {"peak_ici_gbps": 450.0, "peak_dcn_gbps": 0.0,
                     "source": "auto:h100"}
    monkeypatch.setenv(p_comm.PEAK_DCN_ENV, "25")
    assert p_comm.resolve_link_peaks(device="cuda:0")["peak_dcn_gbps"] \
        == 25.0
    monkeypatch.setenv(p_prof.PEAK_FLOPS_ENV, "1e12")
    monkeypatch.setenv(p_prof.PEAK_HBM_ENV, "10")
    assert p_prof.resolve_peaks(device="cuda:0")["source"] == "env"


def test_cpu_peaks_match_jax():
    assert p_prof.resolve_peaks(device="cpu") == j_prof.resolve_peaks()
    assert p_comm.resolve_link_peaks(device="cpu") \
        == j_comm.resolve_link_peaks()


# ---------------------------------------------------------------------
# the counted cost
# ---------------------------------------------------------------------
def test_step_cost_counts_products_bytes_and_kernel_reports():
    lin = torch.nn.Linear(100, 256)
    x = torch.randn(26, 100)
    with p_prof.StepCost() as cost:
        lin(x).sum().backward()
        p_prof.note_kernel(1000, 2000)
        with p_prof.suspended():
            lin(x).sum().backward()             # counted by nothing
            p_prof.note_kernel(5, 5)
    # forward and weight gradient (x needs none)
    assert cost.flops == 2 * (2 * 26 * 100 * 256) + 1000
    assert cost.nbytes > 26 * 256 * 4 + 2000
    with pytest.raises(RuntimeError):
        with p_prof.StepCost():
            with p_prof.StepCost():
                pass
    # outside a count a report goes nowhere
    p_prof.note_kernel(1, 1)


def test_instrumented_call_costs_once_per_program_and_bills_k_steps():
    calls = []

    def train_call(batch):
        k = len(batch)
        for _ in range(k):
            p_comm.register_collective("grad_pmean", "dp", 100)
            torch.ones(8, 8) @ torch.ones(8, 8)
        calls.append(k)
        return k

    call = p_prof.instrument_call("dp_train_step", train_call,
                                  multi_name="dp_train_step_multi",
                                  steps=len)
    p_prof.get_profiler().configure(peaks={"peak_flops": 1e12,
                                           "peak_hbm_gbps": 10.0})
    for batch in ([1, 2, 3, 4], [1, 2, 3, 4], [5]):
        call(batch)
    progs = p_prof.get_profiler()._programs
    assert progs["dp_train_step_multi"]["flops"] \
        == 4 * progs["dp_train_step"]["flops"] == 4 * 2 * 8 ** 3
    assert progs["dp_train_step_multi"]["calls"] == 2
    assert progs["dp_train_step"]["source"] == "flop_counter"
    assert p_prof.get_profiler().cost_source() == "flop_counter"
    led = p_comm.get_ledger()
    assert [o.bytes_per_call for o in led.ops_of("dp_train_step_multi")] \
        == [400]
    assert [o.bytes_per_call for o in led.ops_of("dp_train_step")] == [100]
    assert p_comm.current_program() == "untraced"


def test_watcher_waits_only_on_the_event():
    seen = []

    class Event:
        def synchronize(self):
            seen.append(threading.current_thread().name)

    p_comm.register_collective("halo_ring", "dp", 1 << 20)
    tracker = types.SimpleNamespace(
        ex=[], add_exchange=lambda a, b: tracker.ex.append((a, b)))
    w = p_comm.CommWatcher(peaks={"peak_ici_gbps": 450.0,
                                  "peak_dcn_gbps": 0.0})
    w.watch(Event(), 1.0, program="untraced", exchange=(tracker,))
    w.watch(None, 2.0, exchange=(tracker,))
    w.drain()
    w.shutdown()
    assert seen and seen[0].startswith(p_comm.WATCH_THREAD_PREFIX)
    # nothing to wait on: the window closed where it was handed over
    assert tracker.ex[1][0] == 2.0 and tracker.ex[1][1] > 2.0
    assert p_comm.axis_bytes_total() == {"dp": float(1 << 20)}


# ---------------------------------------------------------------------
# captures are compiles
# ---------------------------------------------------------------------
def test_capture_past_warm_up_is_a_critical_finding(tmp_path):
    def graphed(batch):
        if batch in (0, 3):                  # a capture at calls 0 and 3
            p_prof.note_capture(0.25)
        return batch

    call = p_prof.instrument_call("sampled_multi_step_device", graphed,
                                  role=None)
    obs_dir = str(tmp_path / "obs")
    with pobs.obs_run(obs_dir, role="trainer-0", console=False) as obs:
        for b in range(5):
            call(b)
    p_prof.note_capture(0.1)                 # outside a call: not steady
    compiles = [e for e in obs.events if e["kind"] == "jit_compile"]
    assert [(e["call"], e["steady"]) for e in compiles[:2]] \
        == [(0, False), (3, True)]
    for analyze in (j_analyze, p_analyze):
        report = analyze.analyze_job(obs_dir)
        crit = [f for f in report["findings"]
                if f["kind"] == "steady_state_recompile"]
        assert len(crit) == 1 and crit[0]["severity"] == "critical"
    with open(os.path.join(obs_dir, "metrics.prom")) as f:
        prom = f.read()
    assert 'jit_compiles_total{fn="sampled_multi_step_device"} 2' in prom
