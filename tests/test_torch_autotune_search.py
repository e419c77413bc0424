"""The port's knob search, probe scorer and partition placement against
the JAX package's: the rung math, the seeded draw, the halving winner,
the probe ledger (resumed across the two packages), the obs-artifact
scorer with its zero-median guard, greedy LPT placement on a measured
skew, the stalled-restart hostfile regeneration through ``tpurun``, the
doctor's tuning block, and one search end to end through real probe
subprocesses on the CPU whose manifest a port ``tpurun`` job consumes.
"""

import json
import os

import pytest

from dgl_operator_tpu.autotune import placement as JPL
from dgl_operator_tpu.autotune import probe as jprobe
from dgl_operator_tpu.autotune import search as jsearch
from dgl_operator_tpu.launcher import revise as jax_revise
from dgl_operator_tpu.launcher import tpurun as jax_tpurun
from dgl_operator_tpu_torch.autotune import knobs as AK
from dgl_operator_tpu_torch.autotune import placement as PL
from dgl_operator_tpu_torch.autotune.probe import (ProbeSpec, make_probe_fn,
                                                   score_probe)
from dgl_operator_tpu_torch.autotune.search import (SearchLedger,
                                                    config_key,
                                                    rung_schedule,
                                                    sample_configs,
                                                    successive_halving)
from dgl_operator_tpu_torch.launcher import revise, tpurun
from dgl_operator_tpu_torch.parallel.bootstrap import (HostEntry,
                                                       parse_hostfile,
                                                       write_hostfile)

pytestmark = pytest.mark.autotune

_SPACE = {"halo_cache_frac": (0.0, 0.25, 0.5, 1.0),
          "num_samplers": (1, 2), "prefetch": (0, 2)}
ENVS = ("TPU_OPERATOR_OBS_DIR", "TPU_OPERATOR_OBS_RUN",
        "TPU_OPERATOR_OBS_ROLE", "TPU_OPERATOR_PHASE_ENV",
        "TPU_OPERATOR_CHAOS", "TPU_OPERATOR_WORKSPACE",
        "TPU_OPERATOR_TUNED_MANIFEST", "TPU_OPERATOR_ELASTIC_EPOCH",
        "TPU_OPERATOR_LIVE_PORT")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ENVS:
        monkeypatch.delenv(name, raising=False)


def _synthetic_scorer(calls=None):
    """Deterministic pure scorer: prefers halo_cache_frac 0.5,
    num_samplers 2, prefetch 2 — independent of steps."""
    def probe_fn(knobs, steps, rung):
        if calls is not None:
            calls.append((config_key(knobs), steps, rung))
        score = (100.0
                 - abs(knobs.get("halo_cache_frac", 0.0) - 0.5) * 40
                 + knobs.get("num_samplers", 0) * 3
                 + knobs.get("prefetch", 0))
        return {"score": score}
    return probe_fn


# ------------------------------------------------------------- search
def test_rung_schedule_math():
    assert rung_schedule(8, 2, 2) == [(0, 2, 8), (1, 4, 4), (2, 8, 2),
                                      (3, 16, 1)]
    assert rung_schedule(5, 3, 2) == [(0, 3, 5), (1, 6, 3), (2, 12, 2),
                                      (3, 24, 1)]
    assert rung_schedule(1, 2, 2) == [(0, 2, 1)]
    for args in ((8, 2, 2), (5, 3, 2), (1, 2, 2), (4, 8, 2), (9, 1, 3)):
        assert rung_schedule(*args) == jsearch.rung_schedule(*args)


def test_sample_configs_deterministic_with_default_first():
    a = sample_configs(_SPACE, 6, seed=7)
    b = sample_configs(_SPACE, 6, seed=7)
    assert a == b and len(a) == 6
    assert a[0] == {"halo_cache_frac": 0.25, "num_samplers": 0,
                    "prefetch": 2}              # registry defaults
    assert len({config_key(c) for c in a}) == 6
    # a grid smaller than n returns the whole grid, default first
    small = sample_configs({"prefetch": (0, 2)}, 10, seed=1)
    assert small[0] == {"prefetch": 2}
    assert {c["prefetch"] for c in small} == {0, 2}


@pytest.mark.parametrize("space,n,seed", [
    (_SPACE, 6, 7), (_SPACE, 6, 3), (_SPACE, 12, 0),
    ({"prefetch": (0, 2)}, 10, 1),
    ({"num_samplers": (0, 2), "feats_layout": ("replicated", "owner")}, 4,
     0),
    ({"num_samplers": (1, 2), "feats_layout": ("replicated", "owner")}, 4,
     0)])
def test_sample_configs_match_jax(space, n, seed):
    """The same space and seed draw the same candidates, in the same
    order, with the same keys, in both packages."""
    got = sample_configs(space, n, seed)
    assert got == jsearch.sample_configs(space, n, seed)
    assert [config_key(c) for c in got] == \
        [jsearch.config_key(c) for c in got]


def test_successive_halving_deterministic_winner(tmp_path):
    """Rung math on a synthetic scorer: the analytic argmax wins, the
    schedule matches the eta-ladder, and the same seed reproduces the
    identical search."""
    r1 = successive_halving(_SPACE, _synthetic_scorer(), n0=6, eta=2,
                            base_steps=2, seed=3)
    r2 = successive_halving(_SPACE, _synthetic_scorer(), n0=6, eta=2,
                            base_steps=2, seed=3)
    assert r1["winner"] == r2["winner"]
    assert r1["rungs"] == r2["rungs"]
    assert r1["schedule"] == [(0, 2, 6), (1, 4, 3), (2, 8, 2),
                              (3, 16, 1)]
    cands = sample_configs(_SPACE, 6, seed=3)
    fn = _synthetic_scorer()
    best = min(cands, key=lambda c: (-fn(c, 0, 0)["score"],
                                     config_key(c)))
    assert r1["winner"] == best
    assert r1["winner_score"] == fn(best, 0, 0)["score"]
    assert [len(r["survivors"]) for r in r1["rungs"]] == [3, 2, 1, 1]


@pytest.mark.parametrize("n0,eta,base,seed", [(6, 2, 2, 3), (8, 2, 1, 0),
                                              (5, 3, 2, 11)])
def test_successive_halving_matches_jax(n0, eta, base, seed):
    """Same space, seed and scorer: the same candidates, rungs (scores
    and survivors), schedule, winner and signature in both packages."""
    calls, jcalls = [], []
    got = successive_halving(_SPACE, _synthetic_scorer(calls), n0=n0,
                             eta=eta, base_steps=base, seed=seed)
    want = jsearch.successive_halving(_SPACE, _synthetic_scorer(jcalls),
                                      n0=n0, eta=eta, base_steps=base,
                                      seed=seed)
    assert calls == jcalls
    assert got == want


def test_search_ledger_resume_skips_completed_probes(tmp_path):
    """Kill mid-search → relaunch with the same definition: completed
    probes come from the ledger (probe_fn NOT called again) and the
    final result is identical to an uninterrupted run."""
    ledger = str(tmp_path / "ledger.json")

    class Boom(RuntimeError):
        pass

    calls1 = []
    inner = _synthetic_scorer(calls1)

    def dying(knobs, steps, rung):
        if len(calls1) >= 7:                    # die mid-rung-1
            raise Boom()
        return inner(knobs, steps, rung)

    with pytest.raises(Boom):
        successive_halving(_SPACE, dying, n0=6, eta=2, base_steps=2,
                           seed=3, ledger_path=ledger)
    assert len(calls1) == 7                     # 6 rung-0 + 1 rung-1
    with open(ledger) as f:
        assert len(json.load(f)["probes"]) == 7

    calls2 = []
    resumed = successive_halving(_SPACE, _synthetic_scorer(calls2),
                                 n0=6, eta=2, base_steps=2, seed=3,
                                 ledger_path=ledger)
    assert len(calls2) == 12 - 7
    assert resumed["probes_skipped"] == 7
    assert resumed["probes_run"] == 5
    clean = successive_halving(_SPACE, _synthetic_scorer(), n0=6,
                               eta=2, base_steps=2, seed=3)
    assert resumed["winner"] == clean["winner"]
    assert resumed["rungs"] == clean["rungs"]
    # a DIFFERENT definition starts fresh (signature mismatch)
    calls3 = []
    successive_halving(_SPACE, _synthetic_scorer(calls3), n0=6, eta=2,
                       base_steps=3, seed=3, ledger_path=ledger)
    assert len(calls3) == 12


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ledger_written_by_either_package_resumes_in_the_other(tmp_path,
                                                               writer):
    """A finished search's ledger, resumed by the other package, runs 0
    probes and gives the same result; the files' bytes are equal."""
    first, second = ((jsearch.successive_halving, successive_halving)
                     if writer == "jax" else
                     (successive_halving, jsearch.successive_halving))
    path = str(tmp_path / "ledger.json")
    done = first(_SPACE, _synthetic_scorer(), n0=6, eta=2, base_steps=2,
                 seed=3, ledger_path=path)
    calls = []
    again = second(_SPACE, _synthetic_scorer(calls), n0=6, eta=2,
                   base_steps=2, seed=3, ledger_path=path)
    assert calls == [] and again["probes_run"] == 0
    assert again["probes_skipped"] == done["probes_run"] == 12
    assert again["winner"] == done["winner"]
    assert again["rungs"] == done["rungs"]
    other = str(tmp_path / "other.json")
    second(_SPACE, _synthetic_scorer(), n0=6, eta=2, base_steps=2, seed=3,
           ledger_path=other)
    with open(path) as f, open(other) as g:
        assert f.read() == g.read()


def test_search_ledger_signature_and_tolerance(tmp_path):
    sig = SearchLedger.signature_of(_SPACE, 6, 2, 2, 3)
    assert sig == SearchLedger.signature_of(dict(_SPACE), 6, 2, 2, 3)
    assert sig != SearchLedger.signature_of(_SPACE, 6, 2, 2, 4)
    assert sig == jsearch.SearchLedger.signature_of(_SPACE, 6, 2, 2, 3)
    # torn/garbage ledger file → starts fresh, no crash
    path = tmp_path / "torn.json"
    path.write_text('{"signature": "x", "probes": {')
    led = SearchLedger(str(path), sig)
    assert led.get("k") is None
    led.put("k", {"score": 1.0})
    assert SearchLedger(str(path), sig).get("k") == {"score": 1.0}


# -------------------------------------------------------- probe scorer
def _fake_obs_dir(tmp_path, sps_by_proc, phase_sums):
    """Synthesize the metrics.json a probe run leaves: per-proc
    train_seeds_per_sec gauges + folded train_phase_seconds."""
    procs = {}
    for proc, sps in sps_by_proc.items():
        snap = {"train_seeds_per_sec": {
            "type": "gauge", "samples": [{"labels": {}, "value": sps}]}}
        fam = {"samples": [
            {"labels": {"phase": ph}, "sum": float(v)}
            for ph, v in phase_sums.get(proc, {}).items()]}
        if fam["samples"]:
            snap["train_phase_seconds"] = fam
        procs[proc] = snap
    d = tmp_path / "obs"
    d.mkdir(parents=True, exist_ok=True)
    (d / "metrics.json").write_text(json.dumps({"procs": procs}))
    return str(d)


def test_score_probe_reads_obs_artifacts_only(tmp_path):
    d = _fake_obs_dir(tmp_path, {"h:1:probe": 120.0},
                      {"h:1:probe": {"dispatch": 1.0, "sample": 0.2}})
    out = score_probe(d)
    assert out["seeds_per_sec"] == 120.0
    assert out["score"] == 120.0                # balanced: no penalty
    assert out["skew_penalty"] == 1.0
    assert out == jprobe.score_probe(d)


def test_score_probe_penalizes_stragglers_and_guards_zero_median(
        tmp_path):
    """An all-zero bucket yields ratio=None (skew_summary zero-median
    contract) and the scorer must SKIP it — never compare None — while a
    real straggling bucket still discounts the score; both packages
    score each directory alike."""
    d = _fake_obs_dir(
        tmp_path, {"a:1:t": 50.0, "b:1:t": 50.0, "c:1:t": 50.0},
        {"a:1:t": {"dispatch": 1.0, "stall": 0.0},
         "b:1:t": {"dispatch": 1.0, "stall": 0.0},
         "c:1:t": {"dispatch": 3.0, "stall": 0.0}})
    out = score_probe(d)
    assert out["skew"]["stall"]["ratio"] is None   # zero median
    assert out["skew_worst_ratio"] == 3.0          # None skipped
    assert out["score"] == pytest.approx(150.0 * 1.5 / 3.0)
    assert out == jprobe.score_probe(d)
    d2 = _fake_obs_dir(tmp_path / "z", {"a:1:t": 10.0},
                       {"a:1:t": {"stall": 0.0}})
    out2 = score_probe(d2)
    assert out2["skew_worst_ratio"] == 1.0 and out2["score"] == 10.0
    assert out2 == jprobe.score_probe(d2)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert score_probe(str(empty))["score"] == float("-inf")
    assert jprobe.score_probe(str(empty))["score"] == float("-inf")


def test_analyze_and_doctor_survive_all_zero_bucket():
    """The same zero-median regression through the port's job analytics
    and doctor renderer: an all-zero bucket produces no straggler
    finding and renders without comparing None."""
    from dgl_operator_tpu_torch.obs.analyze import analyze_job
    from dgl_operator_tpu_torch.obs.doctor import render

    procs = {}
    for w in ("a:1:t", "b:1:t"):
        procs[w] = {"train_phase_seconds": {"samples": [
            {"labels": {"phase": "exchange"}, "sum": 0.0}]}}
    rep = analyze_job(None, events=[], procs=procs)
    assert rep["skew"]["exchange"]["ratio"] is None
    assert not [f for f in rep["findings"]
                if f["kind"] == "straggler"]
    line = next(ln for ln in render(rep).splitlines()
                if "exchange" in ln)
    assert "None" not in line and "(" not in line


# ------------------------------------------------------ placement (LPT)
def test_lpt_assign_measured_skew_fixture():
    """Heaviest partitions to fastest hosts; the slow host gets the
    LIGHTEST partition; the same mapping as the JAX package."""
    weights = [100.0, 60.0, 10.0]
    rates = {"fast": 4.0, "mid": 2.0, "slow": 0.5}
    lpt = PL.lpt_assign(weights, rates)
    assert lpt == {0: "fast", 1: "mid", 2: "slow"}
    assert lpt == JPL.lpt_assign(weights, rates)
    b = PL.lpt_assign([10, 9, 8, 1], {"f": 2.0, "s": 1.0},
                      slots={"f": 3, "s": 1})
    assert b == {0: "f", 1: "s", 2: "f", 3: "f"}
    assert b == JPL.lpt_assign([10, 9, 8, 1], {"f": 2.0, "s": 1.0},
                               slots={"f": 3, "s": 1})
    # ties break on the host name in both
    tie = {"b": 1.0, "a": 1.0, "c": 1.0}
    assert PL.lpt_assign([5, 5, 5], tie) == JPL.lpt_assign([5, 5, 5], tie)
    with pytest.raises(ValueError, match="exceed"):
        PL.lpt_assign([1, 1, 1], {"x": 1.0})
    assert PL.elastic_slots(5, 2) == JPL.elastic_slots(5, 2) == 3


def _hb_events(path, host_intervals, n=8):
    """heartbeat fixtures: per host, n beats at the given interval."""
    t0 = 1000.0
    with open(path, "w") as f:
        for host, dt in host_intervals.items():
            for i in range(n):
                f.write(json.dumps({
                    "event": "heartbeat", "ts": t0 + i * dt,
                    "host": host, "pid": 7, "role": "trainer-0",
                    "step": i}) + "\n")


def test_host_step_rates_from_measured_heartbeats(tmp_path):
    obs = tmp_path / "obs"
    obs.mkdir()
    _hb_events(obs / "events.jsonl",
               {"w0-worker": 0.1, "w1-worker": 1.0})
    rates = PL.host_step_rates(str(obs))
    assert rates["w0-worker"] == pytest.approx(10.0)
    assert rates["w1-worker"] == pytest.approx(1.0)
    assert rates == JPL.host_step_rates(str(obs))
    # a collected job view wins over the plain directory
    job = obs / "job"
    job.mkdir()
    _hb_events(job / "events.jsonl", {"w0-worker": 0.5})
    assert PL.host_step_rates(str(obs)) == JPL.host_step_rates(str(obs)) \
        == {"w0-worker": pytest.approx(2.0)}
    empty = tmp_path / "none"
    empty.mkdir()
    assert PL.host_step_rates(str(empty)) == {}


def _part_book(path, edges):
    meta = {"num_parts": len(edges), "graph_name": "t"}
    for p, e in enumerate(edges):
        meta[f"part-{p}"] = {"num_edges": e, "num_local_nodes": e}
    path.write_text(json.dumps(meta))
    return str(path)


def test_derive_assigns_slow_host_the_lightest_partition(tmp_path):
    """A job view with an injected slow host → the emitted partition→host
    map gives that host the lightest partition, hostfile generation
    honors it, and both packages write the same placement.json and
    revised hostfiles."""
    obs = tmp_path / "obs"
    obs.mkdir()
    _hb_events(obs / "events.jsonl",
               {"w0-worker": 1.0, "w1-worker": 0.1})  # w0 SLOW
    book = _part_book(tmp_path / "book.json", [500, 40])
    entries = [HostEntry("10.0.0.0", 30050, "w0-worker", 1),
               HostEntry("10.0.0.1", 30051, "w1-worker", 1)]
    placed = PL.derive(str(obs), book, entries)
    assert placed["assignment"] == {"0": "w1-worker",
                                    "1": "w0-worker"}
    assert placed == JPL.derive(str(obs), book, entries)
    ordered = PL.apply_to_entries(entries, placed["assignment"])
    assert [e.name for e in ordered] == ["w1-worker", "w0-worker"]
    assert PL.apply_to_entries(ordered, placed["assignment"]) \
        == ordered
    hostfile = tmp_path / "hostfile"
    write_hostfile(str(hostfile), entries)
    texts = {}
    for name, pl, mod in (("port", PL, revise), ("jax", JPL, jax_revise)):
        ppath = pl.write_placement(str(tmp_path / name / "placement.json"),
                                   placed)
        ws = tmp_path / name / "ws"
        mod.main(["--workspace", str(ws), "--ip_config", str(hostfile),
                  "--framework", "JAX", "--placement", ppath])
        texts[name] = [open(p).read() for p in (
            ppath, ws / "hostfile_revised", ws / "hostfile_placed")]
    assert texts["port"] == texts["jax"]
    assert texts["port"][1].splitlines() == ["10.0.0.1:30051",
                                             "10.0.0.0:30050"]
    assert PL.load_placement(str(tmp_path / "port" / "placement.json")) \
        == placed
    nothing = tmp_path / "empty"
    nothing.mkdir()
    assert PL.derive(str(nothing), book, entries) is None


def test_stalled_restart_regenerates_hostfile_from_placement(tmp_path):
    """The restart loop closes: a straggler measured into the job view
    re-derives the placement on relaunch, regenerates the working
    hostfile, and busts the phase-ledger signature — with the same
    signature the JAX driver gives the same arguments."""
    ws = tmp_path / "ws"
    obs = ws / "obs"
    obs.mkdir(parents=True)
    book = _part_book(tmp_path / "book.json", [500, 40])
    hostfile = tmp_path / "hostfile"
    entries = [HostEntry("10.0.0.0", 30050, "w0-worker", 1),
               HostEntry("10.0.0.1", 30051, "w1-worker", 1)]
    write_hostfile(str(hostfile), entries)
    argv = ["--graph-name", "g", "--workspace", str(ws),
            "--placement", "auto"]

    def resolve(mod, sub):
        args = mod.build_parser().parse_args(argv)
        os.environ["TPU_OPERATOR_OBS_DIR"] = str(obs)
        try:
            hf = mod._resolve_placement(args, str(ws / sub), book,
                                        str(hostfile))
        finally:
            os.environ.pop("TPU_OPERATOR_OBS_DIR", None)
        with open(hf) as f:
            text = f.read()
        return hf, text, mod.PhaseLedger.signature_of(args, None)

    _hb_events(obs / "events.jsonl",
               {"w0-worker": 1.0, "w1-worker": 0.1})
    hf1, text1, sig1 = resolve(tpurun, "p")
    assert hf1 == str(ws / "p" / "hostfile_placed")
    assert [e.name for e in parse_hostfile(hf1)] == \
        ["w1-worker", "w0-worker"]
    _, jtext1, _ = resolve(jax_tpurun, "j")
    assert text1 == jtext1
    _hb_events(obs / "events.jsonl",
               {"w0-worker": 0.1, "w1-worker": 1.0})
    hf2, text2, sig2 = resolve(tpurun, "p")
    assert [e.name for e in parse_hostfile(hf2)] == \
        ["w0-worker", "w1-worker"]
    assert sig1 != sig2
    _, jtext2, _ = resolve(jax_tpurun, "j")
    assert text2 == jtext2
    with open(ws / "p" / "placement.json") as f, \
            open(ws / "j" / "placement.json") as g:
        assert f.read() == g.read()
    # placement off → original hostfile untouched
    args = tpurun.build_parser().parse_args(
        ["--graph-name", "g", "--workspace", str(ws)])
    assert tpurun._resolve_placement(args, str(ws), book,
                                     str(hostfile)) == str(hostfile)


def test_doctor_tuning_block_from_metrics(tmp_path):
    """The doctor's tuning block reads the autotune_* metric families
    out of the merged job metrics — and stays absent for untuned
    runs."""
    from dgl_operator_tpu_torch.obs.doctor import tuning

    merged = {
        "autotune_overrides_applied_total": {"samples": [
            {"labels": {"knob": "halo_cache_frac"}, "value": 2},
            {"labels": {"knob": "num_samplers"}, "value": 2}]},
        "autotune_probes_total": {"samples": [
            {"labels": {"status": "run"}, "value": 5},
            {"labels": {"status": "ledger_skip"}, "value": 2}]},
        "autotune_best_score": {"samples": [{"labels": {},
                                             "value": 123.4}]},
        "autotune_manifest_loaded_total": {"samples": [
            {"labels": {}, "value": 1}]},
        "autotune_placements_total": {"samples": [
            {"labels": {}, "value": 1}]},
    }
    path = tmp_path / "metrics.json"
    path.write_text(json.dumps({"merged": merged}))
    tn = tuning(str(path))
    assert tn["overrides_applied"] == ["halo_cache_frac",
                                      "num_samplers"]
    assert tn["probes"] == {"run": 5, "ledger_skip": 2}
    assert tn["best_score"] == 123.4
    assert tn["placements_applied"] == 1
    path.write_text(json.dumps({"merged": {}}))
    assert tuning(str(path)) is None
    assert tuning(str(tmp_path / "missing.json")) is None


# ------------------------------------------- the search end to end (CPU)
def test_search_through_probe_subprocesses_feeds_a_tpurun_job(tmp_path):
    """Two candidates, two rungs of real probe subprocesses on the CPU
    (``DistTrainer`` over a tiny 2-part book), scored from their obs
    files; a relaunch over the ledger runs none; the winner's manifest
    goes through a port ``tpurun`` job, whose trainer applies it."""
    from dgl_operator_tpu_torch.graph import datasets
    from dgl_operator_tpu_torch.graph.partition import partition_graph
    from dgl_operator_tpu_torch.obs import obs_run
    from dgl_operator_tpu_torch.obs.collect import job_dir_of

    ws = tmp_path / "ws"
    g = datasets.synthetic_node_clf(num_nodes=300, num_edges=1500,
                                    feat_dim=8, num_classes=4, seed=5).graph
    book = partition_graph(g, "g", 2, str(ws / "dataset"))
    spec = ProbeSpec(part_config=book, num_parts=2, batch_size=16,
                     fanouts=(3, 3), seed=0, timeout_s=300, device="cpu")
    space = {"feats_layout": ("replicated", "owner")}
    work = str(tmp_path / "search")
    ledger = os.path.join(work, "ledger.json")
    with obs_run(str(tmp_path / "search_obs"), role="autotune"):
        res = successive_halving(space, make_probe_fn(spec, work), n0=2,
                                 eta=2, base_steps=2, seed=0,
                                 ledger_path=ledger)
    assert res["schedule"] == rung_schedule(2, 2, 2) == [(0, 2, 2),
                                                         (1, 4, 1)]
    assert res["probes_run"] == 3 and res["probes_skipped"] == 0
    with open(ledger) as f:
        probes = json.load(f)["probes"]
    for key, rec in probes.items():
        assert rec["score"] > 0, (key, rec.get("error"))
        with open(rec["record"]) as f:
            record = json.load(f)
        assert record["ok"] and record["probe"]["steps"] >= rec["steps"]
        assert record["device"] == "cpu"
        assert set(record["hbm_budget"]) == {"feats_slot_mib",
                                             "exchange_mib_per_step"}
    again = successive_halving(space, make_probe_fn(spec, work), n0=2,
                               eta=2, base_steps=2, seed=0,
                               ledger_path=ledger)
    assert again["probes_run"] == 0 and again["winner"] == res["winner"]

    manifest = str(tmp_path / "tuned.json")
    AK.write_manifest(manifest, res["winner"], score=res["winner_score"])
    conf = tmp_path / "conf"
    conf.mkdir()
    write_hostfile(str(conf / "hostfile"),
                   [HostEntry("127.0.0.1", 30050 + i, f"w{i}-worker", 1)
                    for i in range(2)])
    examples = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "dgl_operator_tpu_torch", "examples")
    tpurun.main(["--graph-name", "g", "--num-partitions", "2",
                 "--train-entry-point",
                 os.path.join(examples, "train_dist.py"),
                 "--workspace", str(ws), "--conf-dir", str(conf),
                 "--num-epochs", "1", "--batch-size", "16",
                 "--fabric", "local", "--tuned-manifest", manifest,
                 "--train-args", "--device cpu --fan_out 3,3 "
                 "--num_hidden 8 --eval_every 0"])
    with open(os.path.join(job_dir_of(str(ws / "obs")),
                           "metrics.json")) as f:
        merged = json.load(f)["merged"]
    applied = {s["labels"]["knob"] for s in merged.get(
        "autotune_overrides_applied_total", {}).get("samples", [])}
    changed = {k for k, v in res["winner"].items()
               if v != AK.default_of(k)}
    assert changed <= applied
    assert merged["autotune_manifest_loaded_total"]["samples"][0][
        "value"] == 1
