"""The port's hot-path spans and device-phase counters
(``obs/trace.py::hot_span``, ``runtime/graphs.py::PhaseClock``).

A tiny device-sampler ``SampledTrainer`` runs two epochs on the CPU (the
device run's eager path): with the trace switch off nothing is counted
and the run's span records and ``trace.json`` hold no per-call span;
with it on each span is counted as the loop implies; under a CPU
``torch.profiler`` the spans are ranges nested as the loop nests them.
The ``PhaseTimer``'s buckets are profiler ranges only, and two
snapshots subtract. The test marked ``cuda`` holds one replay's four
phases against CUDA events around it. Imports nothing of the JAX
package, so the card's machine collects it:
``python -m pytest -m cuda tests/test_torch_spans.py``.
"""

import json

import numpy as np
import pytest
import torch

from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.obs import obs_run
from dgl_operator_tpu_torch.obs import quality as Q
from dgl_operator_tpu_torch.obs import trace
from dgl_operator_tpu_torch.runtime.graphs import PhaseClock
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig

B, K, LOG_EVERY = 16, 4, 4
# 15 steps an epoch: three calls of K, then three single steps
STEPS = 15
PER_CALL = ("loop.sentry", "loop.heartbeat", "devrun.eager")
PER_EPOCH = ("epoch.permute", "epoch.drain", "epoch.losses", "epoch.record",
             "devrun.stage")
PREFIXES = ("loop.", "epoch.", "devrun.")


@pytest.fixture(autouse=True)
def _switch_restored(monkeypatch, tmp_path):
    monkeypatch.delenv(trace.TRACE_ENV, raising=False)
    monkeypatch.delenv("TPU_OPERATOR_RANK", raising=False)
    monkeypatch.setenv(Q.WORKSPACE_ENV, str(tmp_path))
    yield
    trace.configure({})


@pytest.fixture(scope="module")
def graph():
    return datasets.synthetic_node_clf(num_nodes=400, num_edges=2000,
                                       feat_dim=8, num_classes=4,
                                       seed=3).graph


def _trainer(graph, device="cpu", epochs=2):
    cfg = TrainConfig(num_epochs=epochs, batch_size=B, fanouts=(3, 3),
                      eval_every=0, dropout=0.0, sampler="device",
                      steps_per_call=K, log_every=LOG_EVERY)
    model = DistSAGE(8, 8, 4, dropout=0.0, device=device)
    return SampledTrainer(model, graph, cfg,
                          train_ids=np.arange(STEPS * B, dtype=np.int64),
                          device=device)


def _calls_per_epoch() -> int:
    return STEPS // K + STEPS % K


def _run(graph, directory, monkeypatch, on: bool):
    if on:
        monkeypatch.setenv(trace.TRACE_ENV, "1")
    else:
        monkeypatch.delenv(trace.TRACE_ENV, raising=False)
    with obs_run(str(directory), role="test", console=False) as o:
        before = trace.snapshot()
        out = _trainer(graph).train()
        after = trace.snapshot()
        spans = sorted({s["name"] for s in o.spans})
    with open(directory / trace.TRACE_JSON) as f:
        names = sorted({e["name"] for e in json.load(f)["traceEvents"]
                        if e.get("ph") == "X"})
    return out, before, after, spans, names


def test_switch_off_counts_nothing_and_files_hold_no_call_span(
        graph, tmp_path, monkeypatch):
    out, before, after, spans, names = _run(graph, tmp_path / "off",
                                            monkeypatch, on=False)
    assert not trace.tracing()
    assert after == before
    assert len(out["history"]) == 2
    on = _run(graph, tmp_path / "on", monkeypatch, on=True)
    assert on[1] != on[2]
    # the switch adds no record to the run's spans nor to trace.json
    assert spans == on[3] and names == on[4]
    assert not [n for n in spans + names if n.startswith(PREFIXES)]
    assert {"train", "epoch 0", "epoch 1"} <= set(spans)


def test_switch_on_counts_each_span_as_the_loop_implies(
        graph, tmp_path, monkeypatch):
    out, before, after, _, _ = _run(graph, tmp_path, monkeypatch, on=True)
    assert trace.tracing()
    win = trace.window(before, after)
    counts = {n: s["count"] for n, s in win["spans"].items()}
    calls = 2 * _calls_per_epoch()
    for name in PER_CALL:
        assert counts[name] == calls, name
    for name in PER_EPOCH:
        assert counts[name] == 2, name
    # a train_step event (and its loss fetch) every LOG_EVERY steps
    assert counts["loop.loss_fetch"] == out["step"] // LOG_EVERY
    # no checkpoint, no evaluation, no graph on the CPU
    assert not {"loop.ckpt", "epoch.ckpt", "epoch.eval", "devrun.replay",
                "devrun.capture", "devrun.phases"} & set(counts)
    assert win["phases"]["steps"] == 0
    # the timer's buckets are its own: profiler ranges, no aggregate
    assert not {"loop.wait", "loop.call"} & set(counts)
    assert all(s["seconds"] > 0 for s in win["spans"].values())
    agg = after["spans"]["loop.heartbeat"]
    assert 0 < agg["max_s"] <= agg["seconds"]


def test_profiler_sees_the_loop_spans_nested(graph, tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    trainer = _trainer(graph, epochs=1)
    before = trace.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train()
    # the switch is off: the ranges are the profiler's alone
    assert trace.snapshot() == before
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append((e.time_range.start,
                                              e.time_range.end))

    def inside(inner, outer):
        return [any(a <= s and t <= b for a, b in ranges[outer])
                for s, t in ranges[inner]]

    assert len(ranges["train"]) == 1
    assert len(ranges["epoch 0"]) == 1
    assert len(ranges["loop.call"]) == _calls_per_epoch()
    assert all(inside("epoch 0", "train"))
    assert all(inside("epoch.permute", "train"))
    assert not any(inside("epoch.permute", "epoch 0"))
    for name in ("loop.wait", "loop.call", "loop.sentry", "loop.heartbeat",
                 "loop.loss_fetch", "epoch.drain", "epoch.losses",
                 "epoch.record"):
        assert all(inside(name, "epoch 0")), name
    assert all(inside("devrun.stage", "loop.wait"))
    assert all(inside("devrun.eager", "loop.call"))


def test_hot_span_off_is_one_shared_null_context():
    trace.configure({})
    assert trace.hot_span("a") is trace.hot_span("b")
    before = trace.snapshot()
    with trace.hot_span("a"):
        pass
    assert trace.snapshot() == before
    trace.configure({trace.TRACE_ENV: "1"})
    with trace.hot_span("test.spans.a"):
        pass
    with trace.hot_span("test.spans.b", aggregate=False):
        pass
    win = trace.window(before, trace.snapshot())
    assert set(win["spans"]) == {"test.spans.a"}
    assert win["spans"]["test.spans.a"]["count"] == 1
    trace.configure({trace.TRACE_ENV: "0"})
    assert not trace.tracing()


class _Event:
    """A completed timing event at ``ms`` (duck-typed CUDA event)."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_phase_clock_tiles_a_replay_between_its_marks():
    clock = PhaseClock(steps=2)
    # two steps: sample 1, model 2, sentry 0.5, update 1, sentry 0.25,
    # update 0.25 (ms), then the same again
    times, marks = [0.0], [(None, _Event(0.0))]
    for _ in range(2):
        for phase, ms in (("sample", 1.0), ("model", 2.0), ("sentry", 0.5),
                          ("update", 1.0), ("sentry", 0.25),
                          ("update", 0.25)):
            times.append(times[-1] + ms)
            marks.append((phase, _Event(times[-1])))
    clock.marks = marks
    before = trace.snapshot()
    clock.read(replays=0)                 # nothing replayed yet
    assert trace.snapshot() == before
    clock.read(replays=1)
    clock.read(replays=1)                 # the same replay, read once
    ph = trace.window(before, trace.snapshot())["phases"]
    assert ph["steps"] == 2
    assert ph["us"] == pytest.approx({"sample": 2000.0, "model": 4000.0,
                                      "sentry": 1500.0, "update": 2500.0})
    assert sum(ph["us"].values()) == pytest.approx(times[-1] * 1e3)
    # a replay still running is not read (and nothing waits for it)
    marks[-1] = ("update", _Event(times[-1], done=False))
    clock.read(replays=2)
    assert trace.window(before, trace.snapshot())["phases"]["steps"] == 2


def test_timer_bucket_is_a_profiler_range_and_the_timers_alone():
    from torch.profiler import ProfilerActivity, profile

    from dgl_operator_tpu_torch.runtime.timers import PhaseTimer

    trace.configure({trace.TRACE_ENV: "1"})
    timer = PhaseTimer()
    before = trace.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("sample", span="test.spans.wait"):
            pass
        with timer.phase("stall"):
            pass
    assert trace.snapshot() == before
    assert timer.count == {"sample": 1, "stall": 1}
    names = [e.name for e in prof.events()]
    assert names.count("test.spans.wait") == 1
    assert names.count("stall") == 1


def test_window_subtracts_two_snapshots():
    trace.configure({trace.TRACE_ENV: "1"})
    with trace.hot_span("test.spans.before"):
        pass
    before = trace.snapshot()
    for _ in range(3):
        with trace.hot_span("test.spans.c"):
            pass
    trace.add_phases({"sample": 30.0, "model": 60.0}, steps=2)
    after = trace.snapshot()
    win = trace.window(before, after)
    # names that did not run in the window are left out; a longest run
    # does not subtract
    assert "test.spans.before" not in win["spans"]
    assert set(win["spans"]["test.spans.c"]) == {"count", "seconds"}
    assert win["spans"]["test.spans.c"]["count"] == 3
    assert win["spans"]["test.spans.c"]["seconds"] == pytest.approx(
        after["spans"]["test.spans.c"]["seconds"]
        - before["spans"].get("test.spans.c", {"seconds": 0.0})["seconds"])
    assert win["phases"]["steps"] == 2
    assert win["phases"]["us"] == pytest.approx(
        {"sample": 30.0, "model": 60.0, "sentry": 0.0, "update": 0.0})
    assert trace.window(after, trace.snapshot()) == {
        "spans": {}, "phases": {"us": dict.fromkeys(trace.PHASES, 0.0),
                                "steps": 0}}


@pytest.mark.cuda
def test_phases_sum_to_the_replay_on_the_card(graph, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the phases are a captured graph's")
    monkeypatch.setenv(trace.TRACE_ENV, "1")
    trainer = _trainer(graph, device="cuda", epochs=1)
    inner = trainer.train_call
    seen = []

    def timed(batch):
        run = trainer._run
        if batch[2] == 1 or run.graphed.graph is None:
            # a single eager step, or the call that captures
            return inner(batch)
        graph = run.graphed.graph
        replay = graph.replay
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def timed_replay():
            # the card stays busy (about 1 ms) while the host launches
            # the graph, so the events around it time the replay's run
            # on the card and not its launch onto an idle card, which
            # lies before the first phase's mark
            torch.cuda._sleep(2_000_000)
            start.record()
            replay()
            end.record()

        torch.cuda.synchronize()
        before = trace.snapshot()
        graph.replay = timed_replay
        try:
            out = inner(batch)
        finally:
            del graph.replay
        torch.cuda.synchronize()
        run.read_phases()
        ph = trace.window(before, trace.snapshot())["phases"]
        seen.append((start.elapsed_time(end) * 1e3, ph))
        return out

    trainer.train_call = timed
    trainer.train()
    assert len(seen) == STEPS // K - 1        # the first call captures
    for outer_us, ph in seen:
        assert ph["steps"] == K
        assert all(v > 0 for v in ph["us"].values()), ph
        assert sum(ph["us"].values()) == pytest.approx(outer_us,
                                                       rel=0.05), \
            (outer_us, ph)
