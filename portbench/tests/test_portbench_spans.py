"""The readers of the program's spans and phase counters
(``metrics/{permute_ms,...}.py``, ``spans.py``) on a synthetic ``ctx``,
and ``spans.idle_by_span`` on synthetic profiler events."""

import pytest

from portbench import spans, spec
from portbench.devtrace import RANGE

READERS = ("permute_ms", "stage_ms", "loss_fetch_ms", "obs_us_per_call",
           "sampler_us_per_step", "model_us_per_step", "update_us_per_step",
           "sentry_us_per_step", "idle_unspanned_pct")
CTX = {"calls": 10,
       "program_spans": {"epoch.permute": {"count": 2, "seconds": 0.12},
                         "devrun.stage": {"count": 2, "seconds": 0.03},
                         "loop.loss_fetch": {"count": 4, "seconds": 0.08},
                         "loop.sentry": {"count": 10, "seconds": 0.004},
                         "loop.heartbeat": {"count": 10, "seconds": 0.002}},
       "program_phases": {"us": {"sample": 3000.0, "model": 6000.0,
                                 "sentry": 0.0, "update": 800.0},
                          "steps": 10},
       "trace": {"busy_s": 1.0,
                 "idle_by_span": {"loop.sentry": 0.003, "none": 0.0005,
                                  "epoch 3": 0.0005, "devrun.replay": 0.001}}}


def test_readers_of_a_window():
    got = {m: spec.metric_reader(m).read(CTX) for m in READERS}
    assert got["permute_ms"] == pytest.approx(60.0)
    assert got["stage_ms"] == pytest.approx(15.0)
    assert got["loss_fetch_ms"] == pytest.approx(20.0)
    # the tap and the heartbeat over the calls; no checkpoint ran
    assert got["obs_us_per_call"] == pytest.approx(600.0)
    assert got["sampler_us_per_step"] == pytest.approx(300.0)
    assert got["model_us_per_step"] == pytest.approx(600.0)
    assert got["update_us_per_step"] == pytest.approx(80.0)
    # the sentry off: its phase reads nothing
    assert got["sentry_us_per_step"] is None
    # idle under no dotted span: "none" and the epoch's range
    assert got["idle_unspanned_pct"] == pytest.approx(20.0)


@pytest.mark.parametrize("ctx", [
    {},                                               # a parent's run
    {"calls": 10, "trace": {"busy_s": 1.0}},          # a traced parent
    {"calls": 0, "program_spans": {},                 # nothing ran
     "program_phases": {"us": dict.fromkeys(
         ("sample", "model", "sentry", "update"), 0.0), "steps": 0},
     "trace": {"idle_by_span": {}}}])
def test_readers_read_nothing_without_their_keys(ctx):
    for m in READERS:
        reader = spec.metric_reader(m)
        assert reader.read(ctx) is None, m
        assert (reader.UNIT, reader.MOVES) == (
            "ms" if m.endswith("_ms") else "%" if m.endswith("pct")
            else "us", "samples_per_s")


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _ProfEvent:
    def __init__(self, name, start, end, device):
        from torch.autograd import DeviceType

        self.name = name
        self.time_range = _Range(start, end)
        self.device_type = getattr(DeviceType, device)
        self.is_user_annotation = False


EVENTS = [_ProfEvent(RANGE, 0, 10_000, "CPU"),
          _ProfEvent("epoch 3", 0, 10_000, "CPU"),
          _ProfEvent("loop.call", 0, 3_000, "CPU"),
          _ProfEvent("devrun.replay", 500, 1_000, "CPU"),
          _ProfEvent("aten::copy_", 6_000, 6_500, "CPU"),
          _ProfEvent("loop.sentry", 5_000, 7_000, "CPU"),
          # the device: busy 1,000-4,000 and 8,000-9,000 µs
          _ProfEvent("kernel_a", 1_000, 4_000, "CUDA"),
          _ProfEvent("kernel_b", 8_000, 9_000, "CUDA")]


def test_idle_by_span_names_the_innermost_program_span():
    by_span = spans.idle_by_span(EVENTS)
    assert by_span == pytest.approx({
        "loop.call": 500e-6, "devrun.replay": 500e-6,
        "epoch 3": 1_000e-6 + 1_000e-6 + 1_000e-6,
        "loop.sentry": 2_000e-6})
    assert list(by_span)[0] == "epoch 3"
    # idle 0-1,000, 4,000-8,000 and 9,000-10,000 µs: all of 1 ms or more
    gaps = spans.long_gaps(EVENTS)
    assert [round(g) for g, _ in gaps] == [4, 1, 1]
    assert gaps[0][1] == pytest.approx({"epoch 3": 2.0, "loop.sentry": 2.0})
    assert spans.unspanned_pct(by_span) == pytest.approx(50.0)
    # a trace without the range holds nothing to read
    assert spans.idle_by_span(EVENTS[1:]) == {}
