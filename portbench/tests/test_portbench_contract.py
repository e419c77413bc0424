"""The result line and the metric readers: a tiny CPU run through the
harness prints the keys in the contract's order, the compared numbers
last on both streams, and each reader reads what it should (or
nothing)."""

import json

import pytest
import torch

from portbench import data, harness, spec
from portbench.tests.tiny import CELLS, tiny_cell

E2E = ["samples_per_s", "peak_mem_gib", "setup_s"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(data, "CACHE", str(tmp_path))
    name = CELLS[0]
    metrics = spec.cell_metrics(name, trace)
    res = harness.run_cell(name, 2**31 + 3, 0.5, trace, "cpu", 0.0,
                           cell=tiny_cell(name, batch=128))
    harness.emit(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m, v in line["metrics"].items():
        assert m in metrics
        assert isinstance(v["value"], float) and v["unit"]
    if trace:
        # a CPU run has no device trace: only the host's spans read (an
        # epoch of 14 steps: the window crosses its boundaries)
        assert set(line["metrics"]) == {"host_ms_per_call",
                                        "epoch_end_ms"}
    else:
        assert set(line["metrics"]) == {"samples_per_s", "setup_s"}
    tail = err.strip().splitlines()[-len(line["compared"]):]
    for row, (k, v) in zip(tail, line["compared"].items()):
        assert row == f"compared {k} {v['value']} limit {v['limit']}"


def _ctx(**kw):
    base = {"setup_s": 12.5, "window_s": 2.0, "samples": 1_000_000,
            "steps": 1000, "host_call_ms": [1.0, 2.0, 3.0],
            "epoch_end_ms": [50.0, 100.0, 150.0],
            "call_gap_ms": [float(i) for i in range(1, 201)],
            "peak_bytes": 3 * 2**30, "precision": "float32", "on_card": True,
            "step_flops": 6.7e9, "port_least_s": 0.5,
            "trace": {"busy_s": 0.75, "window_s": 1.0, "steps": 100,
                      "by_kind_us": {"cublas": 2000.0, "plain": 5000.0,
                                     "gather_rows": 4e5,
                                     "fanout_agg": 3e5,
                                     "scatter_add_rows": 3e5}}}
    base.update(kw)
    return base


def _read(name, **kw):
    return spec.metric_reader(name).read(_ctx(**kw))


def test_readers():
    assert _read("samples_per_s") == 500_000
    assert _read("peak_mem_gib") == 3.0
    assert _read("setup_s") == 12.5
    assert _read("host_ms_per_call") == 2.0
    assert _read("epoch_end_ms") == 100.0
    assert _read("call_ms_p95") == pytest.approx(190.95)
    # 7.5 ms busy a traced step; 1000 window steps in 10 s
    assert _read("device_idle_pct", window_s=10.0) == pytest.approx(25.0)
    # 6.7e9 FLOPs a step, 500 steps a second, over 67e12: 5%
    assert _read("train_mfu") == pytest.approx(5.0)
    assert _read("cublas_us_per_step") == 20.0
    assert _read("plain_us_per_step") == 50.0
    # 0.5 s of least time over 1 s of the port's kernels
    assert _read("port_kernels_roofline") == pytest.approx(50.0)


def test_readers_find_nothing_and_say_nothing():
    assert _read("call_ms_p95", call_gap_ms=[1.0] * 199) is None
    for name in ("device_idle_pct", "cublas_us_per_step",
                 "plain_us_per_step", "port_kernels_roofline"):
        assert _read(name, trace=None) is None
    assert _read("port_kernels_roofline", port_least_s=None) is None
    assert _read("train_mfu", step_flops=None) is None
    assert _read("train_mfu", on_card=False) is None
    assert _read("peak_mem_gib", peak_bytes=0) is None


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                       "1", "--trace", "0"], 0.0)
    out, err = capsys.readouterr()
    assert rc == 2 and out == "" and "CUDA card" in err
