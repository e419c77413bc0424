"""The loader finds a configuration, a cell, a traffic mix, a model kind
and every metric by its file's name, and BENCHMARK.json keeps to the
benchmark's contract."""

import json
import os
import re

import pytest

from portbench import check, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
with open(spec.BENCHMARK) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    cell = spec.load_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert (cell.config_name, cell.traffic_name, cell.why) == (
        entry["config"], entry["traffic"], entry["why"])
    assert cell.config["name"] == cell.config_name
    assert cell.kind.__name__.endswith(cell.config["model"]["kind"])
    assert cell.driver.__name__.endswith(cell.traffic["kind"])
    assert set(cell.limits) <= set(check.ORDER)
    assert {"mask_gap", "rows_gap", "loss_gap"} <= set(cell.limits)
    assert {"grad_gap", "grad_median_gap"} & set(cell.limits)
    assert {"delta_gap", "delta_median_gap"} & set(cell.limits)
    assert cell.limits["mask_gap"] == cell.limits["rows_gap"] == 0
    assert cell.traffic["chips"] == entry["chips"]


def test_missing_files_are_named():
    with pytest.raises(FileNotFoundError, match="workloads/nope.json"):
        spec.load_cell("nope")
    with pytest.raises(FileNotFoundError, match="metrics/nope.py"):
        spec.metric_reader("nope")


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metric_readers(group):
    for m in BENCH[group]:
        reader = spec.metric_reader(m["name"])
        assert reader.UNIT == m["unit"]
        assert reader.SOURCE == m["source"]
        if group == "per_layer":
            assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])


def test_cell_metrics_follow_the_workloads_key(tmp_path):
    path = tmp_path / "b.json"
    path.write_text(json.dumps({
        "end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
        "per_layer": [{"name": "c", "workloads": ["y"]}]}))
    assert spec.cell_metrics("x", False, str(path)) == ["a", "b"]
    assert spec.cell_metrics("y", False, str(path)) == ["a"]
    assert spec.cell_metrics("y", True, str(path)) == ["c"]


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(spec.BENCHMARK) <= 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(spec.ROOT, c["file"]))
        assert c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for cell in CELLS:
        assert len(spec.cell_metrics(cell, False)) >= 2
        assert spec.cell_metrics(cell, True)
