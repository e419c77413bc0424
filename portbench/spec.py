"""Finding a cell's files by name.

A cell ``<cell>`` is ``workloads/<cell>.json`` (its configuration's and
traffic's names, its ``why`` and the limits of its correctness
comparison); its configuration is ``configs/<config>.json``, its
traffic ``traffic/<traffic>.json``. The configuration's ``model.kind``
names ``models/<kind>.py``, the traffic's ``kind`` names
``drivers/<kind>.py``, and every metric is ``metrics/<metric>.py``.
Which metrics a cell reports comes from ``BENCHMARK.json`` at the root of
the checkout. Nothing here is edited when a cell, a configuration or a
metric is added: each is a file of its own.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import types
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")


def _json(*parts: str) -> Dict:
    path = os.path.join(HERE, *parts)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    why: str
    limits: Dict[str, float]

    @property
    def kind(self) -> types.ModuleType:
        return importlib.import_module(
            f"portbench.models.{self.config['model']['kind']}")

    @property
    def driver(self) -> types.ModuleType:
        return importlib.import_module(
            f"portbench.drivers.{self.traffic['kind']}")


def load_cell(name: str) -> Cell:
    cell = _json("workloads", name + ".json")
    config = _json("configs", cell["config"] + ".json")
    traffic = _json("traffic", cell["traffic"] + ".json")
    return Cell(name, cell["config"], config, cell["traffic"], traffic,
                cell["why"], dict(cell["limits"]))


def metric_reader(name: str) -> types.ModuleType:
    """``metrics/<name>.py``, loaded by its path (a metric's name may
    hold dots)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader metrics/{name}.py")
    mod_name = "portbench.metrics." + name.replace(".", "__")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(cell: str, trace: bool,
                 path: Optional[str] = None) -> List[str]:
    """The metrics ``BENCHMARK.json`` gives the cell: its ``per_layer``
    metrics in a traced run, else its ``end_to_end`` ones (a metric with
    a ``workloads`` list only where the list names the cell)."""
    with open(path or BENCHMARK) as f:
        bench = json.load(f)
    group = bench["per_layer" if trace else "end_to_end"]
    return [m["name"] for m in group
            if "workloads" not in m or cell in m["workloads"]]
