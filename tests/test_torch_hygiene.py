"""The port stands alone: no module of ``dgl_operator_tpu_torch`` and
not ``chip_smoke.py`` imports JAX, its libraries or the JAX package,
and no entry point runs on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from dgl_operator_tpu_torch import resolve_device
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig
from dgl_operator_tpu_torch.serve.engine import ServeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dgl_operator_tpu")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO,
                                               "dgl_operator_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_nothing_of_jax():
    sources = _port_sources()
    assert len(sources) > 15
    bad = [(os.path.relpath(p, REPO), name)
           for p in sources for name in _imported_roots(p)
           if name.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    code = ("import sys, dgl_operator_tpu_torch, "
            "dgl_operator_tpu_torch.serve.engine, "
            "dgl_operator_tpu_torch.serve.batcher, "
            "dgl_operator_tpu_torch.runtime.loop, "
            "dgl_operator_tpu_torch.ops.gather, "
            "dgl_operator_tpu_torch.ops.spmm, "
            "dgl_operator_tpu_torch.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(None, "no-such-book.json", params={})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SampledTrainer(None, None, TrainConfig())
    assert resolve_device("cpu") == torch.device("cpu")
