"""The port stands alone: no module of ``dgl_operator_tpu_torch``,
neither ``chip_smoke.py`` nor ``leaky_branch_probe.py``, imports JAX,
its libraries or the JAX package, or names a file of the JAX package
to compile or load (the port builds its own graph core and kernels from
its own sources), and no entry point runs on the CPU unless asked
to."""

import ast
import ctypes
import os
import re
import subprocess
import sys

import pytest
import torch

from dgl_operator_tpu_torch import resolve_device
from dgl_operator_tpu_torch.graph import _native
from dgl_operator_tpu_torch.ops import _build
from dgl_operator_tpu_torch.examples import (graph_classification,
                                             graphsage, link_predict,
                                             link_predict_rgcn,
                                             message_passing, train_dist,
                                             train_kge)
from dgl_operator_tpu_torch.models.kge import KGEConfig
from dgl_operator_tpu_torch.runtime.dist import DistTrainer
from dgl_operator_tpu_torch.runtime.kge import (DistKGETrainer,
                                                KGETrainConfig, KGETrainer)
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig
from dgl_operator_tpu_torch.serve import server as serve_server
from dgl_operator_tpu_torch.serve.engine import ServeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "dgl_operator_tpu_torch")
JAX_TREE = os.path.join(REPO, "dgl_operator_tpu") + os.sep
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dgl_operator_tpu")
# the JAX package's name as a path component, not the port's
JAX_PATH = re.compile(r"dgl_operator_tpu(?!_torch)\b")
# what chip_smoke.py may name: the TPU kernel each CUDA kernel replaces
REPLACES_LABEL = re.compile(r"^dgl_operator_tpu/ops/pallas_gather\.py(:\d+)?$")


def _port_sources():
    paths = [os.path.join(REPO, f)
             for f in ("chip_smoke.py", "leaky_branch_probe.py")]
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


def _string_constants(path):
    """Every string literal of ``path`` but its docstrings."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docs.add(id(first.value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.value


def test_port_sources_name_no_jax_file_to_build_or_load():
    bad = [(os.path.relpath(p, REPO), text)
           for p in _port_sources() for text in _string_constants(p)
           if JAX_PATH.search(text) and not (
               p.endswith("chip_smoke.py") and REPLACES_LABEL.match(text))]
    assert bad == []
    natives = []
    for root, _, files in os.walk(PORT):
        natives += [os.path.join(root, f) for f in files
                    if f.endswith((".cc", ".cu", ".h", ".cuh"))]
    assert os.path.join(PORT, "native", "graphcore.cc") in natives
    for path in natives:
        with open(path) as f:
            includes = [ln for ln in f if ln.lstrip().startswith("#include")]
        assert not [ln for ln in includes if JAX_PATH.search(ln)], path


def test_graph_core_is_built_from_the_port_source(tmp_path, monkeypatch):
    """A fresh build compiles ``native/graphcore.cc`` of the port into
    the build directory and loads that library, nothing else."""
    commands, loaded = [], []
    real_run, real_cdll = subprocess.run, ctypes.CDLL

    def run(cmd, *a, **kw):
        commands.append(list(cmd))
        return real_run(cmd, *a, **kw)

    def cdll(path, *a, **kw):
        loaded.append(path)
        return real_cdll(path, *a, **kw)

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    _native.library()
    assert len(commands) == 1 and len(loaded) == 1
    cmd = commands[0]
    assert cmd[-1] == os.path.join(PORT, "native", "graphcore.cc")
    assert not [a for a in cmd if a.startswith(JAX_TREE)]
    assert os.path.dirname(loaded[0]) == str(tmp_path)
    for d in (_build.CSRC, _build.NATIVE):
        assert d.startswith(PORT + os.sep)


def test_port_run_maps_no_file_of_the_jax_package():
    """Sampling and partitioning through the port map its own graph
    core and no file of the JAX package (its gitignored build output
    included)."""
    code = (
        "import numpy as np\n"
        "from dgl_operator_tpu_torch.graph import blocks, datasets, "
        "partition\n"
        "g = datasets.synthetic_node_clf(200, 900, 4, 3, seed=1).graph\n"
        "blocks.build_fanout_blocks(g.csc(), np.arange(8), (3, 4))\n"
        "partition.multilevel_partition(g, 2)\n"
        "maps = open('/proc/self/maps').read().split('\\n')\n"
        "print('\\n'.join(sorted({ln.split()[-1] for ln in maps\n"
        "                          if ln.endswith('.so')})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    mapped = proc.stdout.split()
    assert [p for p in mapped if "graphcore" in p
            and p.startswith(os.path.join(PORT, "_build") + os.sep)]
    assert not [p for p in mapped if p.startswith(JAX_TREE)]


def test_importing_the_port_loads_no_jax():
    code = ("import sys, dgl_operator_tpu_torch, "
            "dgl_operator_tpu_torch.serve.engine, "
            "dgl_operator_tpu_torch.serve.batcher, "
            "dgl_operator_tpu_torch.serve.server, "
            "dgl_operator_tpu_torch.serve.router, "
            "dgl_operator_tpu_torch.obs.quality, "
            "dgl_operator_tpu_torch.obs.slo, "
            "dgl_operator_tpu_torch.obs.live, "
            "dgl_operator_tpu_torch.obs.tracectx, "
            "dgl_operator_tpu_torch.autotune.knobs, "
            "dgl_operator_tpu_torch.runtime.loop, "
            "dgl_operator_tpu_torch.runtime.dist, "
            "dgl_operator_tpu_torch.runtime.checkpoint, "
            "dgl_operator_tpu_torch.parallel.dp, "
            "dgl_operator_tpu_torch.parallel.halo, "
            "dgl_operator_tpu_torch.parallel.bootstrap, "
            "dgl_operator_tpu_torch.parallel.collectives, "
            "dgl_operator_tpu_torch.examples.train_dist, "
            "dgl_operator_tpu_torch.examples.train_kge, "
            "dgl_operator_tpu_torch.examples.partition_kg, "
            "dgl_operator_tpu_torch.runtime.kge, "
            "dgl_operator_tpu_torch.parallel.embedding, "
            "dgl_operator_tpu_torch.ops.adagrad, "
            "dgl_operator_tpu_torch.ops.gather, "
            "dgl_operator_tpu_torch.ops.spmm, "
            "dgl_operator_tpu_torch.ops.sddmm, "
            "dgl_operator_tpu_torch.ops.segment, "
            "dgl_operator_tpu_torch.nn.predictors, "
            "dgl_operator_tpu_torch.models.link_predict, "
            "dgl_operator_tpu_torch.examples.message_passing, "
            "dgl_operator_tpu_torch.examples.link_predict, "
            "dgl_operator_tpu_torch.examples.graphsage, "
            "dgl_operator_tpu_torch.models.rgcn, "
            "dgl_operator_tpu_torch.models.gin, "
            "dgl_operator_tpu_torch.examples.link_predict_rgcn, "
            "dgl_operator_tpu_torch.examples.graph_classification, "
            "dgl_operator_tpu_torch.examples.load_and_partition_graph, "
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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistTrainer(None, "no-such-book.json", TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_dist.main(["--graph_name", "g", "--ip_config", "no-such-hosts",
                         "--part_config", "no-such-book.json"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KGETrainer(KGEConfig(), KGETrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistKGETrainer(KGEConfig(), KGETrainConfig(), num_slots=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_kge.main(["--part_config", "no-such-book.json"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_server.main(["--part-config", "no-such-book.json",
                           "--params", "no-such-export.npz"])
    for example in (graphsage, link_predict, message_passing,
                    link_predict_rgcn, graph_classification):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.main(["--num_epochs", "1"])
    assert resolve_device("cpu") == torch.device("cpu")
