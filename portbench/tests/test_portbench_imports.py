"""The import check: nothing the harness runs loads JAX or the JAX
package (top-level names compared whole), and the reference imports
nothing of the program."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness, spec

PY = sys.executable


def test_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "dgl_operator_tpu", "dgl_operator_tpu.ops"]) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "dgl_operator_tpu", "dgl_operator_tpu.ops"])
    assert harness.forbidden_modules(
        ["dgl_operator_tpu_torch", "dgl_operator_tpu_torch.ops",
         "jaxtyping", "flaxen", "portbench"]) == []


def test_what_the_harness_imports_is_free_of_jax():
    """In a fresh process: the harness, every cell's driver and model
    kind, every metric reader, the reference, and the program's modules
    the drivers use."""
    code = """
import importlib, json, sys
sys.path.insert(0, %r)
from portbench import harness, spec
for mod in harness.PROGRAM:
    importlib.import_module(mod)
bench = json.load(open(spec.BENCHMARK))
for w in bench["workloads"]:
    c = spec.load_cell(w["name"]); c.driver; c.kind
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.metric_reader(m["name"])
import portbench.reference.train, portbench.control
print(json.dumps(harness.forbidden_modules()))
""" % spec.ROOT
    out = subprocess.run([PY, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_without_a_card_passes_the_start_up_check():
    """The start-up check runs before the look for a card: here, with
    no card, the run exits 2 and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [PY, "portbench/run.py", "--workload", "sage_products.dev_k4",
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, env=env, timeout=120)
    assert out.returncode == 2, out.stderr
    assert out.stdout == ""
    assert "CUDA card" in out.stderr


def test_benchmark_alone_does_not_run(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ fails."""
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run(
        [PY, "portbench/run.py", "--workload", "sage_products.dev_k4",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(os.path.join(spec.HERE, "reference"))
    if n.endswith(".py")))
def test_reference_imports_nothing_of_the_program(name):
    with open(os.path.join(spec.HERE, "reference", name)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] in (
                "__future__", "contextlib", "typing", "torch", "numpy") \
                or mod.startswith("portbench.reference"), mod
