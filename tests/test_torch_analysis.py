"""The port's lint (``dgl_operator_tpu_torch.analysis``) held against the
JAX package's (``dgl_operator_tpu.analysis``) on the same inputs.

- The core (suppressions, baseline, reports, the CLI) and the rules
  whose meaning the port keeps (TPU004–TPU006) run the JAX package's
  own fixtures (``tests/test_analysis.py``) through both packages: the
  reports must be equal but for a message naming its own package.
- TPU001–TPU003 change meaning in torch (capture for trace, the
  process group's issue order for the rendezvous, a tensor lent to an
  async collective for a donated buffer), so each JAX fixture has a
  torch counterpart written line for line, and both packages must flag
  the same lines.
- The gate: the port's surface lints clean against its committed empty
  baseline, under both packages' rules.
- The key catalogue and the four knob sites that delegate to the
  port's registry give what the JAX package gives.
"""

import json
import os
import re
import subprocess
import sys

import pytest

import test_analysis as J
from dgl_operator_tpu import benchkeys as jax_keys
from dgl_operator_tpu.analysis import cli as jax_cli
from dgl_operator_tpu.analysis import core as jax_core
from dgl_operator_tpu.analysis import rules as jax_rules
from dgl_operator_tpu_torch import benchkeys as port_keys
from dgl_operator_tpu_torch.analysis import cli as port_cli
from dgl_operator_tpu_torch.analysis import core as port_core
from dgl_operator_tpu_torch.analysis import rules as port_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_BASELINE = os.path.join(REPO, "dgl_operator_tpu_torch", "analysis",
                             "baseline.json")

pytestmark = pytest.mark.analysis

PKGS = {"jax": (jax_core, jax_rules, jax_cli),
        "port": (port_core, port_rules, port_cli)}

# one explicit knob set for both TPU004 rules, so neither registry's
# extra knobs decide a finding
KNOBS = frozenset(("sampler", "feats_layout", "halo_cache_frac",
                   "steps_per_call", "resume", "cap_policy",
                   "refine_iters", "shard_rules"))


def _rules(pkg, code):
    _, rules, _ = PKGS[pkg]
    if code is None:
        return None
    if code == "TPU004":
        return [rules.KnobRegistryBypassRule(KNOBS)]
    return [rules.rule_by_code(code)]


def lint(pkg, root, source, code=None, docs=None, name="fixture.py"):
    """One fixture module under ``root`` (plus optional docs pages),
    linted by one package with one rule (or its whole pack)."""
    core = PKGS[pkg][0]
    (root / name).write_text(source)
    if docs is not None:
        d = root / "docs"
        d.mkdir(exist_ok=True)
        (d / "observability.md").write_text(docs)
    return core.run_lint(paths=[name], root=str(root),
                         rules=_rules(pkg, code))


def norm(obj):
    """A report or text with the port's package name read as the JAX
    one's: the only place the two packages' reports may differ."""
    return json.loads(json.dumps(obj).replace("dgl_operator_tpu_torch",
                                              "dgl_operator_tpu"))


def both(tmp_path, source, code=None, docs=None):
    """Lint one fixture through both packages from one root; return the
    two report dicts."""
    out = []
    for pkg in PKGS:
        out.append(lint(pkg, tmp_path, source, code, docs).as_dict())
    return out


def lines(report):
    return sorted((f.rule, f.line, f.col) for f in report.findings)


# ----------------------------------------------- the core, TPU004-006
SAME_MEANING = [
    ("BAD_KNOB", J.BAD_KNOB, "TPU004", None, 2),
    ("GOOD_KNOB", J.GOOD_KNOB, "TPU004", None, 0),
    ("BAD_SUBPROC", J.BAD_SUBPROC, "TPU005", None, 2),
    ("GOOD_SUBPROC", J.GOOD_SUBPROC, "TPU005", None, 0),
    ("BAD_KEYS", J.BAD_KEYS, "TPU006", J.DOCS, 3),
    ("GOOD_KEYS", J.GOOD_KEYS, "TPU006", J.DOCS, 0),
    ("BAD_KEYS_no_docs", J.BAD_KEYS, "TPU006", None, 1),
    ("BAD_SUBPROC_whole_pack", J.BAD_SUBPROC, None, None, 2),
    ("BAD_KNOB_whole_pack", J.BAD_KNOB, None, None, 2),
]


@pytest.mark.parametrize("source,code,docs,n", [c[1:] for c in SAME_MEANING],
                         ids=[c[0] for c in SAME_MEANING])
def test_tpu004_to_006_same_findings_in_both(tmp_path, source, code, docs,
                                             n):
    reps = {pkg: lint(pkg, tmp_path, source, code, docs) for pkg in PKGS}
    assert len(reps["jax"].findings) == n
    assert lines(reps["port"]) == lines(reps["jax"])
    assert norm(reps["port"].as_dict()) == reps["jax"].as_dict()


SUPPRESS_SOURCES = [
    "x = 1  # tpu-lint: disable=TPU001,TPU002\n"
    "# tpu-lint: disable\n"
    "y = 2\n",
    "a = 1  # tpu-lint: disable=TPU004\n"
    "    # tpu-lint: disable=TPU005, TPU006\n"
    "b = 2  # tpu-lint: disable=TPU005\n"
    "c = 3  # tpu-lint:disable\n",
    "no = 'suppression'\n# tpu-lint: enable=TPU001\n",
]


@pytest.mark.parametrize("source", SUPPRESS_SOURCES)
def test_suppressed_lines_parse_alike(source):
    assert (port_core.suppressed_lines(source)
            == jax_core.suppressed_lines(source))


SUPPRESSED_FIXTURES = [
    """
import subprocess

def go(cmd):
    subprocess.run(cmd)   # tpu-lint: disable=TPU005
    # tpu-lint: disable=TPU005
    subprocess.run(cmd)
    subprocess.run(cmd)   # tpu-lint: disable
""",
    "import subprocess\nsubprocess.run(['x'])  # tpu-lint: disable=TPU001\n",
]


@pytest.mark.parametrize("source", SUPPRESSED_FIXTURES)
def test_suppression_reports_alike(tmp_path, source):
    reps = {pkg: lint(pkg, tmp_path, source, "TPU005") for pkg in PKGS}
    assert norm(reps["port"].as_dict()) == reps["jax"].as_dict()
    assert len(reps["port"].suppressed) == len(reps["jax"].suppressed)


def test_baseline_round_trip_alike(tmp_path):
    """The JAX package's baseline sequence through both packages: the
    same baseline file, then the same report at every step."""
    seen = {}
    for pkg, (core, rules, _) in PKGS.items():
        root = tmp_path / pkg
        root.mkdir()
        (root / "fixture.py").write_text(J.BAD_SUBPROC)
        base = str(root / "baseline.json")
        rule = [rules.rule_by_code("TPU005")]
        steps = [core.run_lint(paths=["fixture.py"], root=str(root),
                               rules=rule)]
        core.write_baseline(base, steps[0].findings)
        with open(base) as f:
            written = json.load(f)
        n_loaded = len(core.load_baseline(base))
        steps.append(core.run_lint(paths=["fixture.py"], root=str(root),
                                   rules=rule, baseline_path=base))
        (root / "fresh.py").write_text(
            "import subprocess\nsubprocess.call(['x'])\n")
        steps.append(core.run_lint(paths=["fixture.py", "fresh.py"],
                                   root=str(root), rules=rule,
                                   baseline_path=base))
        (root / "fixture.py").write_text("\n\n\n" + J.BAD_SUBPROC)
        steps.append(core.run_lint(paths=["fixture.py"], root=str(root),
                                   rules=rule, baseline_path=base))
        seen[pkg] = (written, n_loaded,
                     [(r.exit_code, len(r.findings), len(r.baselined),
                       [f.path for f in r.findings]) for r in steps])
    assert seen["port"] == seen["jax"]
    assert seen["jax"][2] == [(1, 2, 0, ["fixture.py", "fixture.py"]),
                              (0, 0, 2, []), (1, 1, 2, ["fresh.py"]),
                              (0, 0, 2, [])]


@pytest.mark.parametrize("payload", [
    json.dumps({"version": 99, "findings": []}),
    json.dumps({"findings": []}),
    "{\"version\": 1, \"findings\": [",
])
def test_malformed_baseline_fails_alike(tmp_path, payload):
    base = tmp_path / "baseline.json"
    base.write_text(payload)
    errors = []
    for core, _, _ in PKGS.values():
        with pytest.raises(ValueError) as ei:
            core.load_baseline(str(base))
        errors.append((type(ei.value), str(ei.value)))
    assert errors[0] == errors[1]
    assert jax_core.load_baseline(str(tmp_path / "missing.json")) == {}
    assert port_core.load_baseline(str(tmp_path / "missing.json")) == {}


@pytest.mark.parametrize("source", ["def broken(:\n", "x = (\n",
                                    "\tif x:\n  pass\n"])
def test_unparsable_file_alike(tmp_path, source):
    reps = [lint(pkg, tmp_path, source, name="broken.py") for pkg in PKGS]
    assert reps[0].exit_code == 1 and reps[0].errors[0].rule == "TPU000"
    assert norm(reps[1].as_dict()) == reps[0].as_dict()


def test_json_report_schema_alike(tmp_path):
    jax, port = both(tmp_path, J.BAD_SUBPROC, "TPU005")
    assert sorted(port) == ["counts", "errors", "files_checked",
                            "findings", "root", "version"]
    assert sorted(port["findings"][0]) == ["col", "line", "message",
                                           "path", "rule"]
    assert port["counts"] == {"findings": 2, "baselined": 0,
                              "suppressed": 0, "errors": 0}
    assert json.loads(json.dumps(port)) == port
    assert norm(port) == jax


def _cli(pkg, argv, capsys):
    rc = PKGS[pkg][2].main(argv)
    return rc, capsys.readouterr().out


def test_cli_rc_write_baseline_and_json_alike(tmp_path, capsys):
    (tmp_path / "fixture.py").write_text(J.BAD_SUBPROC)
    root = ["--root", str(tmp_path)]
    runs = {}
    for pkg in PKGS:
        runs[pkg] = [
            _cli(pkg, ["fixture.py", *root, "--no-baseline"], capsys),
            _cli(pkg, ["fixture.py", *root, "--no-baseline", "--json"],
                 capsys)]
        rc, _ = _cli(pkg, ["fixture.py", *root, "--write-baseline"], capsys)
        runs[pkg].append((rc, None))
        runs[pkg].append(_cli(pkg, ["fixture.py", *root], capsys))
    assert [rc for rc, _ in runs["port"]] == [1, 1, 0, 0]
    assert [rc for rc, _ in runs["jax"]] == [1, 1, 0, 0]
    assert "TPU005" in runs["port"][0][1] and "fixture.py:5" in runs[
        "port"][0][1]
    assert norm(runs["port"][0][1]) == runs["jax"][0][1]
    assert norm(json.loads(runs["port"][1][1])) == json.loads(
        runs["jax"][1][1])
    # each package writes its own default baseline, the same findings
    with open(tmp_path / "dgl_operator_tpu" / "analysis"
              / "baseline.json") as f:
        jax_base = json.load(f)
    with open(tmp_path / "dgl_operator_tpu_torch" / "analysis"
              / "baseline.json") as f:
        port_base = json.load(f)
    assert len(port_base["findings"]) == 2
    assert port_base == jax_base


def test_cli_usage_errors_alike(tmp_path, capsys):
    (tmp_path / "fixture.py").write_text(J.BAD_SUBPROC)
    bad = tmp_path / "bad_baseline.json"
    bad.write_text(json.dumps({"version": 99}))
    argv = ["fixture.py", "--root", str(tmp_path), "--baseline", str(bad)]
    assert jax_cli.main(argv) == port_cli.main(argv) == 2
    for pkg in PKGS:
        with pytest.raises(SystemExit) as ei:
            PKGS[pkg][2].main(["--no-such-flag"])
        assert ei.value.code == 2
    capsys.readouterr()


def test_cli_list_rules_alike(capsys):
    listed = {}
    for pkg in PKGS:
        rc, out = _cli(pkg, ["--list-rules"], capsys)
        assert rc == 0
        listed[pkg] = re.findall(r"^(TPU\d{3}) (\S+)$", out, re.M)
    assert listed["port"] == listed["jax"]
    assert [c for c, _ in listed["port"]] == [f"TPU00{i}"
                                              for i in range(1, 7)]


def test_module_entry_point_exits_1_on_a_bad_fixture(tmp_path):
    """``python -m dgl_operator_tpu_torch.analysis`` (the clean rc 0 is
    the in-process CLI's, above)."""
    (tmp_path / "bad.py").write_text(J.BAD_SUBPROC)
    proc = subprocess.run(
        [sys.executable, "-m", "dgl_operator_tpu_torch.analysis", "bad.py",
         "--root", str(tmp_path), "--json"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 1, proc.stderr
    report = json.loads(proc.stdout)
    assert report["files_checked"] == 1
    assert report["counts"]["findings"] == 2


# ------------------------------------------- TPU001-003, paired fixtures
# each torch fixture is its JAX one written line for line: the same
# lines must be flagged

PORT_BAD_JIT = """
import time
import random
import numpy as np
import torch

@torch.compile
def step(x):
    t = time.time()
    print("step", t)
    return x + random.random() + np.random.rand()
"""

PORT_GOOD_JIT = """
import time
import torch
import torch.nn.functional as F

@torch.compile
def step(x, gen):
    return x + torch.rand(1, generator=gen)

def host_loop(x, gen):
    t0 = time.time()          # host side: clocks are fine here
    out = step(x, gen)
    print("took", time.time() - t0)
    return out
"""

JAX_JIT_VARIANT = """
import time
from functools import partial
import jax
from dgl_operator_tpu.parallel.mesh import shard_map

def loss_fn(params, batch):
    return params, time.perf_counter()

def build(mesh):
    f = shard_map(loss_fn, mesh=mesh)
    return f

@partial(jax.jit, donate_argnums=(0,))
def step(x):
    import numpy as np
    return np.random.permutation(x)
"""

PORT_JIT_VARIANT = """
import time
from functools import partial
import torch
from dgl_operator_tpu_torch.runtime.graphs import DeviceRun

def loss_fn(seeds, gstep):
    return seeds, time.perf_counter()

def build(device):
    run = DeviceRun(loss_fn, 2, (4, 1, 8), torch.int64, 4, device, True)
    return run

@partial(torch.compile, mode="reduce-overhead")
def step(x):
    import numpy as np
    return np.random.permutation(x)
"""

PORT_BAD_THREAD = """
import threading
from dgl_operator_tpu_torch.parallel.halo import alltoall_request_rows

def train(store, req, rows, pool):
    exchange_fn = alltoall_request_rows
    t = threading.Thread(target=lambda: exchange_fn(store, req, rows))
    t.start()
    pool.submit(exchange_fn, store, req, rows)
"""

PORT_GOOD_THREAD = """
import threading
import torch
from dgl_operator_tpu_torch.parallel.halo import alltoall_request_rows

def watch_ready(event):
    event.synchronize()             # observes only, never launches

def train(store, req, rows, pool):
    exchange_fn = alltoall_request_rows
    recv = exchange_fn(store, req, rows)   # loop-thread issue: fine
    pool.submit(watch_ready, recv)
    threading.Thread(target=watch_ready, args=(recv,)).start()
"""

JAX_CLOSURE = """
import threading
import jax

def inner(x):
    return jax.lax.psum(x, "dp")

def outer(x):
    return inner(x)

threading.Thread(target=outer).start()
"""

PORT_CLOSURE = """
import threading
import torch.distributed as dist

def inner(x):
    return dist.all_reduce(x)

def outer(x):
    return inner(x)

threading.Thread(target=outer).start()
"""

PORT_BAD_START_DONE = """
from dgl_operator_tpu_torch.parallel.halo import (request_rows_finish,
                                                  request_rows_start)

def fused_step(store, req, rows, params, batch, loss_fn):
    handle = request_rows_start(store, req, rows, async_op=True)
    recv = request_rows_finish(handle)   # finish next to start
    loss = loss_fn(params, batch, recv)
    return loss
"""

PORT_GOOD_START_DONE = """
from dgl_operator_tpu_torch.parallel.halo import (request_rows_finish,
                                                  request_rows_start)

def fused_step(store, req, rows, params, batch, loss_fn):
    handle = request_rows_start(store, req, rows, async_op=True)
    loss = loss_fn(params, batch)        # the compute the a2a hides under
    recv = request_rows_finish(handle)
    return loss, recv
"""

MIXED_START_DONE = """
def run(a_start, b_done):
    h = a_start()
    r = b_done(h)
    return r
"""

PORT_BAD_DONATE = """
import torch.distributed as dist

def train(params, grads, batch, loss_fn):
    loss = loss_fn(params, batch)
    work = dist.all_reduce(grads, async_op=True)
    return grads, loss, work   # grads still lent to the all-reduce
"""

PORT_GOOD_DONATE = """
import torch.distributed as dist

def train(params, grads, batch, loss_fn):
    work = dist.all_reduce(grads, async_op=True)
    work.wait()
    return grads, loss_fn(params, batch)   # waited: the reduced buffer

def synchronous(params, grads, batch, loss_fn):
    loss = loss_fn(params, batch)
    work = dist.all_reduce(grads, async_op=False)
    return grads, loss, work   # async_op=False: done on return
"""

JAX_EXCHANGE = """
from dgl_operator_tpu.runtime.forward import build_halo_exchange_fn

def stage(mesh, feats, ebatch):
    exchange = build_halo_exchange_fn(mesh)
    recv = exchange(feats, ebatch)
    return recv, ebatch["exch_req"]     # donated table read back
"""

PORT_EXCHANGE = """
from dgl_operator_tpu_torch.parallel.halo import request_rows_start

def stage(store, req, rows):
    per_slot = int(rows)
    handle = request_rows_start(store, req, per_slot, async_op=True)
    return handle, req[0]     # the request table read while lent
"""

PAIRED = [
    # (id, rule, JAX fixture, torch fixture, the lines both flag)
    ("bad_jit", "TPU001", J.BAD_JIT, PORT_BAD_JIT, [9, 10, 11, 11]),
    ("good_jit", "TPU001", J.GOOD_JIT, PORT_GOOD_JIT, []),
    ("jit_variant", "TPU001", JAX_JIT_VARIANT, PORT_JIT_VARIANT, [8, 17]),
    ("bad_thread", "TPU002", J.BAD_THREAD, PORT_BAD_THREAD, [7, 9]),
    ("good_thread", "TPU002", J.GOOD_THREAD, PORT_GOOD_THREAD, []),
    ("closure", "TPU002", JAX_CLOSURE, PORT_CLOSURE, [11]),
    ("bad_start_done", "TPU002", J.BAD_START_DONE, PORT_BAD_START_DONE,
     [7]),
    ("good_start_done", "TPU002", J.GOOD_START_DONE,
     PORT_GOOD_START_DONE, []),
    ("mixed_start_done", "TPU002", MIXED_START_DONE, MIXED_START_DONE, []),
    ("bad_donate", "TPU003", J.BAD_DONATE, PORT_BAD_DONATE, [7]),
    ("good_donate", "TPU003", J.GOOD_DONATE, PORT_GOOD_DONATE, []),
    ("exchange", "TPU003", JAX_EXCHANGE, PORT_EXCHANGE, [7]),
]


@pytest.mark.parametrize("code,jax_src,port_src,want",
                         [p[1:] for p in PAIRED], ids=[p[0] for p in PAIRED])
def test_tpu001_to_003_flag_the_paired_lines(tmp_path, code, jax_src,
                                             port_src, want):
    jax = lint("jax", tmp_path, jax_src, code, name="jax_fixture.py")
    port = lint("port", tmp_path, port_src, code, name="port_fixture.py")
    assert [f.line for f in jax.findings] == want
    assert [f.line for f in port.findings] == want
    assert {f.rule for f in port.findings} <= {code}
    assert port.exit_code == jax.exit_code


def test_paired_fixtures_are_line_for_line():
    for _, _, jax_src, port_src, _ in PAIRED:
        assert jax_src.count("\n") == port_src.count("\n")


def test_port_messages_name_the_torch_construct(tmp_path):
    msgs = {}
    for code, src in (("TPU001", PORT_BAD_JIT), ("TPU002", PORT_BAD_THREAD),
                      ("TPU003", PORT_BAD_DONATE)):
        rep = lint("port", tmp_path, src, code)
        msgs[code] = " ".join(f.message for f in rep.findings)
    assert "time.time" in msgs["TPU001"] and "print()" in msgs["TPU001"]
    assert "numpy.random.rand" in msgs["TPU001"]
    assert "capture" in msgs["TPU001"]
    assert "process group" in msgs["TPU002"]
    assert "'grads'" in msgs["TPU003"] and "all_reduce" in msgs["TPU003"]


# torch-only shapes of the three rules (no JAX construct to pair with):
# (id, rule, fixture, the lines flagged)
PORT_ONLY = [
    ("capture_self_method", "TPU001", """
import time
from dgl_operator_tpu_torch.runtime.graphs import DeviceRun, GraphedCall

class Trainer:
    def step(self, seeds, gstep):
        return seeds + time.monotonic()

    def start(self, device):
        self.run = DeviceRun(self.step, 1, (4, 1, 8), None, 4, device, True)
        self.call = GraphedCall(self.other, device)

    def other(self):
        print("replayed?")
""", [7, 14]),
    ("capture_graph_block", "TPU001", """
import time
import torch

def capture(fn, graph, side):
    t0 = time.perf_counter()           # before the capture: fine
    with torch.cuda.graph(graph, stream=side):
        out = fn()
        stamp = time.perf_counter()
    return out, stamp - t0
""", [9]),
    ("capture_graphed_callables", "TPU001", """
import random
import torch

def fwd(x):
    return x * random.random()

def bwd(x):
    return x

graphed = torch.cuda.make_graphed_callables((fwd, bwd), ((1,), (1,)))
scripted = torch.jit.script(bwd)
""", [6]),
    ("capture_compile_call_form", "TPU001", """
import numpy as np
import torch

def body(x):
    return x + np.random.rand()

compiled = torch.compile(body)
""", [6]),
    ("capture_clean_host_side", "TPU001", """
import time
import re
from dgl_operator_tpu_torch.runtime.graphs import GraphedCall

PATTERN = re.compile("x")

def steps():
    return None

def run(device):
    t0 = time.time()
    call = GraphedCall(steps, device)
    return call(), time.time() - t0
""", []),
    ("thread_self_method", "TPU002", """
import threading
import torch.distributed as dist

class Syncer:
    def _loop(self, t):
        dist.all_reduce(t)

    def start(self, t):
        threading.Thread(target=self._loop, args=(t,)).start()
""", [10]),
    ("submit_collective_ref", "TPU002", """
from functools import partial
import torch.distributed as dist
from dgl_operator_tpu_torch.parallel.collectives import barrier

def go(pool, t):
    pool.submit(dist.all_reduce, t)
    pool.submit(barrier)
    reduce_fn = partial(dist.all_reduce, t)
    pool.submit(reduce_fn)
""", [7, 8, 10]),
    ("allgather_start_done", "TPU002", """
from dgl_operator_tpu_torch.parallel.dp import (param_allgather_done,
                                                param_allgather_start)

def gather(out, local, compute):
    handle = param_allgather_start(out, local)
    param_allgather_done(handle)
    compute()
    param_allgather_done(param_allgather_start(out, local))
""", [7]),
    ("thread_without_collectives", "TPU002", """
import threading

def poll(live):
    return live.read()

def watch(pool, live):
    pool.submit(poll, live)
    threading.Thread(target=poll, args=(live,)).start()
""", []),
    ("lent_to_isend", "TPU003", """
import torch.distributed as dist

def ship(buf, peer):
    req = dist.isend(buf, peer)
    buf.add_(1)
    req.wait()
    return buf
""", [6]),
    ("lent_read_after_finish", "TPU003", """
from dgl_operator_tpu_torch.parallel.halo import (request_rows_finish,
                                                  request_rows_start)

def exchange(store, req, rows, work):
    handle = request_rows_start(store, req, rows, async_op=True)
    work()
    recv = request_rows_finish(handle)
    return recv, req.sum(), store
""", []),
    ("lent_without_handle", "TPU003", """
import torch.distributed as dist

def fire(t):
    dist.all_reduce(t, async_op=True)
    return t * 2
""", [6]),
    ("sync_and_nested_forms", "TPU003", """
import torch.distributed as dist
from dgl_operator_tpu_torch.parallel.dp import (param_allgather_done,
                                                param_allgather_start)

def gather(full, local, t):
    param_allgather_done(param_allgather_start(full, local))
    dist.all_reduce(t)
    work = dist.all_to_all_single(full, local, async_op=False)
    return full, local, t, work
""", []),
]


@pytest.mark.parametrize("code,source,want", [p[1:] for p in PORT_ONLY],
                         ids=[p[0] for p in PORT_ONLY])
def test_torch_only_shapes(tmp_path, code, source, want):
    rep = lint("port", tmp_path, source, code)
    assert [f.line for f in rep.findings] == want
    assert rep.exit_code == (1 if want else 0)


# ------------------------------------------------------ the port's gate
def test_port_surface_is_lint_clean_with_empty_baseline():
    """The port's default surface lints clean against the committed
    baseline, and that baseline is empty."""
    assert port_core.load_baseline(PORT_BASELINE) == {}
    assert port_core.DEFAULT_PATHS == ("dgl_operator_tpu_torch",
                                       "chip_smoke.py")
    rep = port_core.run_lint(root=REPO, baseline_path=PORT_BASELINE)
    assert rep.files_checked > 100
    assert rep.errors == []
    assert rep.findings == [], "\n" + "\n".join(
        f.render() for f in rep.findings)
    # the two reasoned suppressions, and nothing else
    assert sorted((f.rule, f.path) for f in rep.suppressed) == [
        ("TPU004", "dgl_operator_tpu_torch/parallel/dp.py"),
        ("TPU006", "chip_smoke.py")]


def test_jax_rules_find_nothing_in_the_port():
    """The JAX package's rules, read-only over the port's surface: no
    live finding (the four knob sites delegate to the registry)."""
    rep = jax_core.run_lint(paths=list(port_core.DEFAULT_PATHS), root=REPO)
    assert rep.files_checked > 100 and rep.errors == []
    assert rep.findings == [], "\n" + "\n".join(
        f.render() for f in rep.findings)


# ------------------------------------------------------------ benchkeys
KEY_NAMES = ["SCALE_FULL_KEYS", "SCALING_KEYS", "SERVE_KEYS", "TUNE_KEYS",
             "PROF_KEYS", "QUALITY_KEYS", "COMM_KEYS", "XRAY_KEYS",
             "KERNEL_SHAPE_KEYS", "KERNEL_RESULT_KEYS", "KERNEL_TIMING_KEYS",
             "KERNEL_ERROR_KEYS", "KERNEL_RECORD_KEYS"]


@pytest.mark.parametrize("name", KEY_NAMES)
def test_benchkeys_equal_the_jax_packages(name):
    assert getattr(port_keys, name) == getattr(jax_keys, name)


def test_benchkeys_hold_every_public_name():
    public = {n for n in dir(jax_keys) if not n.startswith("_")} - {"re"}
    assert public == set(KEY_NAMES) | {"kernel_error_record"}
    assert public <= set(dir(port_keys))


@pytest.mark.parametrize("detail,status", [
    ("\x1b[31merror:\x1b[0m bad smem\nsecond line\nthird", "compile_error"),
    ("line one\nline two", "runtime_error"),
    ("x" * 500, "compile_error"),
    ("   \n\n", "compile_error"),
    (RuntimeError("HTTP 500\n\x1b[1mtrace\x1b[0m"), "compile_error"),
])
def test_kernel_error_record_alike(detail, status):
    got = port_keys.kernel_error_record(detail, status=status)
    assert got == jax_keys.kernel_error_record(detail, status=status)
    assert len(got["detail"]) <= 200 and "\n" not in got["detail"]


# ------------------------------------------------- the four knob sites
def _partition(pkg, tmp_path):
    if pkg == "jax":
        from dgl_operator_tpu.graph import datasets
        from dgl_operator_tpu.graph.partition import partition_graph
    else:
        from dgl_operator_tpu_torch.graph import datasets
        from dgl_operator_tpu_torch.graph.partition import partition_graph
    g = datasets.synthetic_node_clf(60, 240, 4, 3, seed=0).graph
    return lambda v: partition_graph(g, "x", 2, str(tmp_path / pkg),
                                     refine_iters=v)


def _jax_validate(name):
    from dgl_operator_tpu.autotune.knobs import validate
    return lambda v: validate(name, v)


def _port_config(field, kge=False):
    if kge:
        from dgl_operator_tpu_torch.runtime.kge import KGETrainConfig as C
    else:
        from dgl_operator_tpu_torch.runtime.loop import TrainConfig as C
    return lambda v: C(**{field: v})


# (site, bad value, (port call, JAX call) from tmp_path, the message):
# the JAX side of resume, halo_cache_frac and cap_policy is the
# registry call the JAX package makes deep inside KGE train()
# (runtime/kge.py:629), DistTrainer.__init__ (runtime/dist.py:225) and
# ServeEngine.__init__ (serve/engine.py:95, its one check of cap_policy)
SITES = [
    ("refine_iters", -1,
     lambda tmp: (_partition("port", tmp), _partition("jax", tmp)),
     "refine_iters must be >= 0, got -1"),
    ("resume", "sometimes",
     lambda tmp: (_port_config("resume", kge=True), _jax_validate("resume")),
     "unknown resume policy 'sometimes' (expected 'auto' or 'never')"),
    ("halo_cache_frac", 1.5,
     lambda tmp: (_port_config("halo_cache_frac"),
                  _jax_validate("halo_cache_frac")),
     "halo_cache_frac must be in [0, 1], got 1.5"),
    ("cap_policy", "sometimes",
     lambda tmp: (_port_config("cap_policy"), _jax_validate("cap_policy")),
     "unknown cap_policy 'sometimes' (expected 'auto' or 'worst')"),
]


@pytest.mark.parametrize("value,calls,msg", [s[1:] for s in SITES],
                         ids=[s[0] for s in SITES])
def test_knob_sites_raise_what_the_jax_package_raises(tmp_path, value,
                                                      calls, msg):
    errors = []
    for call in calls(tmp_path):
        with pytest.raises(ValueError) as ei:
            call(value)
        errors.append(str(ei.value))
    assert errors == [msg, msg]
