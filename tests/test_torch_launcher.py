"""The port's launcher (``dgl_operator_tpu_torch/launcher/``): fabric,
dispatch, launch and the ``tpurun`` phases, the JAX package's
``tests/test_launcher.py`` cases run on the port's copy, then parity
with the JAX launcher on identical inputs (the dispatch rewrite of one
book, ``launch_train``'s environment per host, the ``PhaseLedger``
signature, the revised hostfile), ``--elastic`` and ``--placement``
refused, and the KGE job end to end: ``tpukerun`` phases 3-5 over
``LocalFabric`` starting the port's ``partition_kg.py`` book and
``train_kge.py`` by path (``--num_dp 2 --num_mp 2 --neg_sampler device``
on the CPU), and a driver relaunch of the port's ``train_dist.py``
whose second run skips the completed phases and resumes bit-equal to an
uninterrupted run.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.partition import (GraphPartition,
                                                    partition_graph)
from dgl_operator_tpu_torch.launcher.dispatch import dispatch_partitions
from dgl_operator_tpu_torch.launcher.fabric import FabricError, LocalFabric
from dgl_operator_tpu_torch.launcher.launch import launch_train, run_exec_batch
from dgl_operator_tpu_torch.launcher import tpurun
from dgl_operator_tpu_torch.parallel.bootstrap import (HOSTFILE_ENV,
                                                       PHASE_ENV, RANK_ENV,
                                                       HostEntry,
                                                       write_hostfile)


def _hostfile(path, n, port=30050):
    write_hostfile(str(path),
                   [HostEntry(f"10.0.0.{i}", port, f"w{i}-worker", 1)
                    for i in range(n)])
    return str(path)


# ---------------------------------------------------------------- fabric
def test_local_fabric_exec_and_copy(tmp_path):
    f = LocalFabric()
    marker = tmp_path / "m.txt"
    f.exec("w0", f"echo hi > {marker}")
    assert marker.read_text().strip() == "hi"
    dst = tmp_path / "dst"
    f.copy(str(marker), "w0", str(dst))
    assert (dst / "m.txt").read_text().strip() == "hi"


def test_local_fabric_batch_env_and_errors(tmp_path):
    f = LocalFabric()
    f.exec_batch([f"w{i}" for i in range(3)],
                 f'sh -c \'echo "$TPU_OPERATOR_RANK" > {tmp_path}/r$TPU_OPERATOR_RANK\'',
                 per_host_env=[{RANK_ENV: str(i)} for i in range(3)])
    got = sorted((tmp_path / f"r{i}").read_text().strip() for i in range(3))
    assert got == ["0", "1", "2"]
    with pytest.raises(FabricError):
        f.exec_batch(["w0", "w1"], "exit 3")


# -------------------------------------------------------------- dispatch
def test_dispatch_rewrites_and_ships(tmp_path):
    g = datasets.karate_club().graph
    ws = tmp_path / "ws"
    cfg = partition_graph(g, "karate", 2, str(tmp_path / "dataset"))
    hf = _hostfile(tmp_path / "hostfile", 2)
    worker_cfg = dispatch_partitions(str(ws), "workload",
                                     cfg, hf, LocalFabric())
    meta = json.load(open(worker_cfg))
    # paths are absolute under the worker workspace (dispatch.py:62-71)
    for p in range(2):
        for k in ("node_feats", "edge_feats", "part_graph"):
            path = meta[f"part-{p}"][k]
            assert path.startswith(str(ws))
            assert os.path.exists(path)
    # a worker can load its partition straight from the shipped config
    p0 = GraphPartition(worker_cfg, 0)
    p1 = GraphPartition(worker_cfg, 1)
    assert p0.num_inner + p1.num_inner == g.num_nodes


# ----------------------------------------------------------- object store
def test_fs_object_store_put_get_dedup_and_freshness(tmp_path):
    from dgl_operator_tpu_torch.launcher.objstore import (FSObjectStore,
                                                    ObjectStoreError)

    store = FSObjectStore(str(tmp_path / "bucket"))
    src = tmp_path / "a.npz"
    src.write_bytes(b"v1")
    url1 = store.put(str(src))
    assert url1.startswith("file://")
    # idempotent: same unchanged source -> same object, no re-upload
    assert store.put(str(src)) == url1
    # freshness: an edited source gets a NEW key (mtime in the digest)
    src.write_bytes(b"v2-longer")
    os.utime(src, ns=(1, 10**15))
    url2 = store.put(str(src))
    assert url2 != url1
    dest = tmp_path / "worker"
    got = FSObjectStore.get(url2, str(dest))
    assert open(got, "rb").read() == b"v2-longer"
    # snapshot semantics: rewriting the source in place must NOT
    # mutate the already-staged object (no inode aliasing)
    src.write_bytes(b"v3")
    assert FSObjectStore.get(url2, str(tmp_path / "w2")) and open(
        url2[len("file://"):], "rb").read() == b"v2-longer"
    with pytest.raises(ObjectStoreError):
        FSObjectStore.get("file:///nonexistent/x", str(dest))
    with pytest.raises(ObjectStoreError):
        store.put(str(tmp_path))            # a dir is not an object


def test_object_store_fabric_uploads_once_pulls_per_host(tmp_path):
    """The data-plane contract vs kubectl-cp (SURVEY §2): N hosts cost
    1 PUT per unique source + 1 pull exec per host — never N uplink
    copies — and exec passes through to the control fabric."""
    from dgl_operator_tpu_torch.launcher.objstore import (FSObjectStore,
                                                    ObjectStoreFabric)

    store = FSObjectStore(str(tmp_path / "bucket"))
    control = LocalFabric()
    fab = ObjectStoreFabric(store, control)
    src = tmp_path / "shared.bin"
    src.write_bytes(b"payload" * 100)
    hosts = ["w0", "w1", "w2"]
    tdir = tmp_path / "ws"
    fab.copy_batch([str(src)], hosts, str(tdir))
    assert (tdir / "shared.bin").read_bytes() == b"payload" * 100
    # exactly one object staged for three hosts
    objs = [p for p in (tmp_path / "bucket").rglob("*") if p.is_file()]
    assert len(objs) == 1
    # one pull exec per host, zero copy verbs on the control fabric
    execs = [e for e in control.log if e[0] == "exec"]
    assert len(execs) == 3
    assert all("objstore get" in e[2] for e in execs)
    assert not any(e[0] == "copy" for e in control.log)


def test_object_store_fabric_copies_directory_trees(tmp_path):
    """tpurun phase 2 ships a whole dataset DIRECTORY through the
    fabric; the object store must recreate the tree on the worker
    (url::relpath tokens), matching LocalFabric.copytree placement."""
    from dgl_operator_tpu_torch.launcher.objstore import (FSObjectStore,
                                                    ObjectStoreError,
                                                    ObjectStoreFabric,
                                                    get_url)

    store = FSObjectStore(str(tmp_path / "bucket"))
    fab = ObjectStoreFabric(store, LocalFabric())
    src = tmp_path / "dataset"
    (src / "part0").mkdir(parents=True)
    (src / "part0" / "graph.npz").write_bytes(b"g0")
    (src / "meta.json").write_text("{}")
    tdir = tmp_path / "ws"
    fab.copy_batch([str(src)], ["w0", "w1"], str(tdir))
    assert (tdir / "dataset" / "part0" / "graph.npz").read_bytes() == b"g0"
    assert (tdir / "dataset" / "meta.json").read_text() == "{}"
    # one object per file, for two hosts
    objs = [p for p in (tmp_path / "bucket").rglob("*") if p.is_file()]
    assert len(objs) == 2
    # path-traversal tokens are rejected on the worker side
    with pytest.raises(ObjectStoreError, match="unsafe"):
        get_url("file:///x::../../etc/owned", str(tdir))


def test_dispatch_over_object_store_fabric(tmp_path, monkeypatch):
    """End-to-end phase-3 dispatch with the bucket as the data plane
    (the get_fabric auto-selection path: TPU_OPERATOR_OBJECT_STORE set,
    no explicit kind)."""
    from dgl_operator_tpu_torch.launcher.fabric import get_fabric
    from dgl_operator_tpu_torch.launcher.objstore import ObjectStoreFabric
    from dgl_operator_tpu_torch.launcher.retry import RetryingFabric

    monkeypatch.setenv("TPU_OPERATOR_OBJECT_STORE",
                       str(tmp_path / "bucket"))
    fab = get_fabric()
    assert isinstance(fab, RetryingFabric)        # outermost: retry
    assert isinstance(fab.inner, ObjectStoreFabric)
    g = datasets.karate_club().graph
    cfg = partition_graph(g, "karate", 2, str(tmp_path / "dataset"))
    hf = _hostfile(tmp_path / "hostfile", 2)
    worker_cfg = dispatch_partitions(str(tmp_path / "ws"), "workload",
                                     cfg, hf, fab)
    p0 = GraphPartition(worker_cfg, 0)
    p1 = GraphPartition(worker_cfg, 1)
    assert p0.num_inner + p1.num_inner == g.num_nodes
    # every partition byte flowed store->worker: the bucket holds the
    # 6 per-part files (3 x 2 parts) plus the shared artifacts, each
    # staged exactly once (keys are per-source digests)
    objs = [p for p in (tmp_path / "bucket").rglob("*") if p.is_file()]
    assert len(objs) >= 7
    assert len(objs) == len({p.parent.name + "/" + p.name for p in objs})


def test_get_fabric_object_kind_requires_store(monkeypatch):
    from dgl_operator_tpu_torch.launcher.fabric import get_fabric

    monkeypatch.delenv("TPU_OPERATOR_OBJECT_STORE", raising=False)
    with pytest.raises(FabricError, match="OBJECT_STORE"):
        get_fabric("object")


def test_object_store_composes_with_explicit_control_kind(
        tmp_path, monkeypatch):
    """The bucket is the data plane over ANY control fabric: an
    explicit kind='shell' (or 'local') with TPU_OPERATOR_OBJECT_STORE
    set must stage copies through the store, not silently drop it."""
    from dgl_operator_tpu_torch.launcher.fabric import (EXEC_PATH_ENV,
                                                  ShellFabric, get_fabric)
    from dgl_operator_tpu_torch.launcher.objstore import ObjectStoreFabric

    from dgl_operator_tpu_torch.launcher.retry import RetryingFabric

    monkeypatch.setenv("TPU_OPERATOR_OBJECT_STORE", str(tmp_path / "b"))
    monkeypatch.setenv(EXEC_PATH_ENV, str(tmp_path / "exec.sh"))
    fab = get_fabric("shell")
    assert isinstance(fab, RetryingFabric)
    assert isinstance(fab.inner, ObjectStoreFabric)
    assert isinstance(fab.control, ShellFabric)   # delegated through
    fab = get_fabric("local")
    assert isinstance(fab.inner, ObjectStoreFabric)
    assert isinstance(fab.control, LocalFabric)


def test_objstore_cli_put_get_roundtrip(tmp_path):
    from dgl_operator_tpu_torch.launcher import objstore

    src = tmp_path / "f.txt"
    src.write_text("roundtrip")
    import io
    from contextlib import redirect_stdout
    buf = io.StringIO()
    with redirect_stdout(buf):
        objstore.main(["put", "--store", str(tmp_path / "b"), str(src)])
    url = buf.getvalue().strip()
    objstore.main(["get", "--dest", str(tmp_path / "out"), url])
    assert (tmp_path / "out" / "f.txt").read_text() == "roundtrip"


def test_dispatch_part_host_mismatch(tmp_path):
    g = datasets.karate_club().graph
    cfg = partition_graph(g, "karate", 2, str(tmp_path / "dataset"))
    hf = _hostfile(tmp_path / "hostfile", 3)
    with pytest.raises(ValueError, match="must equal"):
        dispatch_partitions(str(tmp_path / "ws"), "workload",
                            cfg, hf, LocalFabric())


# ---------------------------------------------------------------- launch
def test_launch_train_env_contract(tmp_path):
    hf = _hostfile(tmp_path / "hostfile", 2)
    out = tmp_path / "out"
    out.mkdir()
    script = tmp_path / "train.py"
    script.write_text(textwrap.dedent(f"""
        import os
        r = os.environ["{RANK_ENV}"]
        with open(r"{out}/rank" + r, "w") as f:
            f.write(os.environ["{HOSTFILE_ENV}"] + "\\n" +
                    os.environ["TPU_OPERATOR_PART_CONFIG"])
    """))
    launch_train(hf, f"{sys.executable} {script}", num_parts=2,
                 part_config="/ws/workload/g.json", workspace="/ws",
                 fabric=LocalFabric())
    for r in range(2):
        lines = (out / f"rank{r}").read_text().splitlines()
        assert lines[0] == hf and lines[1] == "/ws/workload/g.json"


def test_launch_train_asserts_parts_match_hosts(tmp_path):
    hf = _hostfile(tmp_path / "hostfile", 2)
    with pytest.raises(ValueError, match="partitions has to match"):
        launch_train(hf, "true", num_parts=3, part_config="x",
                     workspace="y", fabric=LocalFabric())


# ---------------------------------------------------------------- tpurun
def test_tpurun_skip_mode(tmp_path, monkeypatch, capsys):
    """partitionMode: Skip — launcher-only local training (dglrun:119-131)."""
    marker = tmp_path / "trained"
    entry = tmp_path / "train.py"
    entry.write_text(f"open(r'{marker}', 'w').write('ok')\n")
    monkeypatch.setenv(PHASE_ENV, "Launcher_Workload")
    tpurun.main(["--train-entry-point", str(entry),
                 "--workspace", str(tmp_path)])
    assert marker.read_text() == "ok"
    cap = capsys.readouterr().out
    assert "Phase 1/1" in cap and "finished" in cap


def test_tpurun_skip_mode_failure_exits_nonzero(tmp_path, monkeypatch):
    entry = tmp_path / "train.py"
    entry.write_text("raise SystemExit(2)\n")
    monkeypatch.setenv(PHASE_ENV, "Launcher_Workload")
    with pytest.raises(SystemExit):
        tpurun.main(["--train-entry-point", str(entry)])


@pytest.mark.serve
def test_tpurun_serve_phase(tmp_path, monkeypatch, capfd):
    """TPU_OPERATOR_PHASE_ENV=Launcher_Serve (alias Serve): a single
    phase materializes the serving job from --serve-entry-point +
    --serve-args — and a relaunch RESTARTS the server (the ledger
    never marks a serving phase complete: an exited server must come
    back, not be skipped)."""
    marker = tmp_path / "served"
    entry = tmp_path / "serve.py"
    entry.write_text(textwrap.dedent(f"""
        import sys
        with open(r"{marker}", "a") as f:
            f.write("|".join(sys.argv[1:]) + "\\n")
    """))
    monkeypatch.setenv(PHASE_ENV, "Launcher_Serve")
    argv = ["--serve-entry-point", str(entry),
            "--serve-args", "--port 8378 --batch-size 32",
            "--workspace", str(tmp_path)]
    tpurun.main(argv)
    assert marker.read_text() == "--port|8378|--batch-size|32\n"
    cap = capfd.readouterr().out
    assert "Phase 1/1" in cap and "serving" in cap
    # relaunch re-runs the phase (never ledger-skipped)
    tpurun.main(argv)
    assert marker.read_text().count("\n") == 2
    assert "skipped (ledger)" not in capfd.readouterr().out
    # the alias spelling drives the same path, defaulting to the
    # builtin tpu-serve module (which exits nonzero on missing args —
    # proof it was actually invoked; the phase clock maps a failed
    # phase to SystemExit like every other phase)
    monkeypatch.setenv(PHASE_ENV, "Serve")
    with pytest.raises(SystemExit):
        tpurun.main(["--workspace", str(tmp_path)])
    assert "dgl_operator_tpu_torch.serve.server" in capfd.readouterr().err


def test_tpurun_launcher_phases_end_to_end(tmp_path, monkeypatch):
    """Phases 3-5 against a pre-partitioned dataset over LocalFabric:
    dispatch → revise → train, with the train entry loading its own
    partition — the full dglrun else-branch (dglrun:177-238)."""
    g = datasets.karate_club().graph
    ws = tmp_path / "ws"
    ws.mkdir()
    partition_graph(g, "karate", 2, str(ws / "dataset"))
    conf = tmp_path / "conf"
    conf.mkdir()
    _hostfile(conf / "hostfile", 2)

    out = tmp_path / "out"
    out.mkdir()
    entry = tmp_path / "train.py"
    entry.write_text(textwrap.dedent(f"""
        import argparse, os, json
        from dgl_operator_tpu_torch.graph.partition import GraphPartition
        ap = argparse.ArgumentParser()
        for f in ("--graph_name", "--ip_config", "--part_config"):
            ap.add_argument(f)
        for f in ("--num_epochs", "--batch_size", "--num_workers"):
            ap.add_argument(f, type=int)
        a = ap.parse_args()
        rank = int(os.environ["{RANK_ENV}"])
        part = GraphPartition(a.part_config, rank)
        assert os.path.exists(a.ip_config)
        with open(r"{out}/rank%d" % rank, "w") as f:
            f.write("%d %d" % (part.num_inner, a.num_epochs))
    """))
    monkeypatch.delenv(PHASE_ENV, raising=False)
    tpurun.main(["--graph-name", "karate",
                 "--num-partitions", "2",
                 "--train-entry-point", str(entry),
                 "--workspace", str(ws),
                 "--conf-dir", str(conf),
                 "--num-epochs", "3",
                 "--fabric", "local"])
    inner = 0
    for r in range(2):
        n, ep = (out / f"rank{r}").read_text().split()
        assert ep == "3"
        inner += int(n)
    assert inner == g.num_nodes
    # phase 4 left a revised hostfile in the workspace
    revised = (ws / "hostfile_revised").read_text().splitlines()
    assert len(revised) == 2 and ":" in revised[0]


def test_tpurun_partitioner_phase_arg_passthrough(tmp_path, monkeypatch):
    """--partition-args reaches the partition entrypoint verbatim (how
    manifests opt into e.g. --community_hint label), alongside the
    standard flag surface."""
    ws = tmp_path / "ws"
    ws.mkdir()
    conf = tmp_path / "conf"
    conf.mkdir()
    _hostfile(conf / "leadfile", 1)
    entry = tmp_path / "part.py"
    entry.write_text(textwrap.dedent(f"""
        import json, os, sys
        os.makedirs(r"{ws}/dataset", exist_ok=True)
        with open(r"{tmp_path}/argv.json", "w") as f:
            json.dump(sys.argv[1:], f)
    """))
    monkeypatch.setenv(PHASE_ENV, "Partitioner")
    tpurun.main(["--graph-name", "karate",
                 "--num-partitions", "2",
                 "--partition-entry-point", str(entry),
                 "--workspace", str(ws),
                 "--conf-dir", str(conf),
                 "--balance-train",
                 "--partition-args", "--community_hint label",
                 "--fabric", "local"])
    argv = json.loads((tmp_path / "argv.json").read_text())
    assert argv[:2] == ["--graph_name", "karate"]
    assert "--balance_train" in argv
    assert argv[-2:] == ["--community_hint", "label"]


def test_tpurun_phase_ledger_skips_completed_phases(tmp_path, monkeypatch,
                                                    capsys):
    """A relaunched driver (preempted launcher / Failed-job requeue)
    skips phases the previous run completed — the workspace ledger —
    and --fresh / a changed job signature start over."""
    g = datasets.karate_club().graph
    ws = tmp_path / "ws"
    ws.mkdir()
    partition_graph(g, "karate", 2, str(ws / "dataset"))
    conf = tmp_path / "conf"
    conf.mkdir()
    _hostfile(conf / "hostfile", 2)
    counter = tmp_path / "runs"
    entry = tmp_path / "train.py"
    entry.write_text(textwrap.dedent(f"""
        import os
        with open(r"{counter}", "a") as f:
            f.write("x")
    """))
    monkeypatch.delenv(PHASE_ENV, raising=False)
    argv = ["--graph-name", "karate", "--num-partitions", "2",
            "--train-entry-point", str(entry), "--workspace", str(ws),
            "--conf-dir", str(conf), "--fabric", "local"]
    tpurun.main(argv)
    assert counter.read_text() == "xx"          # one train run per host
    ledger = json.loads((ws / tpurun.LEDGER_NAME).read_text())
    assert set(ledger["phases"]) == {"3", "4", "5"}
    capsys.readouterr()

    # relaunch: every phase skipped, nothing re-executed
    tpurun.main(argv)
    cap = capsys.readouterr().out
    assert cap.count("skipped (ledger)") == 3
    assert counter.read_text() == "xx"

    # a different job signature does NOT reuse the ledger
    tpurun.main(argv + ["--num-epochs", "7"])
    assert counter.read_text() == "xxxx"

    # --fresh forces a full re-run with the original signature
    tpurun.main(argv + ["--fresh"])
    assert counter.read_text() == "xxxxxx"


def test_launch_cli_exec_batch(tmp_path):
    """launch.py as a CLI module (tools/launch.py main parity)."""
    hf = _hostfile(tmp_path / "hostfile", 2)
    res = subprocess.run(
        [sys.executable, "-m", "dgl_operator_tpu_torch.launcher.launch",
         "--ip_config", hf, "--cmd_type", "exec_batch", "--fabric", "local",
         f"touch {tmp_path}/ran"],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    assert (tmp_path / "ran").exists()


# ------------------------------------------------------ parity with JAX
from dgl_operator_tpu.launcher import dispatch as jax_dispatch  # noqa: E402
from dgl_operator_tpu.launcher import fabric as jax_fabric  # noqa: E402
from dgl_operator_tpu.launcher import launch as jax_launch  # noqa: E402
from dgl_operator_tpu.launcher import revise as jax_revise  # noqa: E402
from dgl_operator_tpu.launcher import tpurun as jax_tpurun  # noqa: E402
from dgl_operator_tpu_torch.examples import partition_kg  # noqa: E402
from dgl_operator_tpu_torch.launcher import fabric as port_fabric  # noqa
from dgl_operator_tpu_torch.launcher import revise as port_revise  # noqa
from dgl_operator_tpu_torch.launcher import tpukerun  # noqa: E402
from dgl_operator_tpu_torch.launcher.chaos import CHAOS_ENV  # noqa: E402
from dgl_operator_tpu_torch.runtime.checkpoint import (  # noqa: E402
    CheckpointManager)

PORT_EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "dgl_operator_tpu_torch", "examples")


def _recording(base):
    class Recording(base):
        def __init__(self):
            self.calls = []

        def exec_batch(self, hosts, cmd, env=None, per_host_env=None,
                       container=None):
            self.calls.append((list(hosts), cmd, dict(env or {}),
                               [dict(e) for e in per_host_env or []]))

        def copy_batch(self, srcs, hosts, target_dir, container=None):
            self.calls.append(([os.path.basename(s) for s in srcs],
                               list(hosts), target_dir))

    return Recording()


@pytest.mark.parametrize("book", ["graph", "kg"])
def test_dispatch_rewrite_matches_jax(tmp_path, book):
    if book == "graph":
        cfg = partition_graph(datasets.karate_club().graph, "karate", 2,
                              str(tmp_path / "dataset"))
    else:
        cfg = partition_kg.main(["--workspace", str(tmp_path),
                                 "--num_parts", "2", "--dataset_scale",
                                 "1e-4"])
    hf = _hostfile(tmp_path / "hostfile", 2)
    outs = []
    for mod, base in ((dispatch_partitions, port_fabric.Fabric),
                      (jax_dispatch.dispatch_partitions, jax_fabric.Fabric)):
        fab = _recording(base)
        ws = str(tmp_path / "ws")
        worker_cfg = mod(ws, "workload", cfg, hf, fab)
        with open(worker_cfg) as f:
            outs.append((json.load(f), fab.calls))
    assert outs[0] == outs[1]
    assert len(outs[0][1]) == 3      # the shared book, then each part


def test_launch_train_env_per_host_matches_jax(tmp_path, monkeypatch):
    hf = _hostfile(tmp_path / "hostfile", 3)
    monkeypatch.setenv("TPU_OPERATOR_ELASTIC_EPOCH", "4")
    monkeypatch.delenv("TPU_OPERATOR_LIVE_PORT", raising=False)
    got = []
    for launch, base in ((launch_train, port_fabric.Fabric),
                         (jax_launch.launch_train, jax_fabric.Fabric)):
        fab = _recording(base)
        launch(hf, "python train.py --x 1", num_parts=3,
               part_config="/ws/workload/g.json", workspace="/ws",
               num_trainers=2, num_samplers=3, fabric=fab,
               extra_env={"EXTRA": "1"})
        got.append(fab.calls)
    assert got[0] == got[1]
    hosts, cmd, env, per_host = got[0][0]
    assert hosts == ["w0-worker", "w1-worker", "w2-worker"]
    assert env[HOSTFILE_ENV] == hf and env["TPU_OPERATOR_LIVE_PORT"] == "0"
    assert env["TPU_OPERATOR_ELASTIC_EPOCH"] == "4"
    assert per_host[2] == {RANK_ENV: "2",
                           "TPU_OPERATOR_OBS_ROLE": "trainer-2"}


@pytest.mark.parametrize("argv", [
    [],
    ["--graph-name", "g", "--num-partitions", "4", "--num-epochs", "3",
     "--train-args", "--lr 0.1", "--tuned-manifest", "t.json"]])
@pytest.mark.parametrize("phase", [None, "Partitioner", "Launcher_Workload"])
def test_phase_ledger_signature_matches_jax(argv, phase):
    args = tpurun.build_parser().parse_args(argv)
    jargs = jax_tpurun.build_parser().parse_args(argv)
    assert tpurun.PhaseLedger.signature_of(args, phase) == \
        jax_tpurun.PhaseLedger.signature_of(jargs, phase)


@pytest.mark.parametrize("framework", ["JAX", "DGL", "DGLKE"])
def test_revised_hostfile_matches_jax(tmp_path, framework):
    hf = _hostfile(tmp_path / "hostfile", 3)
    texts = []
    for name, mod in (("port", port_revise), ("jax", jax_revise)):
        ws = tmp_path / name
        mod.main(["--workspace", str(ws), "--ip_config", hf,
                  "--num_servers", "2", "--framework", framework])
        texts.append((ws / "hostfile_revised").read_text())
    assert texts[0] == texts[1] and texts[0].count("\n") == 3


@pytest.mark.parametrize("flag", [["--elastic"], ["--placement", "auto"]])
def test_tpurun_refuses_elastic_and_placement(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="7c"):
        tpurun.main(["--workspace", str(tmp_path)] + flag)
    if flag[0] == "--placement":
        with pytest.raises(NotImplementedError, match="7c"):
            port_revise.main(["--workspace", str(tmp_path), "--ip_config",
                              _hostfile(tmp_path / "h", 1), "--framework",
                              "JAX", "--placement", "p.json"])


def test_tpukerun_flags_match_jax():
    from dgl_operator_tpu.launcher import tpukerun as jax_tpukerun
    for argv in ([], ["--train-entry-point", "x/train_kge.py"],
                 ["--no-adv", "--hidden-dim", "8", "--save-path", "a b"],
                 ["-adv", "--adversarial-temperature", "0.5"]):
        a = tpukerun.build_parser().parse_args(argv)
        j = jax_tpukerun.build_parser().parse_args(argv)
        assert vars(a) == vars(j)
        assert tpukerun._train_flags(a) == jax_tpukerun._train_flags(j)


# ------------------------------------------------------- the KGE job
def test_tpukerun_trains_the_port_on_a_grid_end_to_end(tmp_path, monkeypatch,
                                                      capsys):
    """``tpukerun`` phases 3-5 over ``LocalFabric``: the port's KG book,
    its ``train_kge.py`` started by path on a 2 x 2 grid with device
    negatives; a relaunch with the same flags skips every phase."""
    ws = tmp_path / "ws"
    ws.mkdir()
    partition_kg.main(["--graph_name", "toykg", "--workspace", str(ws),
                       "--num_parts", "2", "--dataset_scale", "1e-4"])
    conf = tmp_path / "conf"
    conf.mkdir()
    _hostfile(conf / "hostfile", 2)
    monkeypatch.delenv(PHASE_ENV, raising=False)
    monkeypatch.delenv(CHAOS_ENV, raising=False)
    argv = ["--graph-name", "toykg", "--num-partitions", "2",
            "--train-entry-point", os.path.join(PORT_EXAMPLES,
                                                "train_kge.py"),
            "--workspace", str(ws), "--conf-dir", str(conf),
            "--fabric", "local", "--hidden-dim", "8", "--gamma", "6.0",
            "--batch-size", "32", "--neg-sample-size", "8",
            "--max-step", "6", "--log-interval", "3",
            "--save-path", str(tmp_path / "ckpts"),
            "--train-args", "--device cpu --num_dp 2 --num_mp 2 "
                            "--neg_sampler device"]
    tpukerun.main(argv)
    out = capsys.readouterr().out
    assert out.count("finished") == 3
    revised = (ws / "hostfile_revised").read_text().splitlines()
    assert len(revised) == 2 and len(revised[0].split()) == 3
    saved = []
    for r in range(2):
        with np.load(tmp_path / "ckpts" / f"toykg_ComplEx_rank{r}.npz") as z:
            saved.append({k: z[k] for k in z.files})
        assert saved[r]["entity"].shape == (100, 8)
        assert np.isfinite(saved[r]["entity"]).all()
    # both workers trained the same grid from the same seed
    np.testing.assert_array_equal(saved[0]["entity"], saved[1]["entity"])
    tpukerun.main(argv)
    assert capsys.readouterr().out.count("skipped (ledger)") == 3


def test_tpurun_relaunch_resumes_the_port_bit_for_bit(tmp_path, monkeypatch,
                                                     capsys):
    """A trainer preempted mid-run (chaos ``train:kill``) fails phase 5
    with retries off; the relaunched driver skips phases 3-4 and the
    port's ``train_dist.py`` resumes from the flushed checkpoint, ending
    on the tables of an uninterrupted run bit for bit."""
    monkeypatch.delenv(PHASE_ENV, raising=False)
    monkeypatch.setenv("TPU_OPERATOR_RETRIES", "0")

    def workspace(name):
        ws = tmp_path / name
        partition_graph(datasets.karate_club().graph, "karate", 1,
                        str(ws / "dataset"))
        conf = tmp_path / f"{name}_conf"
        conf.mkdir()
        _hostfile(conf / "hostfile", 1)
        argv = ["--graph-name", "karate", "--num-partitions", "1",
                "--train-entry-point", os.path.join(PORT_EXAMPLES,
                                                    "train_dist.py"),
                "--workspace", str(ws), "--conf-dir", str(conf),
                "--num-epochs", "4", "--batch-size", "4",
                "--fabric", "local",
                "--train-args", f"--device cpu --fan_out 3,3 --num_hidden "
                                f"8 --eval_every 0 --prefetch 0 "
                                f"--ckpt_dir {ws / 'ckpt'}"]
        return ws, argv

    def final(ws):
        mgr = CheckpointManager(str(ws / "ckpt"))
        with np.load(mgr._candidates()[-1][2]) as z:
            return mgr.latest_step(), {k: z[k] for k in z.files}

    ref_ws, ref_argv = workspace("ref")
    monkeypatch.delenv(CHAOS_ENV, raising=False)
    tpurun.main(ref_argv)
    ref_step, ref_state = final(ref_ws)
    assert ref_step > 4

    ws, argv = workspace("ws")
    monkeypatch.setenv(CHAOS_ENV, "train:kill:3")
    with pytest.raises(SystemExit):
        tpurun.main(argv)
    ledger = json.loads((ws / tpurun.LEDGER_NAME).read_text())
    assert set(ledger["phases"]) == {"3", "4"}
    assert CheckpointManager(str(ws / "ckpt")).latest_step() == 3
    capsys.readouterr()
    tpurun.main(argv)
    assert capsys.readouterr().out.count(
        "already complete — skipped (ledger)") == 2
    step, state = final(ws)
    assert step == ref_step and state.keys() == ref_state.keys()
    for k in state:
        np.testing.assert_array_equal(state[k], ref_state[k], k)
