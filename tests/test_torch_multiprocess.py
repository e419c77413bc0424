"""The port's ``DistTrainer`` as one process per partition over
``torch.distributed`` (gloo, on the CPU), against the single-process
port and the JAX ``DistTrainer``.

Two ranks (``tests/torch_mp_worker.py``) rendezvous from an
operator-format hostfile. In one pair they train a 2-part and a 4-part
book of ``synthetic_node_clf(800, 4000, 16, 4, seed=3)`` (the JAX
partitioner's) in both feature layouts from the JAX trainer's initial
params, check the exchange and the host collectives, and cut and resume
a run; a second pair trains through the entry point
``examples/train_dist.py``. The test process runs the same trainings
without a group for the reference, with the same thread count.

Tolerances: at 2 parts on 2 ranks the all-reduced gradient sum
``g0/2 + g1/2`` is the single process's accumulation, so losses and
parameters are equal bit for bit; at 4 parts on 2 ranks the sum is
``(g0+g1)+(g2+g3)`` against ``((g0+g1)+g2)+g3``, held to 1e-6 of the
largest entry. Against the JAX trainer: ``test_torch_dist.py``'s rtol
and atol 1e-3.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph.partition import partition_graph
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.parallel import make_mesh
from dgl_operator_tpu.runtime import DistTrainer as JaxDistTrainer
from dgl_operator_tpu.runtime import TrainConfig as JaxTrainConfig
from dgl_operator_tpu_torch.examples import train_dist
from dgl_operator_tpu_torch.models.sage import state_dict_to_flax
from dgl_operator_tpu_torch.parallel import collectives
from dgl_operator_tpu_torch.parallel.bootstrap import RANK_ENV
from dgl_operator_tpu_torch.runtime.checkpoint import (export_for_serving,
                                                       load_params)
from test_torch_native import use_jax_graphcore
import torch_mp_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")
FEAT, HIDDEN, CLASSES = 16, 32, 4
LAYOUTS = ("replicated", "owner")
THREADS = 1
TRAIN_TOL = dict(rtol=1e-3, atol=1e-3)
RESUME_AT = 4
CHILD_TIMEOUT_S = 120


def _cfg(layout, **kw):
    return dict(num_epochs=2, batch_size=32, lr=0.01, fanouts=(4, 4),
                log_every=1000, eval_every=2, feats_layout=layout, **kw)


def _job(name, book, layout, **kw):
    return {"name": name, "book": book, "dims": [FEAT, HIDDEN, CLASSES],
            "cfg": _cfg(layout, dropout=0.0, **kw)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _hostfile(tmp):
    path = os.path.join(tmp, "hostfile")
    port = _free_port()
    with open(path, "w") as f:
        f.write(f"127.0.0.1 {port} job-worker-0 slots=1\n"
                f"127.0.0.1 {port} job-worker-1 slots=1\n")
    return path


def _run_two_ranks(spec: dict, tmp: str):
    """Start both ranks, wait for them (killing both on a hang) and
    return ``(outputs, [rank 0's arrays, rank 1's])``."""
    spec = dict(spec, out=os.path.join(tmp, "result"), threads=THREADS)
    env = dict(os.environ, TPU_OPERATOR_DIST="1", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, json.dumps(spec)],
        env=dict(env, **{RANK_ENV: str(r)}), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        rest = [p.communicate()[0] for p in procs[len(outs):]]
        pytest.fail("two-rank run hung:\n" + "\n".join(outs + rest))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    results = []
    for r in (0, 1):
        with np.load(f"{spec['out']}.rank{r}.npz") as z:
            results.append({k: z[k] for k in z.files})
    return outs, results


@pytest.fixture(autouse=True)
def jax_library(monkeypatch, tmp_path_factory):
    use_jax_graphcore(monkeypatch, tmp_path_factory)
    monkeypatch.delenv("TPU_OPERATOR_TUNED_MANIFEST", raising=False)


@pytest.fixture(scope="module")
def books(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        use_jax_graphcore(mp, tmp_path_factory)
        ds = jax_datasets.synthetic_node_clf(800, 4000, FEAT, CLASSES, seed=3)
        return {P: partition_graph(ds.graph, "synth", P,
                                   str(tmp_path_factory.mktemp(f"mp{P}")))
                for P in (2, 4)}


@pytest.fixture(scope="module")
def jax_runs(books, tmp_path_factory):
    """Per layout: the JAX trainer's initial params and its run on the
    2-part book."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        use_jax_graphcore(mp, tmp_path_factory)
        mp.delenv("TPU_OPERATOR_TUNED_MANIFEST", raising=False)
        for layout in LAYOUTS:
            tr = JaxDistTrainer(
                JaxDistSAGE(hidden_feats=HIDDEN, out_feats=CLASSES,
                            dropout=0.0), books[2], make_mesh(num_dp=2),
                JaxTrainConfig(**_cfg(layout), sentry=False))
            init = jax.device_get(tr._init_params())
            out = tr.train()
            runs[layout] = (init, out, jax.device_get(out["params"]))
    return runs


def _jobs(books):
    return [_job(f"p{P}_{layout}", books[P], layout, num_samplers=2)
            for P in (2, 4) for layout in LAYOUTS]


@pytest.fixture(scope="module")
def init_path(jax_runs, tmp_path_factory):
    return export_for_serving(
        str(tmp_path_factory.mktemp("init")) + os.sep,
        jax_runs["replicated"][0])


@pytest.fixture(scope="module")
def single(books, init_path):
    """The single-process port on every job, at sampler width 1."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        init = load_params(init_path)
        out = {}
        for job in _jobs(books):
            job["cfg"]["num_samplers"] = 1
            out.update(worker.run_job(job, init))
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def two_ranks(books, init_path, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ranks"))
    spec = {"mode": "trainer", "hostfile": _hostfile(tmp),
            "init": init_path, "jobs": _jobs(books),
            "resume": {"job": _job("resumed", books[2], "owner",
                                   num_samplers=2),
                       "ckpt_dir": os.path.join(tmp, "ckpt"),
                       "kill_at": RESUME_AT}}
    return _run_two_ranks(spec, tmp)[1]


def _params(arrays, name):
    prefix = f"{name}/params/"
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_ranks_equal_the_single_process_bit_for_bit(two_ranks, single,
                                                        layout):
    name = f"p2_{layout}"
    for r, got in enumerate(two_ranks):
        assert got[f"{name}/my_parts"].tolist() == [r]
        for key in ("losses", "step", "steps_per_epoch", "caps"):
            np.testing.assert_array_equal(got[f"{name}/{key}"],
                                          single[f"{name}/{key}"], key)
        want = _params(single, name)
        assert _params(got, name).keys() == want.keys()
        for k, v in _params(got, name).items():
            np.testing.assert_array_equal(v, want[k], k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_ranks_match_jax(two_ranks, jax_runs, layout):
    _, want, ref = jax_runs[layout]
    got = two_ranks[0]
    name = f"p2_{layout}"
    assert int(got[f"{name}/step"]) == want["step"]
    np.testing.assert_allclose(got[f"{name}/epoch_loss"],
                               [r["loss"] for r in want["history"]],
                               **TRAIN_TOL)
    final = state_dict_to_flax({k: torch.from_numpy(v) for k, v in
                                _params(got, name).items()})["params"]
    for layer, subs in final.items():
        for sub, leaves in subs.items():
            for leaf, value in leaves.items():
                np.testing.assert_allclose(
                    value, np.asarray(ref["params"][layer][sub][leaf]),
                    err_msg=f"{layer}/{sub}/{leaf}", **TRAIN_TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_four_parts_on_two_ranks(two_ranks, single, layout):
    """Each rank holds 2 slots; the exchange routes within a rank too.
    Within 1e-6 of the largest entry (the gradient sum is ordered
    differently)."""
    name = f"p4_{layout}"
    for r, got in enumerate(two_ranks):
        assert got[f"{name}/my_parts"].tolist() == [2 * r, 2 * r + 1]
        want = single[f"{name}/losses"]
        np.testing.assert_allclose(got[f"{name}/losses"], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        for k, v in _params(single, name).items():
            np.testing.assert_allclose(_params(got, name)[k], v, rtol=0,
                                       atol=1e-6 * np.abs(v).max(),
                                       err_msg=k)


@pytest.mark.parametrize("parts", [2, 4])
def test_owner_equals_replicated_on_two_ranks(two_ranks, parts):
    for got in two_ranks:
        np.testing.assert_allclose(got[f"p{parts}_owner/losses"],
                                   got[f"p{parts}_replicated/losses"],
                                   rtol=1e-6)


def test_ranks_agree(two_ranks):
    a, b = two_ranks
    for key in a:
        if "/my_parts" not in key and not key.startswith("coll/rows"):
            np.testing.assert_array_equal(a[key], b[key], key)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_evaluate_equals_the_single_process(two_ranks, single, layout):
    for parts in (2, 4):
        name = f"p{parts}_{layout}"
        for got in two_ranks:
            np.testing.assert_array_equal(got[f"{name}/acc"],
                                          single[f"{name}/acc"])
            assert (got[f"{name}/acc"][-1] >= 0).all()


def test_cut_and_resumed_run_equals_the_uninterrupted(two_ranks):
    for got in two_ranks:
        whole = got["p2_owner/losses"]
        assert int(got["resumed/step"]) == int(got["p2_owner/step"])
        np.testing.assert_array_equal(got["resumed/losses"],
                                      whole[RESUME_AT:])
        want = _params(got, "p2_owner")
        for k, v in _params(got, "resumed").items():
            np.testing.assert_array_equal(v, want[k], k)


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_request_exchange_equals_the_one_process_exchange(two_ranks, slots):
    for got in two_ranks:
        assert bool(got[f"a2a/L{slots}/equal"])


def test_host_collectives(two_ranks):
    for got in two_ranks:
        assert int(got["coll/sum"]) == 3
        assert got["coll/max_min"].tolist() == [1, 0]
        np.testing.assert_array_equal(
            got["coll/rows"], np.repeat([[0], [0], [1], [1]], 3, axis=1))


def test_host_collectives_are_the_identity_without_a_group():
    assert not collectives.group_active()
    assert collectives.world() == (0, 1)
    assert collectives.allreduce_host(5, np.max) == 5
    assert collectives.allreduce_host([3, 4], np.min) == [3, 4]
    rows = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(collectives.host_gather_rows(rows), rows)


def _entry_argv(book, tmp):
    return ["--graph_name", "synth", "--ip_config", _hostfile(tmp),
            "--part_config", book, "--num_epochs", "2", "--batch_size", "32",
            "--fan_out", "4,4", "--num_hidden", str(HIDDEN), "--lr", "0.01",
            "--eval_every", "2", "--device", "cpu", "--num_workers", "2",
            "--feats_layout", "owner"]


def test_entry_point_trains_two_ranks_from_the_hostfile(books, tmp_path,
                                                        monkeypatch):
    """Both ranks print the same final loss, and train what one process
    driving both parts trains, bit for bit."""
    argv = _entry_argv(books[2], str(tmp_path))
    outs, (r0, r1) = _run_two_ranks({"mode": "entry", "argv": argv},
                                    str(tmp_path))
    lines = [[ln for ln in out.splitlines() if ": done, final loss" in ln]
             for out in outs]
    assert [ln[0].split(":")[0] for ln in lines] == ["rank 0", "rank 1"]
    assert lines[0][0].split(":", 1)[1] == lines[1][0].split(":", 1)[1]
    monkeypatch.delenv("TPU_OPERATOR_DIST", raising=False)
    monkeypatch.delenv(RANK_ENV, raising=False)
    monkeypatch.setenv("TPU_OPERATOR_NUM_SAMPLERS", "2")
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        want = worker.result_arrays("entry", train_dist.main(argv))
    finally:
        torch.set_num_threads(threads)
    for got in (r0, r1):
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, k)


@pytest.mark.parametrize("flags", [
    ["--model", "gat"], ["--model", "gatv2"], ["--bf16"], ["--remat"],
    ["--shard_update"], ["--shard_rules", '[[".*", "dp"]]'],
    ["--sampler", "device"], ["--feat_dtype", "bfloat16"]])
def test_entry_point_flags_not_ported_raise(books, tmp_path, monkeypatch,
                                            flags):
    """The entry point's flags whose features the port lacked:
    ``--sampler device``, ``--model gat|gatv2``, ``--bf16``, ``--remat``
    ``--feat_dtype bfloat16``, ``--shard_update`` and ``--shard_rules``
    are ported, so one process trains both parts with each; the sharded
    runs' weights are the replicated run's bit for bit."""
    monkeypatch.delenv("TPU_OPERATOR_DIST", raising=False)
    monkeypatch.delenv(RANK_ENV, raising=False)
    argv = _entry_argv(books[2], str(tmp_path)) + flags
    out = train_dist.main(argv)
    assert out["step"] > 0 and out["history"][-1]["val_acc"] >= 0
    assert np.isfinite([x for r in out["history"]
                        for x in r["losses"]]).all()
    if flags[0].startswith("--shard"):
        want = train_dist.main(_entry_argv(books[2], str(tmp_path)))
        for k, v in want["params"].items():
            assert torch.equal(out["params"][k], v), k


def test_entry_point_other_rank_checks_its_partition(books, tmp_path,
                                                     monkeypatch, capsys):
    """Without ``TPU_OPERATOR_DIST`` rank 0 drives every part; rank 1
    loads its partition and returns."""
    monkeypatch.delenv("TPU_OPERATOR_DIST", raising=False)
    monkeypatch.setenv(RANK_ENV, "1")
    assert train_dist.main(_entry_argv(books[2], str(tmp_path))) is None
    assert "rank 1: partition ok" in capsys.readouterr().out
