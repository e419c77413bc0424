"""The port's sharded KGE training against the JAX package's and across
processes, on the CPU.

- ``parallel/embedding.py``: a route over 4 shards in one process gives
  ``table[ids]`` exactly and the push equals ``dense_push_adagrad``
  exactly (the same sums in the same order).
- ``DistKGETrainer`` with 4 in-process slots from the JAX
  ``DistKGETrainer``'s state on ``make_mesh(num_dp=4)`` (through
  ``kge_state_from_numpy``), 6 steps: mean loss within rtol 1e-5, final
  tables and Adagrad sums within 1e-4 of their largest entry (float32
  rounding carried forward by Adagrad). The relation update is the
  slots' summed gradient divided by 4, as in the JAX step; the same run
  without the division is farther from the JAX tables than the
  tolerance.
- ``sharded_ranking_eval`` raw and filtered equals ``full_ranking_eval``
  on the same tables and the JAX ``sharded_ranking_eval`` (equal MR and
  Hits, MRR within 1e-12).
- Checkpoint resume: a 2-slot run cut after 3 of 6 steps and resumed
  equals the uninterrupted run bit for bit.
- Two gloo ranks (``tests/torch_kge_mp_worker.py``), one slot each,
  equal the single process bit for bit (losses, tables, Adagrad sums,
  ranking metrics, the resumed run, and the entry point's losses and
  saved tables). With 4 slots on 2 ranks the relation accumulator is
  summed ``(a0 + a1) + (a2 + a3)`` against ``((a0 + a1) + a2) + a3``:
  losses within rtol 1e-6 and tables within 1e-6 of their largest
  entry.
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

from dgl_operator_tpu.graph import kge_sampler as jax_sampler
from dgl_operator_tpu.models import kge as jax_models
from dgl_operator_tpu.parallel import make_mesh
from dgl_operator_tpu.runtime import kge as jax_runtime
from dgl_operator_tpu_torch.examples import partition_kg
from dgl_operator_tpu_torch.graph.kge_sampler import TrainDataset
from dgl_operator_tpu_torch.models.kge import KGEModel, kge_state_from_numpy
from dgl_operator_tpu_torch.parallel.bootstrap import RANK_ENV
from dgl_operator_tpu_torch.parallel.embedding import (ShardedTableSpec,
                                                       dense_push_adagrad,
                                                       route, sharded_lookup,
                                                       sharded_push_adagrad)
from dgl_operator_tpu_torch.runtime.kge import (DistKGETrainer, build_filter,
                                                full_ranking_eval)
import torch_kge_mp_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_kge_mp_worker.py")
CHILD_TIMEOUT_S = 180
KILL_AT = 3
STATE = ("entity", "entity_state", "relation", "relation_state")


def _jax_trainer(num_dp, **fields):
    ds = worker.dataset()
    cfg, tcfg = worker.configs(ds, **fields)
    jcfg = jax_models.KGEConfig(**vars(cfg))
    jtcfg = jax_runtime.KGETrainConfig(**{
        k: getattr(tcfg, k) for k in ("lr", "max_step", "batch_size",
                                      "neg_sample_size", "neg_chunk_size",
                                      "log_interval", "seed")})
    return ds, cfg, tcfg, jax_runtime.DistKGETrainer(
        jcfg, jtcfg, make_mesh(num_dp=num_dp))


def test_route_in_one_process_is_the_dense_lookup_and_push():
    rng = np.random.default_rng(0)
    spec = ShardedTableSpec(num_rows=37, dim=5, num_shards=4)
    table = torch.from_numpy(rng.normal(size=(spec.padded_rows, 5))
                             .astype(np.float32))
    state = torch.from_numpy(rng.random(spec.padded_rows).astype(np.float32))
    slots = [rng.integers(0, 37, 20) for _ in range(4)]
    ids = np.concatenate(slots)
    rt = route([ids], spec, 0).to("cpu")
    assert rt.world == 1
    torch.testing.assert_close(sharded_lookup(table, rt),
                               table[torch.from_numpy(ids)], rtol=0, atol=0)
    grads = torch.from_numpy(rng.normal(size=(len(ids), 5)).astype(
        np.float32))
    want_t, want_s = dense_push_adagrad(table, state, ids, grads, lr=0.3)
    sharded_push_adagrad(table, state, grads, rt, lr=0.3)
    torch.testing.assert_close(table, want_t, rtol=0, atol=0)
    torch.testing.assert_close(state, want_s, rtol=0, atol=0)


def test_route_splits_requests_by_owner():
    spec = ShardedTableSpec(num_rows=10, dim=2, num_shards=2)  # rps 5
    reqs = [np.array([7, 1, 5, 2, 9]), np.array([0, 6, 6])]
    rt0, rt1 = (route(reqs, spec, r) for r in (0, 1))
    np.testing.assert_array_equal(rt0.serve, [1, 2, 0])
    np.testing.assert_array_equal(rt1.serve, [2, 0, 4, 1, 1])
    assert (rt0.serve_counts, rt0.recv_counts) == ([2, 1], [2, 3])
    assert (rt1.serve_counts, rt1.recv_counts) == ([3, 2], [1, 2])
    np.testing.assert_array_equal(reqs[0][rt0.order], [1, 2, 7, 5, 9])
    np.testing.assert_array_equal(rt0.order[rt0.unorder], np.arange(5))
    with pytest.raises(ValueError):
        route([np.array([10])], spec, 0)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX ``DistKGETrainer`` on 4 slots: its initial state, its run
    and its final state and tables."""
    ds, cfg, tcfg, jt = _jax_trainer(4)
    sd0 = jt.state_dict()
    out = jt.train(jax_sampler.TrainDataset(ds.train, ds.n_entities,
                                            ds.n_relations, ranks=4))
    return sd0, out, jt.state_dict(), jt


def _port_run(sd0):
    ds = worker.dataset()
    tr = DistKGETrainer(*worker.configs(ds), num_slots=4, device="cpu")
    tr.load_state_dict(kge_state_from_numpy(sd0))
    out = tr.train(TrainDataset(ds.train, ds.n_entities, ds.n_relations,
                                ranks=4))
    return tr, out


def test_dist_trainer_four_slots_matches_jax(jax_run):
    sd0, jout, jsd, _ = jax_run
    tr, out = _port_run(sd0)
    assert tr.my_slots == [0, 1, 2, 3] and len(out["losses"]) == 6
    assert out["loss"] == pytest.approx(jout["loss"], rel=1e-5)
    sd = tr.state_dict()
    for k in STATE:
        assert sd[k].shape == jsd[k].shape
        assert np.abs(sd[k] - jsd[k]).max() <= 1e-4 * np.abs(jsd[k]).max(), k


def test_relation_gradient_is_divided_by_the_slots(jax_run):
    """The JAX step divides the relation accumulator by the slot count;
    undivided, the port's relation table leaves the tolerance."""
    sd0, _, jsd, _ = jax_run
    ds = worker.dataset()
    tr = DistKGETrainer(*worker.configs(ds), num_slots=4, device="cpu")
    tr.load_state_dict(kge_state_from_numpy(sd0))
    assert tr.rel_divisor == 4
    tr.rel_divisor = 1
    tr.train(TrainDataset(ds.train, ds.n_entities, ds.n_relations, ranks=4))
    rel = tr.state_dict()["relation"]
    assert np.abs(rel - jsd["relation"]).max() > 1e-4 * np.abs(
        jsd["relation"]).max()


@pytest.mark.parametrize("filtered", [False, True])
def test_sharded_ranking_eval_equals_full_and_jax(jax_run, filtered):
    _, _, jsd, jt = jax_run
    ds = worker.dataset()
    cfg, tcfg = worker.configs(ds)
    tr = DistKGETrainer(cfg, tcfg, num_slots=4, device="cpu")
    tr.load_state_dict(kge_state_from_numpy(jsd))
    ev = tuple(a[:worker.EVAL_TRIPLES] for a in ds.test)
    everything = tuple(np.concatenate(x) for x in zip(ds.train, ds.test))
    filt = build_filter(everything, ds.n_entities) if filtered else None
    got = tr.sharded_ranking_eval(ev, batch_size=32, filters=filt)
    full = full_ranking_eval(KGEModel(cfg), tr.gathered_params(), ev,
                             batch_size=32, filters=filt)
    want = jt.sharded_ranking_eval(
        ev, batch_size=32,
        filters=jax_runtime.build_filter(everything, ds.n_entities)
        if filtered else None)
    for other in (full, want):
        for k in ("MR", "HITS@1", "HITS@3", "HITS@10"):
            assert got[k] == other[k], k
        assert got["MRR"] == pytest.approx(other["MRR"], rel=1e-12)


def test_state_dict_round_trips_through_jax(jax_run):
    _, _, jsd, jt = jax_run
    ds = worker.dataset()
    tr = DistKGETrainer(*worker.configs(ds), num_slots=2, device="cpu")
    tr.load_state_dict(kge_state_from_numpy(jsd))
    sd = tr.state_dict()
    jt.load_state_dict(sd)
    back = jt.state_dict()
    for k in STATE:
        np.testing.assert_array_equal(sd[k], jsd[k])
        np.testing.assert_array_equal(back[k], jsd[k])
    assert tr.entity.shape == (tr.spec.padded_rows, 16)


def test_resume_is_bit_exact(tmp_path):
    want = worker.run_job(2, "s2")
    got = worker.run_cut_and_resumed(str(tmp_path / "ckpt"), KILL_AT)
    assert int(got["resumed/start_step"]) == KILL_AT
    np.testing.assert_array_equal(got["resumed/losses"],
                                  want["s2/losses"][KILL_AT:])
    for k in STATE:
        np.testing.assert_array_equal(got[f"resumed/state/{k}"],
                                      want[f"s2/state/{k}"])


# ---------------------------------------------------------- two processes
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _hostfile(path):
    port = _free_port()
    with open(path, "w") as f:
        f.write(f"127.0.0.1 {port} kge-worker-0 slots=1\n"
                f"127.0.0.1 {port} kge-worker-1 slots=1\n")
    return path


def _entry_argv(book):
    return ["--graph_name", "kg", "--part_config", book, "--hidden_dim",
            "16", "--gamma", "12", "--lr", "0.1", "--batch_size", "64",
            "--neg_sample_size", "16", "--neg_chunk_size", "16",
            "--max_step", "6", "--log_interval", "3", "-adv", "--num_dp",
            "2", "--device", "cpu", "--eval"]


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("kgbook"))
    return partition_kg.main(["--workspace", ws, "--num_parts", "2",
                              "--dataset_scale", "0.02"])


@pytest.fixture(scope="module")
def single(book, tmp_path_factory):
    """The single-process port on every job, one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = str(tmp_path_factory.mktemp("single"))
        out = {}
        for slots in (2, 4):
            out.update(worker.run_job(slots, f"s{slots}"))
        out.update(worker.run_cut_and_resumed(os.path.join(tmp, "ckpt"),
                                              KILL_AT))
        from dgl_operator_tpu_torch.examples import train_kge
        save = os.path.join(tmp, "save")
        out.update(worker.entry_arrays(
            train_kge.main(_entry_argv(book) + ["--save_path", save]),
            save, 0))
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def two_ranks(book, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("kge_ranks"))
    spec = {"hostfile": _hostfile(os.path.join(tmp, "hosts")),
            "hostfile2": _hostfile(os.path.join(tmp, "hosts2")),
            "ckpt_dir": os.path.join(tmp, "ckpt"), "kill_at": KILL_AT,
            "save": os.path.join(tmp, "save"), "argv": _entry_argv(book),
            "out": os.path.join(tmp, "result")}
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


@pytest.mark.parametrize("key", ["s2/losses", "s2/eval_raw",
                                 "s2/eval_filtered", "resumed/losses",
                                 "resumed/start_step", "entry/losses",
                                 "entry/mrr"]
                         + [f"s2/state/{k}" for k in STATE]
                         + [f"resumed/state/{k}" for k in STATE]
                         + ["entry/saved/entity", "entry/saved/relation"])
def test_two_ranks_equal_one_process_bit_for_bit(two_ranks, single, key):
    for got in two_ranks[1]:
        np.testing.assert_array_equal(got[key], single[key], key)


def test_two_ranks_hold_their_slots_and_log(two_ranks):
    outs, results = two_ranks
    for r, got in enumerate(results):
        assert got["s2/my_slots"].tolist() == [r]
        assert got["s4/my_slots"].tolist() == [2 * r, 2 * r + 1]
        assert f"[{r}][Train](6/6) average loss:" in outs[r]
        assert f"rank {r}: trained 6 steps" in outs[r]


def test_four_slots_on_two_ranks_match_one_process(two_ranks, single):
    for got in two_ranks[1]:
        np.testing.assert_allclose(got["s4/losses"], single["s4/losses"],
                                   rtol=1e-6)
        for k in STATE:
            w = single[f"s4/state/{k}"]
            assert np.abs(got[f"s4/state/{k}"] - w).max() <= 1e-6 * max(
                np.abs(w).max(), 1e-30), k
