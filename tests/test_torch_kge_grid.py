"""The port's KGE grid, device negatives and clients against the JAX
package's ``DistKGETrainer``, on the CPU.

The JAX side runs on the conftest's 8 virtual devices, on
``make_mesh_2d(2, 2)`` (or ``make_mesh(4)``), from the same state as the
port (``kge_state_from_numpy``): synthetic FB15k at ``scale=1e-4``
(100 entities, so the pushes have long targets), ComplEx at dim 8, 6
steps. The limits are those of ``tests/test_torch_kge_dist.py``: mean
loss within rtol 1e-5, tables and Adagrad sums within 1e-4 of their
largest entry.

- The 2 x 2 grid with host negatives.
- Device negatives: the port's step is handed JAX's own draws
  (``jax.random.randint(fold_in(PRNGKey(seed_u), slot), ...)``) through
  ``device_step_from_draws``, on the grid and on a 1-D mesh, against
  JAX ``neg_sampler="device"``. The same draws as host negatives give
  the same bits (the device-built push plan sums what the host's does).
- The port's own draws: shape, range, distinct per (update, slot), and
  a coarse uniformity check; the device plan field for field against
  the host plan.
- ``num_client=2`` against JAX ``num_client=2`` (mean loss, ``updates``)
  and the ``ValueError`` of a dataset of the wrong rank count.
- A 1-D checkpoint resumed on the grid equals the uninterrupted grid run
  bit for bit.
- Two gloo ranks (``tests/torch_kge_grid_worker.py``) holding a 2 x 2
  grid (and a 1-D mesh with device negatives) against one process:
  losses within rtol 1e-6, tables within 1e-6 of their largest entry
  (the relation accumulator is summed ``(a0 + a1) + (a2 + a3)`` there).
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
from dgl_operator_tpu.parallel import make_mesh as jax_make_mesh
from dgl_operator_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from dgl_operator_tpu.runtime import kge as jax_runtime
from dgl_operator_tpu_torch.graph.kge_sampler import TrainDataset
from dgl_operator_tpu_torch.models.kge import kge_state_from_numpy
from dgl_operator_tpu_torch.ops.adagrad import device_push_plan, push_plan
from dgl_operator_tpu_torch.ops.kge_negatives import (draw_counters,
                                                      draw_negatives,
                                                      update_seed)
from dgl_operator_tpu_torch.parallel.bootstrap import RANK_ENV
from dgl_operator_tpu_torch.parallel.mesh import (axis_size,
                                                  local_dp_rank_slices,
                                                  make_mesh, make_mesh_2d,
                                                  make_train_mesh, my_slots)
from dgl_operator_tpu_torch.runtime.kge import DistKGETrainer, KGETrainConfig
import torch_kge_grid_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_kge_grid_worker.py")
CHILD_TIMEOUT_S = 120
STATE = ("entity", "entity_state", "relation", "relation_state")
JAX_FIELDS = ("lr", "max_step", "batch_size", "neg_sample_size",
              "neg_chunk_size", "log_interval", "seed", "neg_sampler",
              "num_client")


def _jax_mesh(shape):
    return (jax_make_mesh(num_dp=shape[0]) if len(shape) == 1
            else jax_make_mesh_2d(*shape))


def _datasets(ranks):
    ds = worker.dataset()
    return ds, (TrainDataset(ds.train, ds.n_entities, ds.n_relations,
                             ranks=ranks),
                jax_sampler.TrainDataset(ds.train, ds.n_entities,
                                         ds.n_relations, ranks=ranks))


def _jax_run(shape, **fields):
    """The JAX trainer on ``shape``: its initial state, result and final
    state."""
    ds = worker.dataset()
    cfg, tcfg = worker.configs(ds, **fields)
    jt = jax_runtime.DistKGETrainer(
        jax_models.KGEConfig(**vars(cfg)),
        jax_runtime.KGETrainConfig(**{k: getattr(tcfg, k)
                                      for k in JAX_FIELDS}),
        _jax_mesh(shape))
    sd0 = jt.state_dict()
    n = int(np.prod(shape)) * tcfg.num_client
    out = jt.train(_datasets(n)[1][1])
    return sd0, out, jt.state_dict()


@pytest.fixture(scope="module")
def jax_runs():
    return {"grid_host": _jax_run((2, 2)),
            "grid_device": _jax_run((2, 2), neg_sampler="device"),
            "line_device": _jax_run((4,), neg_sampler="device"),
            "grid_clients": _jax_run((2, 2), num_client=2)}


def _close(got, want):
    for k in STATE:
        assert got[k].shape == want[k].shape, k
        assert np.abs(got[k] - want[k]).max() <= 1e-4 * np.abs(
            want[k]).max(), k


def _port(shape, sd0=None, **fields):
    ds = worker.dataset()
    cfg, tcfg = worker.configs(ds, **fields)
    tr = DistKGETrainer(cfg, tcfg, device="cpu", mesh=worker.mesh_of(shape))
    if sd0 is not None:
        tr.load_state_dict(kge_state_from_numpy(sd0))
    return tr


def _jax_draws(tr, seed_u):
    """JAX's device negatives of one update, every slot (dp-major)."""
    t = tr.tcfg
    shape = (t.batch_size // t.chunk, t.neg_sample_size)
    return np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(jax.random.PRNGKey(seed_u), s), shape, 0,
        tr.cfg.n_entities, dtype=np.int32)) for s in range(tr.nslots)])


def _drive(tr, draws_of, host_negs=False):
    """``tr``'s 6 steps by hand, each update's negatives
    ``draws_of(seed_u)``; with ``host_negs`` the same draws go in as the
    batches' host negatives of a host-negative trainer."""
    t, K = tr.tcfg, tr.num_client
    _, (td, _) = _datasets(tr.nslots * K)
    iters = tr.iterators(td)
    if host_negs:
        tr.device_negs = False          # a host-negative twin
    losses = []
    for step in range(t.max_step):
        for c in range(K):
            seed_u = update_seed(t.seed, step, K, c)
            bs = [next(iters[s * K + c]) for s in range(tr.nslots)]
            draws = draws_of(seed_u)
            if host_negs:
                for b, d in zip(bs, draws):
                    b.neg_ids = d
                losses.append(tr.device_step(tr.host_step(bs)))
            else:
                losses.append(tr.device_step_from_draws(
                    tr.host_step(bs, seed_u), draws))
    return [float(x) for x in losses]


# ---------------------------------------------------------------- meshes
def test_mesh_layout_and_slots():
    g = make_mesh_2d(2, 3)
    assert (g.size, g.num_shards, g.replicas) == (6, 3, 2)
    line = make_mesh(4)
    assert (line.axis_names, line.num_shards, line.replicas) == (
        ("dp",), 4, 1)
    assert axis_size(g, "mp") == 3
    assert local_dp_rank_slices(g, 7) == (slice(0, 3), slice(3, 6))
    assert my_slots(g, 1, 2) == [3, 4, 5]
    assert my_slots(line, 1, 2) == [2, 3]
    with pytest.raises(ValueError, match="whole dp rows"):
        my_slots(g, 0, 3)
    tp = make_train_mesh(2, tp_axis_size=2)
    assert (tp.axis_names, tp.size, tp.num_shards) == (("dp", "mp"), 4, 2)
    assert make_train_mesh(3).shape == {"dp": 3}


# ------------------------------------------------------------- JAX parity
def test_grid_matches_jax(jax_runs):
    sd0, jout, jsd = jax_runs["grid_host"]
    tr = _port((2, 2), sd0)
    out = tr.train(_datasets(4)[1][0])
    assert tr.mesh.num_shards == 2 and tr.spec.num_shards == 2
    assert out["loss"] == pytest.approx(jout["loss"], rel=1e-5)
    _close(tr.state_dict(), jsd)


@pytest.mark.parametrize("name,shape", [("grid_device", (2, 2)),
                                        ("line_device", (4,))])
def test_device_negatives_from_jax_draws_match_jax(jax_runs, name, shape):
    sd0, jout, jsd = jax_runs[name]
    tr = _port(shape, sd0, neg_sampler="device")
    losses = _drive(tr, lambda u: _jax_draws(tr, u))
    assert np.mean(losses[-50:]) == pytest.approx(jout["loss"], rel=1e-5)
    _close(tr.state_dict(), jsd)
    # the same draws as host negatives: the device plan sums what the
    # host plan sums, in the same order
    twin = _port(shape, sd0, neg_sampler="device")
    assert _drive(twin, lambda u: _jax_draws(twin, u),
                  host_negs=True) == losses
    for k, v in twin.state_dict().items():
        np.testing.assert_array_equal(v, tr.state_dict()[k], k)


def test_clients_match_jax(jax_runs):
    sd0, jout, jsd = jax_runs["grid_clients"]
    tr = _port((2, 2), sd0, num_client=2)
    out = tr.train(_datasets(8)[1][0])
    assert out["updates"] == jout["updates"] == 12
    assert len(out["losses"]) == 12
    assert out["loss"] == pytest.approx(jout["loss"], rel=1e-5)
    _close(tr.state_dict(), jsd)
    with pytest.raises(ValueError, match="num_client"):
        tr.train(_datasets(4)[1][0])


# ------------------------------------------------------------- the draws
def test_port_draws_range_shape_and_spread():
    cnt = draw_counters(4, 64, "cpu")
    a = draw_negatives(update_seed(0, 3, 2, 1), [0, 1, 2], cnt, 4, 1000)
    assert a.shape == (3, 4, 64) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < 1000
    b = draw_negatives(update_seed(0, 3, 2, 1), [0, 1, 2], cnt, 4, 1000)
    assert torch.equal(a, b)
    seen = set()
    for u in range(6):
        d = draw_negatives(update_seed(5, u, 1, 0), range(4), cnt, 4, 1000)
        for s in range(4):
            key = d[s].numpy().tobytes()
            assert key not in seen
            seen.add(key)
    n = 10
    big = draw_negatives(7, [0], draw_counters(1, 200_000, "cpu"), 1, n)
    hist = np.bincount(big.numpy().reshape(-1), minlength=n)
    assert np.abs(hist / hist.sum() - 1 / n).max() < 0.05 / n
    assert update_seed(2**40, 1, 2, 1) < 2**31 - 1


def test_device_plan_equals_host_plan():
    rng = np.random.default_rng(0)
    for trial in range(20):
        m = int(rng.integers(1, 300))
        ids = rng.integers(-1 if trial % 2 else 0, int(rng.integers(1, 40)),
                           m)
        hp, dp = push_plan(ids), device_push_plan(torch.from_numpy(ids))
        u, nnz = hp.num_rows, int(hp.scatter.offsets[-1])
        n_long, n_chunk = len(hp.scatter.long_rows), hp.scatter.num_chunks
        assert dp.num_rows == m + 1
        np.testing.assert_array_equal(dp.rows[:u].numpy(), hp.rows)
        assert int(dp.rows[u:].abs().sum()) == 0
        off = dp.scatter.offsets.numpy()
        np.testing.assert_array_equal(off[:u + 1], hp.scatter.offsets)
        assert (off[u + 1:] == nnz).all()
        np.testing.assert_array_equal(dp.scatter.src.numpy()[:nnz],
                                      hp.scatter.src)
        np.testing.assert_array_equal(
            dp.scatter.long_rows.numpy()[:n_long], hp.scatter.long_rows)
        assert (dp.scatter.long_rows.numpy()[n_long:] == m).all()
        np.testing.assert_array_equal(
            dp.scatter.long_part.numpy()[:n_long + 1], hp.scatter.long_part)
        np.testing.assert_array_equal(dp.scatter.chunks.numpy()[:n_chunk],
                                      hp.scatter.chunks)
        pad = dp.scatter.chunks.numpy()[n_chunk:]
        assert (pad[:, 0] == pad[:, 1]).all()


def test_device_step_packs_no_negatives():
    tr = _port((2, 2), neg_sampler="device")
    _, (td, _) = _datasets(4)
    it = tr.iterators(td)
    bs = [next(x) for x in it]
    assert all(b.neg_ids.size == 0 for b in bs)
    hs = tr.host_step(bs, 11)
    host = _port((2, 2))
    hb = [next(x) for x in host.iterators(td)]
    assert hs.ent_route is None and hs.shapes[0] == (4 * 2 * 32,)
    assert hs.buf.numel() < host.host_step(hb).buf.numel()
    with pytest.raises(ValueError, match="seed"):
        tr.host_step(bs)


def test_validate_rejects_unknown_sampler():
    with pytest.raises(ValueError):
        KGETrainConfig(neg_sampler="Device")
    with pytest.raises(ValueError):
        KGETrainConfig(num_client=0)
    with pytest.raises(TypeError, match="cannot coerce"):
        KGETrainConfig(shard_rules=(("relation", 7),))
    assert KGETrainConfig(shard_rules=(("relation", "dp"),)).shard_rules


# ---------------------------------------------------------------- resume
def test_line_checkpoint_resumes_on_the_grid(tmp_path):
    want = _port((2, 2), None)
    wout = want.train(_datasets(4)[1][0])
    ck = str(tmp_path / "ckpt")
    first = _port((4,), None, max_step=3, ckpt_dir=ck, ckpt_every=3)
    first.train(_datasets(4)[1][0])
    resumed = _port((2, 2), None, ckpt_dir=ck)
    out = resumed.train(_datasets(4)[1][0])
    assert out["start_step"] == 3
    assert out["losses"] == wout["losses"][3:]
    for k, v in resumed.state_dict().items():
        np.testing.assert_array_equal(v, want.state_dict()[k], k)


# ---------------------------------------------------------- two processes
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("kge_grid_ranks"))
    hosts = os.path.join(tmp, "hosts")
    port = _free_port()
    with open(hosts, "w") as f:
        f.write(f"127.0.0.1 {port} kge-worker-0 slots=1\n"
                f"127.0.0.1 {port} kge-worker-1 slots=1\n")
    spec = {"hostfile": hosts, "out": os.path.join(tmp, "result")}
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
    return results


@pytest.fixture(scope="module")
def single():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name in worker.JOBS:
            out.update(worker.run_job(name))
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(worker.JOBS))
def test_two_ranks_match_one_process(two_ranks, single, name):
    for r, got in enumerate(two_ranks):
        assert got[f"{name}/my_slots"].tolist() == [2 * r, 2 * r + 1]
        assert int(got[f"{name}/updates"]) == int(single[f"{name}/updates"])
        np.testing.assert_allclose(got[f"{name}/losses"],
                                   single[f"{name}/losses"], rtol=1e-6)
        for k in STATE:
            w = single[f"{name}/state/{k}"]
            assert np.abs(got[f"{name}/state/{k}"] - w).max() <= 1e-6 * max(
                np.abs(w).max(), 1e-30), (name, k)
