"""The port's ring-collective embedding access (``parallel/ring.py``)
against its sharded and dense forms and the JAX package's.

The cases of the JAX ``tests/test_ring.py`` on 8 shards in one process:
``ring_lookup`` equals ``sharded_lookup`` bit for bit (and, with null
ids, the dense lookup, and the JAX ring lookup on the same numpy table);
``ring_push_adagrad`` equals ``sharded_push_adagrad`` within 1e-6 and
leaves every untouched row's bits; both equal the dense push and the
JAX host reference. Two gloo ranks (``tests/torch_shard_worker.py``)
run both forms across processes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dgl_operator_tpu.parallel import embedding as jemb
from dgl_operator_tpu.parallel import ring as jring
from dgl_operator_tpu.parallel.mesh import make_mesh as j_make_mesh
from dgl_operator_tpu_torch.parallel.embedding import (ShardedTableSpec,
                                                       dense_lookup,
                                                       dense_push_adagrad,
                                                       pad_rows, route,
                                                       sharded_lookup,
                                                       sharded_push_adagrad)
from dgl_operator_tpu_torch.parallel.ring import (make_ring_embedding_ops,
                                                  ring_lookup,
                                                  ring_push_adagrad)
import torch_shard_worker as worker

NSHARD = 8
SPEC = ShardedTableSpec(num_rows=100, dim=16, num_shards=NSHARD)


def _table():
    rng = np.random.default_rng(0)
    return torch.from_numpy(pad_rows(rng.normal(size=(100, 16)),
                                     SPEC.padded_rows))


def _ids(seed, b, null=True):
    rng = np.random.default_rng(seed)
    n = NSHARD * b
    ids = rng.integers(0, SPEC.num_rows, size=n).astype(np.int64)
    if null:
        ids[3] = -1
    ids[n - 2] = ids[n - 1]        # a duplicate within one slot
    ids[n - 5] = ids[2]            # and across slots
    return ids.reshape(NSHARD, b)


def _route(ids):
    return route([ids.reshape(-1)], SPEC, 0).to("cpu")


def test_ring_lookup_matches_sharded_dense_and_jax():
    table = _table()
    ids = _ids(1, 4, null=False)
    got = make_ring_embedding_ops(SPEC).lookup(table, ids)
    want = sharded_lookup(table, _route(ids)).view(NSHARD, 4, 16)
    assert torch.equal(got, want)
    ids = _ids(1, 4)
    got = ring_lookup(table, ids, SPEC)
    assert torch.equal(got.view(-1, 16), dense_lookup(
        table, torch.from_numpy(ids.reshape(-1))))
    mesh = j_make_mesh(num_dp=NSHARD)
    jspec = jemb.ShardedTableSpec(num_rows=100, dim=16, num_shards=NSHARD)
    jtable = jemb.place_host_array(mesh, table.numpy(), P(jspec.axis))
    lookup = jring.make_ring_embedding_ops(mesh, jspec)[0]
    want = np.asarray(lookup(jtable, jnp.asarray(ids.reshape(-1),
                                                 jnp.int32)))
    np.testing.assert_allclose(got.view(-1, 16).numpy(), want, rtol=1e-6,
                               atol=1e-6)


def test_ring_push_matches_sharded():
    table = _table()
    ids = _ids(2, 4, null=False)
    grads = torch.from_numpy(np.random.default_rng(2).normal(
        size=(NSHARD, 4, 16)).astype(np.float32))
    state = torch.zeros(SPEC.padded_rows)
    st, ss = table.clone(), state.clone()
    sharded_push_adagrad(st, ss, grads.reshape(-1, 16), _route(ids), 0.1)
    rt, rs = table.clone(), state.clone()
    make_ring_embedding_ops(SPEC).push(rt, rs, ids, grads, 0.1)
    np.testing.assert_allclose(rt.numpy(), st.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rs.numpy(), ss.numpy(), rtol=0, atol=1e-6)
    untouched = np.setdiff1d(np.arange(SPEC.padded_rows), ids.reshape(-1))
    assert torch.equal(rt[untouched], table[untouched])
    assert torch.equal(rs[untouched], state[untouched])


def test_ring_push_matches_host_references():
    table = _table()
    ids = _ids(3, 2)
    grads = np.random.default_rng(3).normal(
        size=(NSHARD, 2, 16)).astype(np.float32)
    state = torch.zeros(SPEC.padded_rows)
    rt, rs = table.clone(), state.clone()
    ring_push_adagrad(rt, rs, ids, torch.from_numpy(grads), SPEC, 0.05)
    dt, ds = dense_push_adagrad(table, state, ids.reshape(-1),
                                torch.from_numpy(grads.reshape(-1, 16)),
                                0.05)
    np.testing.assert_allclose(rt.numpy(), dt.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rs.numpy(), ds.numpy(), rtol=1e-5, atol=1e-6)
    jt, js = jemb.dense_push_adagrad(
        table.numpy(), state.numpy(), ids.reshape(-1),
        grads.reshape(-1, 16), lr=0.05)
    np.testing.assert_allclose(rt.numpy(), np.asarray(jt), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(rs.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-5)


def test_two_ranks_ring_lookup_and_push(tmp_path):
    """Two gloo ranks of two shards each: the lookup equals the one
    process's bit for bit, the pushed tables and sums within 1e-6."""
    got = worker.run_two("ring_embedding", str(tmp_path / "e"))
    spec, table, state, ids, grads = worker.embedding_inputs()
    want = ring_lookup(table, ids, spec)
    t, s = table.clone(), state.clone()
    ring_push_adagrad(t, s, ids, grads, spec, worker.LR)
    rows = spec.padded_rows // 2
    for r, g in enumerate(got):
        assert torch.equal(g["lookup"], want[2 * r:2 * r + 2])
        mine = slice(r * rows, (r + 1) * rows)
        np.testing.assert_allclose(g["table"].numpy(), t[mine].numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(g["state"].numpy(), s[mine].numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", [3, 5])
def test_shards_must_split_over_the_processes(world):
    with pytest.raises(ValueError, match="do not split"):
        ring_lookup(_table(), _ids(1, 4), SPEC, 0, world)
