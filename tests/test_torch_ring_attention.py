"""The port's ring attention (``parallel/ring_attention.py``) and hub
attention (``models/gat.py``) against their dense forms and the JAX
package's.

The cases of the JAX ``tests/test_ring_attention.py`` on the port: the
ring forms (dot and GAT, values and gradients) within 1e-5 of the dense
ones over 8 shards, the ``auto`` rule and its dispatch, the all-masked
row, the dense forms within 1e-5 of the JAX ones on the same numpy
inputs, ``gat_hub_attention`` within 1e-4 of the full-graph ``GATConv``
layer and of the JAX hub attention on the same flax weights, and
``bucket_by_degree``'s bands equal to the JAX ones. A two-rank gloo
group runs the ring and the gathered form across processes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph.graph import Graph as JGraph
from dgl_operator_tpu.models.gat import bucket_by_degree as j_bucket
from dgl_operator_tpu.models.gat import gat_hub_attention as j_hub
from dgl_operator_tpu.nn import GATConv as JGATConv
from dgl_operator_tpu.parallel import make_mesh_2d
from dgl_operator_tpu.parallel import ring_attention as jra
from dgl_operator_tpu_torch.graph.graph import Graph
from dgl_operator_tpu_torch.models.gat import (bucket_by_degree,
                                              gat_hub_attention)
from dgl_operator_tpu_torch.nn.conv import GATConv
from dgl_operator_tpu_torch.parallel import ring_attention as ra
import torch_shard_worker as worker

N, S, H, DK, DV, SHARDS = (worker.N, worker.S, worker.H, worker.DK,
                           worker.DV, worker.SHARDS)
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mask(seed, all_masked_row=None):
    m = (np.random.default_rng(seed).random((N, S)) < 0.7)
    m[:, :8] = True
    if all_masked_row is not None:
        m[all_masked_row, :] = False
    return m.astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _dot_inputs():
    return tuple(t.numpy() for t in worker.attention_inputs())


def test_ring_dot_matches_dense_and_jax():
    arrs = _dot_inputs()
    out = ra.make_ring_attention(SHARDS, "dot")(*_t(*arrs))
    ref = ra.dense_dot_attention(*_t(*arrs))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    want = jra.dense_dot_attention(*[jnp.asarray(a) for a in arrs])
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **TOL)


def test_use_ring_rule_memory_and_crossover():
    """The JAX rule's cases: small inputs stay dense, a blown budget or a
    crossover measured on this platform flips to ring."""
    big = 10**18
    none = {"crossover_s": None}
    assert ra.use_ring(64, 1024, 4, 32, 32, budget_bytes=big,
                       crossover=none) is False
    assert ra.use_ring(64, 1024, 4, 32, 32, budget_bytes=1,
                       crossover=none) is True
    rec = {"crossover_s": 4096, "shape": {"N": 64, "H": 4}}
    assert ra.use_ring(64, 4096, 4, 32, 32, budget_bytes=big,
                       crossover=rec) is True
    assert ra.use_ring(64, 2048, 4, 32, 32, budget_bytes=big,
                       crossover=rec) is False
    assert ra.use_ring(2, 4096, 4, 32, 32, budget_bytes=big,
                       crossover=rec) is False
    assert ra.use_ring(32, 8192, 4, 32, 32, budget_bytes=big,
                       crossover=rec) is True
    rec8 = {"crossover_s": 4096, "shape": {"N": 64, "H": 4, "shards": 8}}
    assert ra.use_ring(64, 4096, 4, 32, 32, budget_bytes=big,
                       crossover=rec8, nshard=2) is False
    assert ra.use_ring(64, 4096, 4, 32, 32, budget_bytes=big,
                       crossover=rec8, nshard=8) is True
    assert ra.use_ring(64, 4096, 4, 32, 32, budget_bytes=big,
                       crossover=rec, nshard=2) is True
    for args in ((64, 2048, 4, 32, 32), (1, 1, 1, 3, 5)):
        assert ra.dense_attention_bytes(*args) == \
            jra.dense_attention_bytes(*args)
    assert ra.dense_attention_bytes(64, 2048, 4, 32, 32) == \
        2 * ra.dense_attention_bytes(64, 1024, 4, 32, 32)


def test_crossover_record_is_the_ports_own(tmp_path, monkeypatch):
    """The rule reads only a record written by the port
    (``write_crossover``, the smoke's), per platform; with none, or none
    for this platform, the memory rule alone decides."""
    path = str(tmp_path / "rec.json")
    monkeypatch.setenv(ra.RING_RECORD_ENV, path)
    assert ra.recorded_crossover("cpu") is None
    shape = {"N": 64, "H": 4, "shards": 8}
    ra.write_crossover("cuda", 4096, shape)
    ra.write_crossover("other", None, shape)
    assert ra.recorded_crossover("cuda") == {"crossover_s": 4096,
                                             "shape": shape}
    assert ra.recorded_crossover("cpu") is None
    assert ra.recorded_crossover("other") is None
    ra.write_crossover("cpu", 4096, shape)
    assert ra.use_ring(64, 4096, 4, 32, 32, budget_bytes=10**18,
                       nshard=8) is True
    assert ra.use_ring(64, 2048, 4, 32, 32, budget_bytes=10**18,
                       nshard=8) is False


def test_ring_shard_holds_one_block_of_the_dense_footprint():
    """The memory claim in the byte model: a ring shard's share of the
    dense footprint is 1/num_shards, and a budget between the two makes
    the rule choose ring."""
    n, s, h, dk, dv = 32, 4096, 2, 8, 8
    dense = ra.dense_attention_bytes(n, s, h, dk, dv)
    shard = ra.dense_attention_bytes(n, s // SHARDS, h, dk, dv)
    assert dense == SHARDS * shard
    assert ra.use_ring(n, s, h, dk, dv, budget_bytes=(dense + shard) // 2,
                       crossover={}, nshard=SHARDS) is True


def test_auto_mode_dispatches_and_matches(monkeypatch):
    monkeypatch.setenv(ra.RING_RECORD_ENV, "/nonexistent/ring.json")
    arrs = _t(*_dot_inputs())
    ref = ra.dense_dot_attention(*arrs)
    auto = ra.make_ring_attention(SHARDS, "auto")
    calls = []
    real = ra.ring_dot_attention
    monkeypatch.setattr(ra, "ring_dot_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("DGL_TPU_ATTN_BUDGET_BYTES", str(10**18))
    np.testing.assert_allclose(auto(*arrs).numpy(), ref.numpy(), **TOL)
    assert not calls
    monkeypatch.setenv("DGL_TPU_ATTN_BUDGET_BYTES", "1")
    np.testing.assert_allclose(auto(*arrs).numpy(), ref.numpy(), **TOL)
    assert calls


def test_ring_gat_matches_dense_and_jax():
    el, er, v, mask = (_rand((N, S, H), 4), _rand((N, H), 5),
                       _rand((N, S, H, DV), 6), _mask(7))
    out = ra.make_ring_attention(SHARDS, "gat", negative_slope=0.2)(
        *_t(el, er, v, mask))
    ref = ra.dense_gat_attention(*_t(el, er, v, mask))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    want = jra.dense_gat_attention(*[jnp.asarray(a)
                                     for a in (el, er, v, mask)])
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **TOL)


def test_all_masked_row_yields_zero():
    q, k, v, _ = _dot_inputs()
    mask = _mask(3, all_masked_row=5)
    out = ra.ring_dot_attention(*_t(q, k, v, mask), SHARDS).numpy()
    assert np.all(out[5] == 0.0) and np.all(np.isfinite(out))
    ref = ra.dense_dot_attention(*_t(q, k, v, mask)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("form", ["dot", "gat"])
def test_ring_gradients_match_dense(form):
    """Autograd through the ring agrees with the dense form."""
    if form == "dot":
        arrs = _dot_inputs()
        ring = ra.make_ring_attention(SHARDS, "dot")
        dense = ra.dense_dot_attention
    else:
        arrs = (_rand((N, S, H), 4), _rand((N, H), 5),
                _rand((N, S, H, DV), 6), _mask(7))
        ring = ra.make_ring_attention(SHARDS, "gat")
        dense = ra.dense_gat_attention
    grads = []
    for fn in (ring, dense):
        xs = [torch.from_numpy(a).requires_grad_() for a in arrs[:3]]
        (fn(*xs, torch.from_numpy(arrs[3])) ** 2).sum().backward()
        grads.append([x.grad.numpy() for x in xs])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, **TOL)


def _hub_graph(seed, n, edges, hub, burst, isolated):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, edges).astype(np.int32)
    dst = rng.integers(0, n - 1 if isolated else n, edges).astype(np.int32)
    src = np.concatenate([src, rng.integers(0, n, burst).astype(np.int32)])
    dst = np.concatenate([dst, np.full(burst, hub, np.int32)])
    x = rng.normal(size=(n, 8)).astype(np.float32)
    return src, dst, x


def _gat_pair(src, dst, n, x, out_feats):
    """The JAX ``GATConv``'s flax params and full-graph output, and the
    port's ``GATConv`` holding the same weights."""
    jg = JGraph(src, dst, n)
    layer = JGATConv(out_feats=out_feats, num_heads=2, concat_heads=True)
    params = layer.init(jax.random.PRNGKey(0), jg.to_device(),
                        jnp.asarray(x))
    full = np.asarray(layer.apply(params, jg.to_device(), jnp.asarray(x)))
    conv = GATConv(8, out_feats, num_heads=2, device="cpu")
    p = params["params"]
    with torch.no_grad():
        conv.fc.weight.copy_(torch.from_numpy(
            np.asarray(p["fc"]["kernel"]).T.copy()))
        conv.attn_l.copy_(torch.from_numpy(np.array(p["attn_l"])))
        conv.attn_r.copy_(torch.from_numpy(np.array(p["attn_r"])))
    return jg, p, full, conv


def test_gat_hub_attention_matches_full_graph_layer():
    """Hub attention, from the port's layer and from the flax weights,
    reproduces the full-graph ``GATConv`` on the rows it computes (a hub
    and a zero-in-degree node among them) and the JAX hub attention."""
    n = 100
    src, dst_e, x = _hub_graph(3, n, 600, 7, 80, isolated=True)
    jg, params, full, conv = _gat_pair(src, dst_e, n, x, 6)
    g = Graph(src, dst_e, n)
    assert np.diff(g.csc()[0])[n - 1] == 0
    dst = np.asarray([7, 0, 5, n - 1], np.int64)
    xt = torch.from_numpy(x)
    out = gat_hub_attention(conv, g, xt, dst, SHARDS).numpy()
    assert np.all(out[3] == 0.0)
    np.testing.assert_allclose(out, full[dst], rtol=1e-4, atol=1e-4)
    flax_out = gat_hub_attention(params, g, xt, dst, SHARDS).numpy()
    np.testing.assert_allclose(flax_out, full[dst], rtol=1e-4, atol=1e-4)
    want = j_hub(params, jg, jnp.asarray(x), dst, make_mesh_2d(1, 8))
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_bucket_by_degree_bands_and_coverage():
    n = 120
    src, dst_e, x = _hub_graph(5, n, 500, 3, 200, isolated=False)
    g = Graph(src, dst_e, n)
    dst = np.arange(0, 40, dtype=np.int64)
    buckets = bucket_by_degree(g, dst, growth=4.0)
    want = j_bucket(JGraph(src, dst_e, n), dst, growth=4.0)
    assert [b.tolist() for b in buckets] == [b.tolist() for b in want]
    np.testing.assert_array_equal(np.sort(np.concatenate(buckets)),
                                  np.sort(dst))
    indptr = g.csc()[0]
    for b in buckets:
        degs = np.maximum((indptr[b + 1] - indptr[b]).astype(np.int64), 1)
        assert degs.max() <= degs.min() * 4.0
    assert [len(b) for b in bucket_by_degree(g, dst, max_batch=3)][0] <= 3
    with pytest.raises(ValueError, match="growth"):
        bucket_by_degree(g, dst, growth=0.5)
    _, _, full, conv = _gat_pair(src, dst_e, n, x, 4)
    for b in buckets:
        out = gat_hub_attention(conv, g, torch.from_numpy(x), b, SHARDS)
        np.testing.assert_allclose(out.numpy(), full[b], rtol=1e-4,
                                   atol=1e-4)


def test_gat_matches_fanout_gatconv_softmax():
    el, er, v, mask = (_rand((N, S, H), 8), _rand((N, H), 9),
                       _rand((N, S, H, DV), 10), _mask(11))
    logits = torch.nn.functional.leaky_relu(
        torch.from_numpy(el + er[:, None, :]), 0.2)
    logits = logits.masked_fill(torch.from_numpy(mask)[:, :, None] == 0,
                                float("-inf"))
    alpha = torch.nan_to_num(torch.softmax(logits, 1), nan=0.0)
    ref = torch.einsum("nsh,nshd->nhd", alpha, torch.from_numpy(v))
    out = ra.dense_gat_attention(*_t(el, er, v, mask))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


# ----------------------------------------------------------- two ranks
def test_two_ranks_ring_and_gathered_forms(tmp_path):
    """Two gloo ranks (``tests/torch_shard_worker.py``), each holding
    half of the axis: the ring's output and the hub attention's equal
    the one-process forms to float rounding; the key gradient of the two
    ranks' losses (each reads the same output) is twice the one
    process's, through the hops' backward."""
    got = worker.run_two("ring_attention", str(tmp_path / "r"))
    q, k, v, mask = worker.attention_inputs()
    k.requires_grad_()
    want = ra.ring_dot_attention(q, k, v, mask, SHARDS)
    (want ** 2).sum().backward()
    g, x, conv = worker.hub_inputs()
    hub = gat_hub_attention(conv, g, x, [7, 1, 2], SHARDS)
    for r, rank_got in enumerate(got):
        np.testing.assert_allclose(rank_got["out"].numpy(),
                                   want.detach().numpy(), **TOL)
        cols = slice(r * S // 2, (r + 1) * S // 2)
        np.testing.assert_allclose(rank_got["kgrad"].numpy(),
                                   2 * k.grad[:, cols].numpy(), **TOL)
        np.testing.assert_allclose(rank_got["hub"].numpy(), hub.numpy(),
                                   **TOL)
