"""The port's device sampler (``ops/device_sample.py``) and its tree
scatter plan against the JAX package's ``ops/device_sample.py``.

Both packages build the same graphs from one numpy seed. The port's
``sample_fanout_tree_from_draws`` is fed the draws JAX's
``sample_fanout_tree`` makes from a key (rebuilt in JAX's split order),
so blocks and input ids must be identical, on graphs with zero-degree
nodes and with -1 seeds. The port's own draws come from a counter hash;
a numpy copy of it here must give the same values, and their spread must
pass a chi-square bound. One device-mode loss and its gradients are held
against the JAX model on blocks from the same draws: the loss within
1e-5 relative and every gradient within 1e-4 of its largest entry
(float32 sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.ops import device_sample as jax_ds
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.graph import Graph
from dgl_operator_tpu_torch.models.sage import (DistSAGE,
                                                state_dict_from_flax,
                                                state_dict_to_flax)
from dgl_operator_tpu_torch.ops import device_sample as ds
from dgl_operator_tpu_torch.ops.gather import gather_rows
from dgl_operator_tpu_torch.ops.scatter import (ScatterPlan, scatter_plan,
                                                tree_scatter_plan)
from dgl_operator_tpu_torch.runtime.forward import masked_loss

FEAT, HIDDEN, CLASSES = 12, 16, 4
FANOUTS = [(3, 4), (10, 25), (5,), (2, 3, 4)]
M32 = 0xFFFFFFFF
# chi-square over 64 equal buckets (63 degrees of freedom: mean 63,
# standard deviation sqrt(126) = 11.2); 63 + 8 sd = 153 is passed by a
# uniform draw with probability above 1 - 1e-9
CHI2_BUCKETS, CHI2_BOUND = 64, 153.0


def _graph(isolated: int = 40):
    """A 300-node graph whose last ``isolated`` nodes have no in-edge."""
    g = datasets.synthetic_node_clf(300, 1500, FEAT, CLASSES, seed=11).graph
    keep = g.dst < 300 - isolated
    return Graph(g.src[keep], g.dst[keep], g.num_nodes)


def _seeds(n: int = 48) -> np.ndarray:
    """Seeds over every kind of row: low ids, isolated ones, -1 pads."""
    return np.concatenate([np.arange(20), np.arange(270, 290),
                           np.full(n - 40, -1)]).astype(np.int32)


def _jax_draws(key, n: int, fanouts):
    """The draws ``jax_ds.sample_fanout_tree`` makes from ``key``, in its
    split order (one split a layer, the seeds' layer first)."""
    out = []
    for fan in reversed(list(fanouts)):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(
            sub, (n, fan), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)))
        n *= fan + 1
    return out


def _both(csc, seeds, fanouts, key_int=3):
    """JAX's tree and the port's from JAX's draws."""
    key = jax.random.PRNGKey(key_int)
    jip, jix = jax_ds.device_csr(csc)
    jblocks, jids = jax_ds.sample_fanout_tree(jip, jix, jnp.asarray(seeds),
                                              fanouts, key)
    ip, ix = ds.device_csr(csc, "cpu")
    draws = [torch.from_numpy(d.copy())
             for d in _jax_draws(key, len(seeds), fanouts)]
    blocks, ids = ds.sample_fanout_tree_from_draws(
        ip, ix, torch.from_numpy(seeds), fanouts, draws, plans=True)
    return (jblocks, np.asarray(jids)), (blocks, ids)


@pytest.mark.parametrize("fanouts", FANOUTS)
def test_tree_caps_match_jax(fanouts):
    for batch in (1, 32, 1000):
        assert ds.tree_caps(batch, fanouts) == jax_ds.tree_caps(batch,
                                                               fanouts)
    assert ds.tree_caps(1000, (10, 25)) == [1000, 26_000, 286_000]


@pytest.mark.parametrize("isolated", [0, 40, 300])
def test_device_csr_matches_jax(isolated):
    """The same arrays and index type, the edgeless graph's sentinel
    included."""
    csc = _graph(isolated).csc()
    want = [np.asarray(a) for a in jax_ds.device_csr(csc)]
    got = [t.numpy() for t in ds.device_csr(csc, "cpu")]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    if isolated == 300:
        assert got[1].tolist() == [0]


@pytest.mark.parametrize("nodes,edges,want", [
    (2**31 - 1, 2**31 - 1, np.int32), (2**31, 5, np.int64),
    (5, 2**31, np.int64), (0, 0, np.int32)])
def test_csr_index_type_at_the_int32_boundary(nodes, edges, want):
    """JAX's ``device_csr`` rule, ``int32 if max(N, E) < 2**31``, at its
    boundary (arrays of 2^31 entries are not built here)."""
    jax_rule = np.int32 if max(nodes, edges) < 2**31 else np.int64
    assert ds.csr_index_dtype(nodes, edges) == np.dtype(want) == \
        np.dtype(jax_rule)


@pytest.mark.parametrize("fanouts", FANOUTS)
@pytest.mark.parametrize("isolated", [0, 40, 300])
def test_from_draws_equals_jax_sample_fanout_tree(fanouts, isolated):
    csc = _graph(isolated).csc()
    seeds = _seeds()
    (jblocks, jids), (blocks, ids) = _both(csc, seeds, fanouts)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), jids)
    assert len(blocks) == len(jblocks) == len(fanouts)
    for b, jb in zip(blocks, jblocks):
        assert b.num_src == jb.num_src
        np.testing.assert_array_equal(b.nbr.numpy(), np.asarray(jb.nbr))
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(jb.mask))
        assert b.mask.dtype == torch.uint8 and b.nbr.dtype == torch.int32
    # a row is valid exactly when its seed is real and has in-edges:
    # padded seeds and isolated nodes mask their rows end to end
    deg = np.diff(csc[0])
    want = (seeds >= 0) & (deg[np.maximum(seeds, 0)] > 0)
    inner = blocks[-1].mask.numpy()
    np.testing.assert_array_equal(inner.all(1), want)
    np.testing.assert_array_equal(inner.any(1), want)
    assert want[:20].any() != (isolated == 300)
    assert not want[20:40].any() or isolated == 0


def _mix32_np(x):
    """A numpy copy of murmur3's 32-bit finalizer on uint64 arrays."""
    x = np.asarray(x, np.uint64) & np.uint64(M32)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x85EBCA6B)) & np.uint64(M32)
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(0xC2B2AE35)) & np.uint64(M32)
    return x ^ (x >> np.uint64(16))


def _draws_np(parts, batch, fanouts):
    """A numpy copy of ``draw_key`` and ``tree_draws``."""
    key = np.uint64(0x9E3779B9)
    for p in parts:
        p = int(p)
        key = _mix32_np(key ^ np.uint64((p & M32) ^ ((p >> 32) & M32)))
    out, n = [], batch
    for layer, fan in enumerate(reversed(list(fanouts))):
        k = _mix32_np(key ^ _mix32_np(layer + 1))
        cnt = _mix32_np(np.arange(n * fan, dtype=np.uint64))
        out.append((_mix32_np(cnt ^ k) >> np.uint64(1))
                   .astype(np.int32).reshape(n, fan))
        n *= fan + 1
    return out


@pytest.mark.parametrize("parts", [(0, 0), (5, 17), (2**40 + 3, 9),
                                   (7, 123_456, 3)])
def test_draws_match_a_numpy_copy_and_repeat(parts):
    fanouts = (10, 25)
    counters = ds.draw_counters(64, fanouts, "cpu")
    got = ds.tree_draws(ds.draw_key(*parts), counters, fanouts)
    again = ds.tree_draws(ds.draw_key(*parts), counters, fanouts)
    # a device step counter as a tensor part gives the same key
    as_tensor = ds.tree_draws(
        ds.draw_key(*parts[:-1], torch.tensor([parts[-1]])), counters,
        fanouts)
    want = _draws_np(parts, 64, fanouts)
    for g, a, t, w in zip(got, again, as_tensor, want):
        assert g.dtype == torch.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
        assert torch.equal(g, a) and torch.equal(g, t)
        assert int(g.min()) >= 0


def _chi2(values, buckets):
    counts = np.bincount(values, minlength=buckets)
    expect = len(values) / buckets
    return float(((counts - expect) ** 2 / expect).sum())


def test_draws_are_uniform_and_keys_independent():
    """The 31-bit draws of one key spread evenly over 64 buckets of
    their top bits, a slot drawn among 10 neighbors by ``% deg`` over 10
    buckets with one more degree of freedom's slack, and the draws of
    the next step's key agree with this one's in 1/64 of the buckets."""
    fanouts = (10, 25)
    counters = ds.draw_counters(1000, fanouts, "cpu")
    a = ds.tree_draws(ds.draw_key(0, 41), counters, fanouts)
    b = ds.tree_draws(ds.draw_key(0, 42), counters, fanouts)
    for da, db in zip(a, b):
        top = (da.numpy().reshape(-1) >> 25).astype(np.int64)
        assert _chi2(top, CHI2_BUCKETS) < CHI2_BOUND
        assert _chi2((da.numpy().reshape(-1) % 10).astype(np.int64),
                     10) < 9 + 8 * np.sqrt(18)
        same = np.mean((da.numpy() >> 25) == (db.numpy() >> 25))
        assert abs(same - 1 / 64) < 0.01


@pytest.mark.parametrize("fanouts", FANOUTS)
@pytest.mark.parametrize("isolated", [0, 300])
def test_tree_plan_equals_the_host_scatter_plan(fanouts, isolated):
    """Every block's device-built plan (attached by the sampler) equals
    the host ``scatter_plan`` of its table, ``src`` on its first ``nnz``
    entries; a tree target has at most one entry."""
    csc = _graph(isolated).csc()
    _, (blocks, _) = _both(csc, _seeds(), fanouts)
    assert blocks[0].plan is None
    for blk in blocks[1:]:
        host = scatter_plan(blk.nbr.numpy(), blk.mask.numpy(), blk.num_src)
        dev = blk.plan
        assert isinstance(dev, ScatterPlan)
        nnz = int(host.offsets[-1])
        for k in ScatterPlan.FIELDS:
            got = getattr(dev, k)
            assert got.dtype == torch.int32 and got.is_contiguous()
            if k == "src":
                assert got.shape[0] == blk.nbr.numel() >= nnz
                got = got[:nnz]
            np.testing.assert_array_equal(got.numpy(), getattr(host, k), k)
        assert dev.num_chunks == 0 and dev.long_rows.numel() == 0
    # one plan alone, on a table with every row valid and none
    mask = torch.zeros(4, 3, dtype=torch.uint8)
    mask[1] = 1
    plan = tree_scatter_plan(mask)
    assert plan.offsets.tolist() == [0] * 8 + [1, 2, 3] + [3] * 6
    assert plan.src[:3].tolist() == [1, 1, 1]
    assert plan.cnt.tolist() == [0, 3, 0, 0]


def test_device_loss_and_gradients_match_jax():
    """One step's masked loss and its gradients, the port's model on the
    port's blocks from JAX's draws, against the JAX model on JAX's."""
    fanouts = (3, 4)
    jg = jax_datasets.synthetic_node_clf(300, 1500, FEAT, CLASSES,
                                         seed=11).graph
    pg = datasets.synthetic_node_clf(300, 1500, FEAT, CLASSES, seed=11).graph
    csc = pg.csc()
    seeds = np.concatenate([np.arange(100, 140), np.full(8, -1)]).astype(
        np.int32)
    (jblocks, jids), (blocks, ids) = _both(csc, seeds, fanouts, key_int=9)
    feats = jnp.asarray(jg.ndata["feat"])
    labels = jnp.asarray(jg.ndata["label"].astype(np.int32))
    jmodel = JaxDistSAGE(hidden_feats=HIDDEN, out_feats=CLASSES, dropout=0.0)
    init = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jblocks,
                                      feats[jnp.asarray(jids)]))
    jseeds = jnp.asarray(seeds)

    def loss_fn(p):
        logits = jmodel.apply(p, jblocks, feats[jnp.asarray(jids)],
                              train=False)
        valid = (jseeds >= 0).astype(jnp.float32)
        lab = labels[jnp.maximum(jseeds, 0)]
        ll = optax.softmax_cross_entropy_with_integer_labels(logits, lab)
        return (ll * valid).sum() / jnp.maximum(valid.sum(), 1.0)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(init)
    model = DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.0, device="cpu")
    model.load_state_dict(state_dict_from_flax(init))
    model.train()
    pfeats = torch.from_numpy(pg.ndata["feat"].astype(np.float32))
    plabels = torch.from_numpy(pg.ndata["label"].astype(np.int64))
    loss, _ = masked_loss(model(blocks, gather_rows(pfeats, ids)), plabels,
                          torch.from_numpy(seeds))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    got = state_dict_to_flax({n: p.grad for n, p in
                              model.named_parameters()})["params"]
    want = jax.device_get(want_grads)["params"]
    for layer, subs in got.items():
        for sub, leaves in subs.items():
            for leaf, value in leaves.items():
                ref = np.asarray(want[layer][sub][leaf])
                np.testing.assert_allclose(
                    value, ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                    err_msg=f"{layer}/{sub}/{leaf}")


def test_tree_sampler_reuses_its_positions():
    """``TreeSampler`` gives what ``sample_fanout_tree`` gives for the
    same key, with its plans attached."""
    csc = _graph().csc()
    ip, ix = ds.device_csr(csc, "cpu")
    seeds = torch.from_numpy(_seeds())
    sampler = ds.TreeSampler(len(seeds), (3, 4), "cpu")
    key = ds.draw_key(1, 2)
    got_blocks, got_ids = sampler.sample(ip, ix, seeds, key)
    want_blocks, want_ids = ds.sample_fanout_tree(ip, ix, seeds, (3, 4),
                                                  key, plans=True)
    assert torch.equal(got_ids, want_ids)
    for g, w in zip(got_blocks, want_blocks):
        assert torch.equal(g.nbr, w.nbr) and torch.equal(g.mask, w.mask)
    assert sampler.caps == ds.tree_caps(len(seeds), (3, 4))
    assert got_blocks[1].plan is not None


def test_sampler_routes_by_device(monkeypatch):
    """A CPU tensor takes the plain path (the kernel is never called and
    counts nothing); the kernel itself refuses a CPU tensor; a tensor on
    another device than cuda or cpu raises."""
    csc = _graph().csc()
    ip, ix = ds.device_csr(csc, "cpu")
    seeds = torch.from_numpy(_seeds())
    key = ds.draw_key(4, torch.tensor([6]))
    counters = ds.draw_counters(len(seeds), (3, 4), "cpu")
    want_blocks, want_ids = ds.sample_fanout_tree_from_draws(
        ip, ix, seeds, (3, 4), ds.tree_draws(key, counters, (3, 4)),
        plans=True, slot_plans=True)

    def refuse(*a, **kw):
        raise AssertionError("the kernel was called on a CPU tensor")

    before = ds.tree_sample.launches
    with monkeypatch.context() as m:
        m.setattr(ds, "tree_sample", refuse)
        sampler = ds.TreeSampler(len(seeds), (3, 4), "cpu", slot_plans=True)
        got_blocks, got_ids = sampler.sample(ip, ix, seeds, key)
    assert ds.tree_sample.launches == before
    assert torch.equal(got_ids, want_ids)
    for g, w in zip(got_blocks, want_blocks):
        assert torch.equal(g.mask, w.mask) and g.plan is not None
        for k in ScatterPlan.FIELDS:
            assert torch.equal(getattr(g.plan, k), getattr(w.plan, k)), k
    with pytest.raises(ValueError, match="runs on cuda"):
        ds.tree_sample(ip, ix, seeds, (3, 4), key)
    meta = torch.empty(len(seeds), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ds.sample_fanout_tree(ip.to("meta"), ix.to("meta"), meta, (3, 4),
                              key)


def _hash_kernel_parts(start, rest):
    """What the kernel's prologue computes from ``kernel_key``'s parts:
    each later part hashed in turn, a tensor read and folded."""
    key = start
    for part in rest:
        if isinstance(part, torch.Tensor):
            v = int(part.reshape(-1)[0])
            part = (v & M32) ^ ((v >> 32) & M32)
        key = ds.mix32(key ^ part)
    return key


@pytest.mark.parametrize("parts,tensors", [
    ((5, 17), ()), ((5, 17), (1,)), ((5, 17), (0,)), ((5, 17), (0, 1)),
    ((2**40 + 3, 9), (1,)), ((7, 123_456, 3), (1,)),
    ((2**62 + 5, 1, 3, 9), (0, 2)), ((0,), (0,)), ((1, 2, 3, 4, 5), (1,))])
def test_kernel_key_parts_give_draw_key_and_tree_draws(parts, tensors):
    """``kernel_key``'s host hash and its later parts, hashed as the
    kernel does, give ``draw_key``'s value, and the draws of the key
    with tensor parts are the numpy copy's of the integers."""
    key = ds.draw_key(*(torch.tensor([p]) if i in tensors else p
                        for i, p in enumerate(parts)))
    want = ds.draw_key(*parts)
    assert isinstance(want, int)
    assert isinstance(key, ds.DrawKey) == bool(tensors)
    assert int(key.value() if tensors else key) == want
    start, rest = ds.kernel_key(key, "cpu")
    assert len(rest) == (len(parts) - min(tensors) if tensors else 0)
    assert _hash_kernel_parts(start, rest) == want
    counters = ds.draw_counters(16, (10, 25), "cpu")
    for got, w in zip(ds.tree_draws(key, counters, (10, 25)),
                      _draws_np(parts, 16, (10, 25))):
        np.testing.assert_array_equal(got.numpy(), w)


def test_kernel_key_refuses_what_the_kernel_cannot_read():
    """A tensor part is an int64 scalar on the sampler's device, at most
    four parts follow the first tensor, and a finished key is
    ``draw_key``'s (an int below 2^32, or a ``DrawKey``)."""
    step = torch.tensor([3])
    with pytest.raises(TypeError, match="int64 scalar"):
        ds.kernel_key(ds.draw_key(1, torch.tensor([3], dtype=torch.int32)),
                      "cpu")
    with pytest.raises(TypeError, match="int64 scalar"):
        ds.kernel_key(ds.draw_key(1, torch.tensor([3, 4])), "cpu")
    with pytest.raises(ValueError, match="for a sampler on meta"):
        ds.kernel_key(ds.draw_key(1, step), "meta")
    with pytest.raises(ValueError, match="at most 4"):
        ds.kernel_key(ds.draw_key(step, 1, 2, 3, 4), "cpu")
    assert len(ds.kernel_key(ds.draw_key(step, 1, 2, 3), "cpu")[1]) == 4
    with pytest.raises(ValueError, match="in \\[0, 2\\^32\\)"):
        ds.kernel_key(2**32, "cpu")
    with pytest.raises(TypeError, match="draw_key's"):
        ds.kernel_key(step, "cpu")
