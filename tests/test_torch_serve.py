"""The port's serving path vs the JAX package's, end to end.

One 4-part book written by the JAX partitioner, one set of flax params
exported by the JAX package. The JAX ``ServeEngine`` and the port's
``ServeEngine(device="cpu")`` are fed the same ids and sample seeds and
must agree: identical predictions, logits within 1e-4, and the same
halo cache-hit / owner-fetch counts. Both sample with their C++ graph
cores (the JAX bridge on a build of its own source,
``test_torch_native.use_jax_graphcore``), and the book is the JAX
package's multilevel partition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph.blocks import FanoutBlock as JaxFanoutBlock
from dgl_operator_tpu.graph.partition import partition_graph
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.runtime.checkpoint import export_for_serving
from dgl_operator_tpu.serve.engine import ServeConfig as JaxServeConfig
from dgl_operator_tpu.serve.engine import ServeEngine as JaxServeEngine
from dgl_operator_tpu_torch.models.sage import DistSAGE, state_dict_to_flax
from dgl_operator_tpu_torch.serve.batcher import MicroBatcher, Overloaded
from dgl_operator_tpu_torch.serve.engine import ServeConfig, ServeEngine
from test_torch_native import use_jax_graphcore

pytestmark = pytest.mark.serve

FEAT, HIDDEN, CLASSES = 12, 16, 4
FANOUTS = (3, 4)
BATCH = 16
# float32 forward of two small SAGE layers summed in another order
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def jax_library(monkeypatch, tmp_path_factory):
    use_jax_graphcore(monkeypatch, tmp_path_factory)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        use_jax_graphcore(mp, tmp_path_factory)
        ds = jax_datasets.synthetic_node_clf(num_nodes=500, num_edges=2500,
                                             feat_dim=FEAT,
                                             num_classes=CLASSES, seed=3)
        out = tmp_path_factory.mktemp("torch_serve")
        cfg_json = partition_graph(ds.graph, "synth", 4, str(out / "book"))
        model = JaxDistSAGE(hidden_feats=HIDDEN, out_feats=CLASSES,
                            dropout=0.0)
        blk = JaxFanoutBlock(jnp.zeros((2, 3), jnp.int32),
                             jnp.ones((2, 3), jnp.float32), 4)
        params = jax.device_get(model.init(jax.random.PRNGKey(0),
                                           [blk, blk],
                                           jnp.ones((4, FEAT))))
        rng = np.random.default_rng(0)
        # perturbed biases so every parameter shapes the logits
        params = jax.tree_util.tree_map(
            lambda x: np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))
            .astype(np.float32), params)
        path = export_for_serving(str(out / "export") + "/", params)
        kw = dict(fanouts=FANOUTS, batch_size=BATCH, cap_policy="worst",
                  halo_cache_frac=0.25)
        jax_eng = JaxServeEngine(model, cfg_json, params_path=path,
                                 cfg=JaxServeConfig(**kw))
        port_model = DistSAGE(FEAT, HIDDEN, CLASSES, device="cpu")
        port_eng = ServeEngine(port_model, cfg_json, params_path=path,
                               cfg=ServeConfig(**kw), device="cpu")
        yield ds, cfg_json, path, port_model, jax_eng, port_eng


def _request(kind, n):
    rng = np.random.default_rng(len(kind))
    if kind == "one_part":
        return np.arange(0, 40, 4, dtype=np.int64)[:8]
    size = {"several_parts": 12, "over_batch": 3 * BATCH}[kind]
    return rng.choice(n, size=size, replace=False).astype(np.int64)


def _counts(eng):
    return eng._m_hits.value(), eng._m_remote.value()


@pytest.mark.parametrize("sample_seed", [0, 11])
@pytest.mark.parametrize("kind", ["one_part", "several_parts",
                                  "over_batch"])
def test_port_engine_matches_jax_engine(served, kind, sample_seed):
    ds, _, _, _, jax_eng, port_eng = served
    ids = _request(kind, ds.graph.num_nodes)
    j0, p0 = _counts(jax_eng), _counts(port_eng)
    want = jax_eng.predict_logits(ids, sample_seed=sample_seed)
    got = port_eng.predict_logits(ids, sample_seed=sample_seed)
    assert got.shape == want.shape == (len(ids), CLASSES)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    np.testing.assert_array_equal(
        port_eng.predict(ids, sample_seed=sample_seed),
        jax_eng.predict(ids, sample_seed=sample_seed))
    j1, p1 = _counts(jax_eng), _counts(port_eng)
    assert (p1[0] - p0[0], p1[1] - p0[1]) == (j1[0] - j0[0], j1[1] - j0[1])
    assert p1[0] + p1[1] > p0[0] + p0[1]


def test_engine_stores_are_owner_sharded(served):
    ds, _, _, _, jax_eng, port_eng = served
    assert sum(len(s.core) for s in port_eng._stores) == ds.graph.num_nodes
    assert port_eng.caps == jax_eng.caps
    assert port_eng.ready and port_eng.stats()["device"] == "cpu"


def test_batcher_over_port_engine_returns_request_order(served):
    ds, _, _, _, jax_eng, port_eng = served
    reqs = [np.array([5, 17, 301]), np.arange(100, 109),
            np.array([499, 0])]
    b = port_eng.make_batcher(start=False)
    futs = [b.submit(r) for r in reqs]
    assert b.flush_now() == 1
    # one coalesced batch, sequence number 0
    want = jax_eng.predict(np.concatenate(reqs), sample_seed=0)
    lo = 0
    for r, f in zip(reqs, futs):
        np.testing.assert_array_equal(f.result(timeout=10),
                                      want[lo:lo + len(r)])
        lo += len(r)


def test_batcher_background_thread_serves_requests(served):
    ds, _, _, _, _, port_eng = served
    b = port_eng.make_batcher()
    try:
        futs = [b.submit(np.arange(i, i + 5)) for i in range(0, 40, 5)]
        outs = [f.result(timeout=30) for f in futs]
    finally:
        b.stop()
    assert all(o.shape == (5,) and (o >= 0).all() and (o < CLASSES).all()
               for o in outs)


def test_engine_validates_inputs(served):
    ds, cfg_json, path, port_model, _, port_eng = served
    with pytest.raises(ValueError, match="out of range"):
        port_eng.predict(np.asarray([ds.graph.num_nodes + 5]))
    with pytest.raises(ValueError, match="exactly one of"):
        ServeEngine(port_model, cfg_json, cfg=ServeConfig(), device="cpu")
    with pytest.raises(ValueError, match="cap_policy"):
        ServeEngine(port_model, cfg_json, params_path=path, device="cpu",
                    cfg=ServeConfig(cap_policy="wrost"))
    wrong = DistSAGE(FEAT, HIDDEN + 1, CLASSES, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        ServeEngine(wrong, cfg_json, params_path=path, device="cpu",
                    cfg=ServeConfig(fanouts=FANOUTS, batch_size=BATCH))
    assert port_eng.predict(np.zeros(0, np.int64)).shape == (0,)


def test_swap_params(served):
    ds, _, _, port_model, _, port_eng = served
    ids = np.arange(10)
    before = port_eng.predict_logits(ids, sample_seed=3)
    other = state_dict_to_flax(
        DistSAGE(FEAT, HIDDEN, CLASSES, device="cpu",
                 generator=torch.Generator().manual_seed(5)).state_dict())
    old = port_eng.swap_params(other)
    try:
        assert not np.allclose(port_eng.predict_logits(ids, sample_seed=3),
                               before)
        bad = state_dict_to_flax(DistSAGE(FEAT, HIDDEN + 2, CLASSES,
                                          device="cpu").state_dict())
        with pytest.raises(ValueError, match="shape"):
            port_eng.swap_params(bad)
    finally:
        port_eng.swap_params(old)
    np.testing.assert_array_equal(
        port_eng.predict_logits(ids, sample_seed=3), before)


def test_batcher_occupancy_and_bursts():
    """13 valid seeds over two 8-slot batches = 13/16; a 10-seed request
    spans both batches and comes back whole, in order."""
    seen = []
    b = MicroBatcher(lambda s, q: (seen.append((q, len(s))), s * 10)[1],
                     batch_size=8, max_wait_s=0.0)
    f1 = b.submit(np.arange(3))
    f2 = b.submit(np.arange(10))
    assert b.flush_now() == 2
    assert seen == [(0, 8), (1, 5)]
    np.testing.assert_array_equal(f1.result(), np.arange(3) * 10)
    np.testing.assert_array_equal(f2.result(), np.arange(10) * 10)
    assert b.occupancy() == 13 / 16


def test_batcher_errors_shedding_and_deadlines():
    def boom(seeds, seq):
        raise RuntimeError("engine down")

    b = MicroBatcher(boom, batch_size=4)
    fa, fb = b.submit([1, 2]), b.submit([3])
    b.flush_now()
    for f in (fa, fb):
        with pytest.raises(RuntimeError, match="engine down"):
            f.result(timeout=5)
    now = [0.0]
    b = MicroBatcher(lambda s, q: s, batch_size=4, clock=lambda: now[0])
    b.set_shedding(True, reason="slo")
    with pytest.raises(Overloaded, match="slo"):
        b.submit([1])
    urgent = b.submit([7], priority=1)
    assert b.flush_now() == 1
    np.testing.assert_array_equal(urgent.result(timeout=5), [7])
    b.set_shedding(False)
    late = b.submit([2], deadline_s=1.0)
    now[0] = 2.0
    assert b.flush_now() == 0
    with pytest.raises(Overloaded, match="deadline"):
        late.result(timeout=5)


def test_request_path_helpers_match_jax(served):
    from dgl_operator_tpu.runtime import forward as jax_forward
    from dgl_operator_tpu_torch.runtime import forward

    ds, _, _, _, jax_eng, port_eng = served
    ids = _request("over_batch", ds.graph.num_nodes)
    want = jax_forward.route_by_owner(ids, jax_eng.node_map, BATCH)
    got = forward.route_by_owner(ids, port_eng.node_map, BATCH)
    assert [(p, c) for p, c, _ in got] == [(p, c) for p, c, _ in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert forward.part_sample_seed(7, 3) == \
        jax_forward.part_sample_seed(7, 3)
    caps = port_eng.caps
    mb = forward.sample_padded(port_eng._csc[1], np.arange(5), FANOUTS,
                               caps, port_eng.n_pad, BATCH, 9)
    jmb = jax_forward.sample_padded(jax_eng._csc[1], np.arange(5), FANOUTS,
                                    caps, jax_eng.n_pad, BATCH, 9)
    np.testing.assert_array_equal(mb.input_nodes, jmb.input_nodes)
    feats = ds.graph.ndata["feat"]
    np.testing.assert_array_equal(forward.gather_host_rows(feats, mb),
                                  jax_forward.gather_host_rows(feats, jmb))
