"""The port's per-partition sampler pool against the JAX trainer's.

``DistTrainer`` samples a batch's slots on a pool of
``resolve_num_samplers(cfg)`` threads, each slot's task doing its
sampling, its scatter plans and (owner layout) its exchange tables. A
slot's batch depends on ``(step_seed, part)`` alone, so the stream is
bit-identical at every width, and at width 2 equal to the JAX
``DistTrainer._sample_all`` on the same 4-part book (the JAX width grid
is ``tests/test_pipeline.py``). The lookahead stays one thread: the pool
widens each batch, never the number of batches in flight.
"""

import threading

import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph.partition import partition_graph
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.parallel import make_mesh
from dgl_operator_tpu.runtime import DistTrainer as JaxDistTrainer
from dgl_operator_tpu.runtime import TrainConfig as JaxTrainConfig
from dgl_operator_tpu.runtime.loop import \
    resolve_num_samplers as jax_resolve_num_samplers
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.runtime.dist import DistTrainer
from dgl_operator_tpu_torch.runtime.loop import (NUM_SAMPLERS_ENV,
                                                 TrainConfig,
                                                 resolve_num_samplers)
from test_torch_native import use_jax_graphcore

FEAT, HIDDEN, CLASSES = 16, 32, 4
LAYOUTS = ("replicated", "owner")
WIDTHS = (1, 2, 4)
BATCHES = ((0, 5), (3, 17))      # (batch index, step seed)


def _cfg(layout, **kw):
    return dict(num_epochs=1, batch_size=32, lr=0.01, fanouts=(4, 4),
                log_every=1000, eval_every=0, feats_layout=layout, **kw)


@pytest.fixture(autouse=True)
def jax_library(monkeypatch, tmp_path_factory):
    use_jax_graphcore(monkeypatch, tmp_path_factory)
    monkeypatch.delenv("TPU_OPERATOR_TUNED_MANIFEST", raising=False)
    monkeypatch.delenv(NUM_SAMPLERS_ENV, raising=False)


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        use_jax_graphcore(mp, tmp_path_factory)
        ds = jax_datasets.synthetic_node_clf(800, 4000, FEAT, CLASSES, seed=3)
        return partition_graph(ds.graph, "synth", 4,
                               str(tmp_path_factory.mktemp("pool")))


def _port(book, layout, **kw):
    model = DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.0, device="cpu")
    return DistTrainer(model, book, TrainConfig(**_cfg(layout, dropout=0.0,
                                                       **kw)), device="cpu")


def _perm(train_ids):
    rng = np.random.default_rng(0)
    return [rng.permutation(t) for t in train_ids]


def _flat(batch):
    """Every array of a port host batch, by name."""
    out = {}
    for i, mb in enumerate(batch["mbs"]):
        out[f"{i}/inputs"] = mb.input_nodes
        out[f"{i}/seeds"] = mb.seeds
        for l, blk in enumerate(mb.blocks):
            out[f"{i}/{l}/nbr"] = blk.nbr
            out[f"{i}/{l}/mask"] = blk.mask
            if blk.plan is not None:
                for k, v in vars(blk.plan).items():
                    if isinstance(v, (np.ndarray, torch.Tensor)):
                        out[f"{i}/{l}/plan/{k}"] = np.asarray(v)
    for k in ("exch_loc", "exch_pos", "exch_serve"):
        if k in batch:
            out[k] = batch[k]
    return out


@pytest.fixture(scope="module")
def port_batches(book):
    """Per layout and width: the host batches of ``BATCHES``, and the
    names of the threads that sampled their slots."""
    out = {}
    for layout in LAYOUTS:
        for width in WIDTHS:
            tr = _port(book, layout, num_samplers=width)
            perm = _perm(tr.train_ids)
            names = set()
            one = tr._sample_one

            def record(*a, one=one, names=names):
                names.add(threading.current_thread().name)
                return one(*a)

            tr._sample_one = record
            try:
                batches = [tr._sample_all(perm, b, s)[0] for b, s in BATCHES]
            finally:
                tr._close_sampler_pool()
            out[layout, width] = ([_flat(b) for b in batches], names)
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("width", WIDTHS[1:])
def test_stream_is_bit_identical_at_every_width(port_batches, layout, width):
    base, _ = port_batches[layout, 1]
    got, names = port_batches[layout, width]
    for b, w in zip(got, base):
        assert b.keys() == w.keys()
        for k, v in w.items():
            np.testing.assert_array_equal(b[k], v, k)
    # the slots were sampled on the pool's threads
    assert names and all(n.startswith("slot-sampler") for n in names)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_width_one_samples_inline(port_batches, layout):
    _, names = port_batches[layout, 1]
    assert names == {threading.current_thread().name}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_width_two_equals_the_jax_sample_all(book, port_batches, layout):
    jtr = JaxDistTrainer(
        JaxDistSAGE(hidden_feats=HIDDEN, out_feats=CLASSES, dropout=0.0),
        book, make_mesh(num_dp=4),
        JaxTrainConfig(**_cfg(layout), num_samplers=2, sentry=False))
    perm = _perm(jtr.train_ids)
    try:
        want = [jtr._sample_all(perm, b, s)[0] for b, s in BATCHES]
    finally:
        jtr._close_sampler_pool()
    got, _ = port_batches[layout, 2]
    for g, w in zip(got, want):
        for i in range(4):
            np.testing.assert_array_equal(g[f"{i}/inputs"], w["inputs"][i])
            np.testing.assert_array_equal(g[f"{i}/seeds"], w["seeds"][i])
            for l, blk in enumerate(w["blocks"]):
                np.testing.assert_array_equal(g[f"{i}/{l}/nbr"],
                                              np.asarray(blk.nbr)[i])
                np.testing.assert_array_equal(g[f"{i}/{l}/mask"],
                                              np.asarray(blk.mask)[i])
        if layout == "owner":
            for k in ("exch_loc", "exch_pos", "exch_serve"):
                np.testing.assert_array_equal(g[k], w[k], k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_training_is_bit_identical_at_widths_one_and_four(book, layout):
    runs = [_port(book, layout, num_samplers=w).train() for w in (1, 4)]
    assert runs[0]["history"][0]["losses"] == runs[1]["history"][0]["losses"]
    for k, v in runs[0]["params"].items():
        assert torch.equal(runs[1]["params"][k], v), k


def _pool_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("slot-sampler") and t.is_alive()]


def test_train_joins_the_pool_and_keeps_one_lookahead_thread(book):
    tr = _port(book, "owner", num_samplers=4, prefetch=2)
    callers = set()
    sample_all = tr._sample_all

    def record(*a):
        callers.add(threading.current_thread().name)
        return sample_all(*a)

    tr._sample_all = record
    tr.train()
    assert tr._pool is None and not _pool_threads()
    # every batch staged by one lookahead thread, never by the pool
    assert len(callers) == 1
    assert not next(iter(callers)).startswith("slot-sampler")


def test_a_failed_run_joins_the_pool(book):
    tr = _port(book, "replicated", num_samplers=2)
    step = tr.train_step
    taken = []

    def dying_step(batch):
        if taken:
            raise RuntimeError("killed")
        taken.append(1)
        return step(batch)

    tr.train_step = dying_step
    with pytest.raises(RuntimeError, match="killed"):
        tr.train()
    assert tr._pool is None and not _pool_threads()


@pytest.mark.parametrize("field,env,want", [
    (0, None, 1), (3, None, 3), (0, "5", 5), (2, "5", 2), (0, "", 1)])
def test_resolve_num_samplers_matches_jax(monkeypatch, field, env, want):
    if env is not None:
        monkeypatch.setenv(NUM_SAMPLERS_ENV, env)
    got = resolve_num_samplers(TrainConfig(num_samplers=field))
    assert got == jax_resolve_num_samplers(
        JaxTrainConfig(num_samplers=field)) == want


def test_negative_num_samplers_raises():
    with pytest.raises(ValueError, match="num_samplers"):
        TrainConfig(num_samplers=-1)
