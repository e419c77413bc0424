"""The sampled pool aggregator is deterministic: ``fanout_max`` gathers
its slots with ``gather_rows`` over the block's per-slot plan, so the
backward of a pool ``DistSAGE`` is the port's segmented sum, never an
indexing backward (``index_put_`` with ``accumulate``, which adds across
threads on the CPU, and with atomics on the card, in whatever order
they finish).

Two pool ``SampledTrainer`` runs (host and device sampler) and two pool
``DistTrainer`` runs (both layouts), each with several torch threads,
give the same loss at every step and the same final parameters, bit for
bit; and the autograd graph of a pool loss holds the port's gathers and
no indexing backward.
"""

import numpy as np
import pytest
import torch

from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.partition import partition_graph
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.runtime import forward
from dgl_operator_tpu_torch.runtime.dist import DistTrainer
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig

THREADS = 4
# wide enough that an indexing backward's [rows, D] cotangent passes
# torch's grain size and is added by several threads
FEAT, HIDDEN, CLASSES = 32, 64, 5
FANOUTS = (5, 10)
INDEXING = ("IndexBackward", "IndexPutBackward")


@pytest.fixture(scope="module")
def graph():
    return datasets.synthetic_node_clf(1500, 12000, FEAT, CLASSES,
                                       seed=21).graph


@pytest.fixture(scope="module")
def book(graph, tmp_path_factory):
    return partition_graph(graph, "pool", 2,
                           str(tmp_path_factory.mktemp("pool_book")))


@pytest.fixture
def threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        yield THREADS
    finally:
        torch.set_num_threads(before)


def _model(dropout=0.5):
    return DistSAGE(FEAT, HIDDEN, CLASSES, aggregator="pool",
                    dropout=dropout, device="cpu",
                    generator=torch.Generator().manual_seed(3))


def _sampled(graph, sampler):
    cfg = TrainConfig(num_epochs=1, batch_size=64, fanouts=FANOUTS,
                      lr=0.01, eval_every=0, log_every=1000, dropout=0.5,
                      seed=7, sampler=sampler, prefetch=1)
    ids = np.nonzero(graph.ndata["train_mask"])[0][:384]
    return SampledTrainer(_model(), graph, cfg, device="cpu",
                          train_ids=ids)


def _dist(book, layout):
    cfg = TrainConfig(num_epochs=1, batch_size=64, fanouts=FANOUTS,
                      lr=0.01, eval_every=0, log_every=1000, dropout=0.0,
                      seed=7, feats_layout=layout)
    return DistTrainer(_model(0.0), book, cfg, device="cpu")


def _losses(out):
    return [x for rec in out["history"] for x in rec["losses"]]


def _assert_runs_equal(a, b):
    la, lb = _losses(a), _losses(b)
    assert len(la) >= 3 and np.isfinite(la).all()
    assert la == lb, f"losses part: {la} vs {lb}"
    assert a["params"].keys() == b["params"].keys()
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_pool_sampled_trainer_is_bit_reproducible(graph, threads, sampler):
    runs = [_sampled(graph, sampler).train() for _ in range(2)]
    _assert_runs_equal(*runs)


@pytest.mark.parametrize("layout", ["replicated", "owner"])
def test_pool_dist_trainer_is_bit_reproducible(book, threads, layout):
    runs = [_dist(book, layout).train() for _ in range(2)]
    _assert_runs_equal(*runs)


def _backward_nodes(root):
    seen, stack, names = set(), [root], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(node.name())
        stack.extend(nxt for nxt, _ in node.next_functions)
    return names


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_pool_loss_has_no_indexing_backward(graph, sampler):
    """Every block carries a per-slot plan (``DistSAGE.slot_plans`` is
    True for the pool), and the loss's graph holds one port gather a
    layer and no indexing backward."""
    tr = _sampled(graph, sampler)
    assert tr.model.slot_plans is True
    seeds = tr.train_ids[:64]
    if sampler == "host":
        mb = tr.sample(seeds, 11)
        assert all(b.plan is not None for b in mb.blocks)
        batch = tr.ship(mb)
    else:
        blocks, inputs = tr._tree.sample(
            tr._indptr, tr._indices, torch.from_numpy(seeds), 11)
        assert all(b.plan is not None for b in blocks)
        batch = (blocks, inputs, torch.from_numpy(seeds))
    loss, _ = tr.loss(batch)
    names = _backward_nodes(loss.grad_fn)
    assert not [n for n in names if n.startswith(INDEXING)], names
    assert names.count("_GatherRowsBackward") == len(tr.model.layers)


def test_pool_sage_plans_are_per_instance():
    assert DistSAGE(4, 8, 2, aggregator="pool", device="cpu").slot_plans
    for agg in ("mean", "sum"):
        assert not DistSAGE(4, 8, 2, aggregator=agg, device="cpu").slot_plans
