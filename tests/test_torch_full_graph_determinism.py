"""The full-graph loop is deterministic: ``train_full_graph`` with GCN
and with GAT on the synthetic Cora, run twice in one process with
several torch threads, gives the same loss at every epoch and the same
final parameters, bit for bit.

Each edge gather's backward is the segmented sum over the graph's
transpose plan (``gather_rows`` over ``DeviceGraph.src_plan`` /
``dst_plan``) and each segment sum is the plan's ``scatter_add_rows``,
whose plain version on the CPU adds in index order; an indexing
backward (``index_put_`` with ``accumulate``) adds across threads in
whatever order they finish.
"""

import numpy as np
import pytest
import torch

from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models import GAT, GCN, GraphSAGE, WeightedSAGE
from dgl_operator_tpu_torch.runtime.loop import TrainConfig, train_full_graph

EPOCHS = 8
THREADS = 4
MODELS = {
    "gcn": lambda: GCN(1433, 16, 7, device="cpu"),
    "gat": lambda: GAT(1433, 16, 7, num_heads=4, device="cpu"),
    "sage_pool": lambda: GraphSAGE(1433, 16, 7, aggregator="pool",
                                   device="cpu"),
    "weighted_sage": lambda: WeightedSAGE(1433, 16, 7, device="cpu"),
}


@pytest.fixture(scope="module")
def cora():
    return datasets.cora().graph


@pytest.fixture
def threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        yield THREADS
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("name", list(MODELS))
def test_train_full_graph_is_bit_reproducible(cora, threads, name):
    runs = []
    for _ in range(2):
        out = train_full_graph(MODELS[name](), cora,
                               TrainConfig(num_epochs=EPOCHS, lr=0.01,
                                           eval_every=0), device="cpu")
        runs.append(out)
    a, b = ([r["loss"] for r in run["history"]] for run in runs)
    assert len(a) == EPOCHS and np.isfinite(a).all()
    assert a == b, f"losses part: {a} vs {b}"
    pa, pb = (run["params"]["params"] for run in runs)

    def leaves(tree, path=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, f"{path}{k}/")
            else:
                yield f"{path}{k}", v

    got, want = dict(leaves(pa)), dict(leaves(pb))
    assert got.keys() == want.keys() and got
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
