"""The FLOP and byte arithmetic against hand-worked small blocks."""

import pytest
import torch

from portbench.tests import tiny
from portbench import spec
from portbench.arith import bounds, flops, peaks

NBR = torch.tensor([[0, 1], [1, 3]], dtype=torch.int32)
MASK = torch.tensor([[1, 0], [1, 1]], dtype=torch.uint8)


def test_gather_work():
    # 3 distinct of 4 rows of 3 floats read, 4 written, 4 int32 ids
    idx = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    assert bounds.gather_work(idx, 3, 4) == ((3 + 4) * 3 * 4 + 4 * 4, 0)


def test_fanout_work():
    # valid slots name rows 0, 1, 3: read once; 2 rows of 2 written;
    # nbr and mask 5 bytes a slot; an add per valid slot element
    assert bounds.fanout_work(NBR, MASK, 2, 4) == (
        3 * 2 * 4 + 2 * 2 * 4 + 2 * 2 * 5, 3 * 2)


def test_scatter_work():
    # the [5, 2] table written, g [2, 2] read, idx and mask 5 bytes a
    # slot; an add per valid slot element and per g element
    assert bounds.scatter_work(NBR, MASK, 5, 2, 4) == (
        5 * 2 * 4 + 2 * 2 * 4 + 2 * 2 * 5, 3 * 2 + 2 * 2)
    # padded: only the 3 distinct targets written
    assert bounds.scatter_work(NBR, MASK, 5, 2, 4, padded=True)[0] == (
        3 * 2 * 4 + 2 * 2 * 4 + 2 * 2 * 5)
    # no mask: every index counts, 4 bytes a slot
    assert bounds.scatter_work(NBR, None, 5, 2, 4) == (
        5 * 2 * 4 + 2 * 2 * 4 + 2 * 2 * 4, 4 * 2 + 2 * 2)


def test_least_seconds():
    assert bounds.least_seconds((peaks.HBM_BYTES_PER_S, 0)) == 1.0
    assert bounds.least_seconds((0, peaks.FLOPS["float32"])) == 1.0
    assert bounds.least_seconds((peaks.HBM_BYTES_PER_S,
                                 3 * peaks.FLOPS["float32"])) == 3.0


def _masks():
    # two seeds, fanouts (2, 1) outermost first: the inner block [2, 1]
    # with one valid slot, the outer [4, 2] with five
    inner = torch.tensor([[True], [False]])
    outer = torch.tensor([[True, True], [True, False], [False, False],
                          [True, True]])
    return [outer, inner]


def test_tree_counts():
    assert flops.tree_counts(_masks(), 2) == [
        {"dst": 3, "edges": 5, "src": 8}, {"dst": 2, "edges": 1, "src": 3}]


def test_sage_layer():
    c = {"dst": 3, "edges": 5, "src": 8}
    # forward: two products 2 * 3 * 4 * 2 each, 5 slots of 4 adds;
    # backward: the two weight gradients
    assert flops.sage_mean_layer(c, 4, 2, input_grad=False) == 96 + 20 + 96
    # with the input's gradient: two more products and the scatter
    assert flops.sage_mean_layer(c, 4, 2, input_grad=True) == \
        96 + 20 + 96 + 96 + 20


def test_gat_layer_takes_the_cheaper_order():
    c = {"dst": 2, "src": 6, "edges": 4}
    # project first: 320 forward + 440 backward; aggregate first:
    # 250 + 330 (worked out term by term in arith/flops.py's order)
    assert flops.gat_layer(c, 3, 1, 5, input_grad=False) == 580.0
    # a wide input and narrow heads: projecting first is cheaper
    wide = flops.gat_layer(c, 64, 1, 2, input_grad=False)
    assert wide == pytest.approx(
        (2 * 6 * 64 * 2 + 2 * 6 * 2 + 2 * 2 * 2 + 20 + 2 * 4 * 2)
        + (2 * 6 * 64 * 2 + 2 * 4 * 2 + 2 * 4 * 2 + 20 + 4 * 6 * 2
           + 4 * 2 * 2))


def test_full_cell_counts():
    """Every slot valid at the cells' sizes: SAGE's step as the issue
    works it out (5.5 GFLOP), GAT's within 12-17."""
    n0 = torch.ones(26000, 10, dtype=torch.bool)
    n1 = torch.ones(1000, 25, dtype=torch.bool)
    sage = spec.load_cell("sage_products.dev_k4")
    assert sage.kind.step_flops(sage.config["model"], [n0, n1], 1000) == \
        (2 * 4 * 26000 * 100 * 256 + 260000 * 100) \
        + (3 * 4 * 1000 * 256 * 47 + 2 * 25000 * 256)
    gat = tiny.load(tiny.GAT)
    f = gat.kind.step_flops(gat.config["model"], [n0, n1], 1000)
    assert 12e9 < f < 17e9


def test_launches_of_a_step():
    n0 = torch.ones(26000, 10, dtype=torch.bool)
    n1 = torch.ones(1000, 25, dtype=torch.bool)
    ids = torch.arange(286000)
    sage = spec.load_cell("sage_products.dev_k4")
    names = [k for k, _ in sage.kind.kernel_work(sage.config["model"],
                                                  [n0, n1], ids)]
    assert names == ["gather_rows", "fanout_agg", "fanout_agg",
                     "scatter_add_rows"]
    gat = tiny.load(tiny.GAT)
    names = [k for k, _ in gat.kind.kernel_work(gat.config["model"],
                                                 [n0, n1], ids)]
    assert names.count("gather_rows") == 5
    assert names.count("scatter_add_rows") == 3
