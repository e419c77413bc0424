"""The reference against the program on the CPU: its sampler against the
device sampler's draws, its in-edge lists against the program's CSC, the
copied generator against the program's, and the whole comparison
against a tiny run of the port's trainer."""

import numpy as np
import pytest
import torch

from portbench import data
from portbench.drivers import closed_train
from portbench.reference import sampler
from portbench.tests.tiny import CELLS, tiny_cell


def _graph(n=400, e=3000, seed=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 20, e).astype(np.int32)   # 20 sourceless
    dst = rng.integers(0, n - 40, e).astype(np.int32)   # 40 without in-edges
    return src, dst, n


def test_in_csr_is_the_programs_csc():
    from dgl_operator_tpu_torch.graph.graph import Graph
    src, dst, n = _graph()
    indptr, indices, _ = Graph(src, dst, n).csc()
    ref_ptr, ref_idx = sampler.in_csr(torch.from_numpy(src),
                                      torch.from_numpy(dst), n)
    assert np.array_equal(ref_ptr.numpy(), indptr)
    assert np.array_equal(ref_idx.numpy(), indices)


@pytest.mark.parametrize("step", [0, 1, 7, 2**40 + 3])
def test_sampler_draws_what_the_device_sampler_draws(step):
    from dgl_operator_tpu_torch.graph.graph import Graph
    from dgl_operator_tpu_torch.ops.device_sample import (TreeSampler,
                                                          device_csr,
                                                          draw_key)
    src, dst, n = _graph()
    ptr, idx = device_csr(Graph(src, dst, n).csc(), "cpu")
    seeds = torch.tensor(list(range(340, 380)) + [5, -1, -1, 399],
                         dtype=torch.int32)
    seed = 2**31 + 11
    blocks, ids = TreeSampler(len(seeds), (3, 4), "cpu").sample(
        ptr, idx, seeds, draw_key(seed, step))
    ref_ptr, ref_idx = sampler.in_csr(torch.from_numpy(src),
                                      torch.from_numpy(dst), n)
    masks, ref_ids = sampler.sample_tree(ref_ptr, ref_idx, seeds.long(),
                                         (3, 4), sampler.draw_key(seed, step))
    assert torch.equal(ids.long(), ref_ids)
    for blk, m in zip(blocks, masks):
        assert torch.equal(blk.mask > 0, m)
    assert sampler.draw_key(seed, step) == draw_key(seed, step)


def test_generator_is_the_programs():
    from dgl_operator_tpu_torch.graph.datasets import ogbn_products
    scale = 0.002
    ds = ogbn_products(scale=scale, with_feats=False)
    spec = dict(tiny_cell(CELLS[0]).config["graph"],
                num_nodes=int(2_449_029 * scale),
                num_edges=int(30_000_000 * scale), seed=0)
    mine = data.synthetic_products(spec)
    g = ds.graph
    assert np.array_equal(mine["src"], g.src)
    assert np.array_equal(mine["dst"], g.dst)
    assert np.array_equal(mine["labels"], g.ndata["label"])
    assert np.array_equal(mine["train_ids"],
                          np.nonzero(g.ndata["train_mask"])[0])


def test_graph_cache_round_trip(tmp_path):
    spec = dict(tiny_cell(CELLS[0]).config["graph"], num_nodes=1500,
                num_edges=6000)
    made = data.load_graph(spec, str(tmp_path))
    again = data.load_graph(spec, str(tmp_path))
    for k in made:
        assert np.array_equal(made[k], again[k])
    assert (tmp_path / "graphs" / data.graph_key(spec) / "src.npy").exists()


def test_draws_repeat_from_the_seed():
    labels = torch.tensor([0, 2, 1, 2, 0])
    a = data.fill_features(torch.empty(5, 3), labels, 9, 0.8)
    b = data.fill_features(torch.empty(5, 3), labels, 9, 0.8)
    assert torch.equal(a, b)
    cell = tiny_cell(CELLS[1])
    spec = cell.kind.param_spec(cell.config["model"])
    w1 = data.init_weights(spec, 5, "cpu")
    w2 = data.init_weights(spec, 5, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    for name, shape, init, bound in spec:
        assert tuple(w1[name].shape) == shape
        assert float(w1[name].abs().max()) <= bound
    assert data.run_seeds(2**31 + 5) == data.run_seeds(2**31 + 5)
    assert data.run_seeds(2**31 + 5) != data.run_seeds(2**31 + 6)


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_a_tiny_run_of_the_port(name, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(data, "CACHE", str(tmp_path))
    cell = tiny_cell(name)
    rec = closed_train.run(cell, 2**31 + 101, 0.5, False,
                           torch.device("cpu"), 0.0)
    values = {k: v["value"] for k, v in rec["compared"].items()}
    assert values["mask_gap"] == 0 and values["rows_gap"] == 0
    # the first gradient agrees to rounding; the later steps take the
    # CPU's Adam, whose bias corrections are double (the card's float32)
    assert values.get("grad_gap", values.get("grad_median_gap")) < 1e-6
    assert values["loss_gap"] < 1e-4
    assert rec["correct"] and rec["failed"] == 0 and rec["attempted"] > 0
