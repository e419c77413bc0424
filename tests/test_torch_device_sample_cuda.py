"""The tree-sampling kernel (``csrc/tree_sample.cu``) on a card, against
the plain path it replaced (skips without a card; imports nothing of the
JAX package, so the card's machine collects it: ``python -m pytest -m
cuda tests/test_torch_device_sample_cuda.py``).

The kernel must give what ``sample_fanout_tree_from_draws`` gives from
``tree_draws`` of the same key, bit for bit: every block's mask, table
and ``num_src``, the input ids, and every field of every plan (``src``
with its masked tail). Cases: the cell's fanouts (10, 25) at batch 1000
and (3, 4) at batch 7; an int32 and an int64 CSR; padded seeds, nodes
of degree 0 and an edgeless graph; plans of rows and of slots; the key
as Python ints and with a device step counter. A K = 4 CUDA graph of
sampling steps, replayed with the counter bumped, gives what eager
steps give; a captured K = 4 ``SampledTrainer`` run launches the kernel
twice a step and never the plain path.
"""

import numpy as np
import pytest
import torch

from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.graph import Graph
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.ops import device_sample as ds
from dgl_operator_tpu_torch.ops.scatter import ScatterPlan
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig

NODES, SEED = 300, 2**40 + 17


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tree-sampling kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def _csr(isolated: int, idt, dev):
    """The device CSR of a 300-node graph whose last ``isolated`` nodes
    have no in-edge (all 300: the edgeless graph's sentinel index)."""
    g = datasets.synthetic_node_clf(NODES, 1500, 8, 4, seed=11).graph
    keep = g.dst < NODES - isolated
    ip, ix = ds.device_csr(Graph(g.src[keep], g.dst[keep], NODES).csc(),
                           dev)
    return ip.to(idt), ix.to(idt)


def _seeds(batch: int, dtype, dev):
    """Seeds over every kind of row: low ids, isolated ones, -1 pads."""
    rng = np.random.default_rng(batch)
    s = rng.integers(0, NODES, batch)
    s[rng.random(batch) < 0.2] = -1
    s[:2] = (NODES - 1, -1)
    return torch.from_numpy(s).to(dtype).to(dev)


def _plain(ip, ix, seeds, fanouts, key, slot_plans):
    counters = ds.draw_counters(seeds.shape[0], fanouts, seeds.device)
    return ds.sample_fanout_tree_from_draws(
        ip, ix, seeds, fanouts, ds.tree_draws(key, counters, fanouts),
        plans=True, slot_plans=slot_plans)


def _assert_equal(got, want):
    (gb, gi), (wb, wi) = got, want
    assert gi.dtype == wi.dtype and torch.equal(gi, wi), "input ids"
    assert len(gb) == len(wb)
    for g, w in zip(gb, wb):
        assert g.num_src == w.num_src
        assert g.mask.dtype == w.mask.dtype == torch.uint8
        assert torch.equal(g.mask, w.mask) and torch.equal(g.nbr, w.nbr)
        assert (g.plan is None) == (w.plan is None)
        if w.plan is None:
            continue
        for k in ScatterPlan.FIELDS:
            a, b = getattr(g.plan, k), getattr(w.plan, k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert torch.equal(a, b), k


@pytest.mark.cuda
@pytest.mark.parametrize("batch,fanouts", [(1000, (10, 25)), (7, (3, 4))])
@pytest.mark.parametrize("idt", [torch.int32, torch.int64])
@pytest.mark.parametrize("isolated", [40, NODES])
@pytest.mark.parametrize("slot_plans", [False, True])
@pytest.mark.parametrize("counter", [False, True])
def test_kernel_equals_the_plain_path(batch, fanouts, idt, isolated,
                                      slot_plans, counter):
    dev = _card()
    ip, ix = _csr(isolated, idt, dev)
    seeds = _seeds(batch, idt, dev)
    step = torch.full((1,), 9, dtype=torch.int64, device=dev)
    key = ds.draw_key(SEED, step if counter else 9)
    before = ds.tree_sample.launches
    got = ds.sample_fanout_tree(ip, ix, seeds, fanouts, key, plans=True,
                                slot_plans=slot_plans)
    torch.cuda.synchronize()
    assert ds.tree_sample.launches - before == len(fanouts) + slot_plans
    _assert_equal(got, _plain(ip, ix, seeds, fanouts, key, slot_plans))
    # the key of Python ints alone gives the same draws as the counter's
    _assert_equal(got, _plain(ip, ix, seeds, fanouts, ds.draw_key(SEED, 9),
                              slot_plans))
    if isolated == NODES:
        assert not any(bool(b.mask.any()) for b in got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("seed_dtype", [torch.int32, torch.int64])
def test_kernel_takes_either_seed_type_and_no_plans(seed_dtype):
    """Seeds of the other index type than the CSR's, blocks without
    plans, three layers, and a key of a tensor between integers."""
    dev = _card()
    ip, ix = _csr(40, torch.int32, dev)
    seeds = _seeds(33, seed_dtype, dev)
    step = torch.tensor([5], device=dev)
    key = ds.draw_key(3, step, 2**35 + 1)
    fanouts = (2, 3, 4)
    before = ds.tree_sample.launches
    got = ds.sample_fanout_tree(ip, ix, seeds, fanouts, key)
    assert ds.tree_sample.launches - before == 3
    counters = ds.draw_counters(33, fanouts, dev)
    want = ds.sample_fanout_tree_from_draws(
        ip, ix, seeds, fanouts, ds.tree_draws(key, counters, fanouts))
    _assert_equal(got, want)
    assert all(b.plan is None for b in got[0])


def _flat(blocks, ids):
    out = [ids]
    for b in blocks:
        out.append(b.mask.view(-1))
        if b.plan is not None:
            out += [getattr(b.plan, k).view(-1) for k in ScatterPlan.FIELDS]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("slot_plans", [False, True])
def test_captured_k4_steps_equal_eager_steps(slot_plans):
    """K = 4 sampling steps captured in one CUDA graph, each keyed on a
    device step counter bumped inside the graph, replayed twice from two
    counters: each step's ids, masks and plans equal an eager step's
    under the key of Python ints. The capture launches the kernel
    ``len(fanouts) + slot_plans`` times a step."""
    dev = _card()
    fanouts, batch, k = (10, 25), 1000, 4
    ip, ix = _csr(40, torch.int32, dev)
    bank = torch.stack([_seeds(batch + j, torch.int32, dev)[:batch]
                        for j in range(k)])
    sampler = ds.TreeSampler(batch, fanouts, dev, slot_plans)
    gstep = torch.zeros(1, dtype=torch.int64, device=dev)

    def steps():
        outs = []
        for j in range(k):
            outs.append(_flat(*sampler.sample(ip, ix, bank[j],
                                              ds.draw_key(SEED, gstep))))
            gstep.add_(1)
        return outs

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        steps()                      # loads the kernel outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ds.tree_sample.launches
    with torch.cuda.graph(graph):
        outs = steps()
    assert ds.tree_sample.launches - before == k * (len(fanouts)
                                                    + slot_plans)
    for start in (100, 7):
        gstep.fill_(start)
        graph.replay()
        torch.cuda.synchronize()
        assert int(gstep) == start + k
        for j in range(k):
            want = _flat(*sampler.sample(ip, ix, bank[j],
                                         ds.draw_key(SEED, start + j)))
            assert len(outs[j]) == len(want)
            for a, b in zip(outs[j], want):
                assert torch.equal(a, b), (start, j)


@pytest.mark.cuda
def test_captured_trainer_samples_with_the_kernel_alone(monkeypatch):
    """``SampledTrainer`` with the device sampler at K = 4 (a CUDA graph
    a call) and K = 1: the kernel's launches are two a step (the
    warm-up's two, the first call's eager steps and each replay's
    included), the plain path never runs, and both give the same
    losses."""
    dev = _card()

    def refuse(*a, **kw):
        raise AssertionError("the plain sampling path ran on the card")

    monkeypatch.setattr(ds, "tree_draws", refuse)
    monkeypatch.setattr(ds, "sample_fanout_tree_from_draws", refuse)
    g = datasets.synthetic_node_clf(400, 2000, 8, 4, seed=3).graph
    losses = {}
    for k in (4, 1):
        cfg = TrainConfig(num_epochs=1, batch_size=16, fanouts=(3, 3),
                          eval_every=0, dropout=0.0, sampler="device",
                          steps_per_call=k, seed=5)
        model = DistSAGE(8, 8, 4, dropout=0.0, device=dev,
                         generator=torch.Generator().manual_seed(2))
        tr = SampledTrainer(model, g, cfg, device=dev)
        before = ds.tree_sample.launches
        out = tr.train()
        steps = int(out["step"])
        assert steps > 2 * k
        assert ds.tree_sample.launches - before == 2 + 2 * steps, k
        losses[k] = [x for rec in out["history"] for x in rec["losses"]]
    np.testing.assert_allclose(losses[4], losses[1], rtol=1e-6)
