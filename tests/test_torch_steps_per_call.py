"""``steps_per_call`` and the device sampler in the port's two trainers.

The grouping (``chunk_calls``) and the stacking of host batches
(``stack_minibatches``) against the JAX package's. Then the port's own
contracts, which the JAX package states for its scan: K steps a call
train exactly what K single steps train, so K = 1 and K = 3 give equal
losses and parameters bit for bit (the epoch's tail included) in
``SampledTrainer`` with either sampler and in ``DistTrainer`` with the
device sampler in both feature layouts; the owner layout equals the
replicated one bit for bit; two gloo ranks in device mode equal one
process (bit for bit at 2 parts; at 4 parts on 2 ranks within 1e-6 of
the largest entry, as ``tests/test_torch_multiprocess.py`` holds the
host sampler); and a device-mode run cut at a checkpoint and resumed
equals the uninterrupted run bit for bit (dropout 0). On the CPU a call
of K steps runs eagerly; the captured CUDA graph is exercised on a card
by ``tests/test_torch_ops.py``'s ``cuda`` test of it and by
``chip_smoke.py``.
"""

import os

import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import blocks as jax_blocks
from dgl_operator_tpu.runtime import loop as jax_loop
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.blocks import stack_minibatches
from dgl_operator_tpu_torch.graph.partition import partition_graph
from dgl_operator_tpu_torch.models.sage import DistSAGE, state_dict_to_flax
from dgl_operator_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                       export_for_serving,
                                                       load_params)
from dgl_operator_tpu_torch.runtime.dist import DistTrainer
from dgl_operator_tpu_torch.runtime.graphs import GraphedCall
from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                 TrainConfig, chunk_calls)
from test_torch_multiprocess import _hostfile, _run_two_ranks
import torch_mp_worker as worker

FEAT, HIDDEN, CLASSES = 12, 16, 4
DFEAT, DHIDDEN = 16, 32
LAYOUTS = ("replicated", "owner")
SAMPLERS = ("host", "device")


@pytest.fixture(scope="module")
def graph():
    # 300 nodes: 7 steps an epoch of 24 seeds, so K = 3 leaves a tail
    return datasets.synthetic_node_clf(300, 1500, FEAT, CLASSES,
                                       seed=11).graph


@pytest.fixture(scope="module")
def books(tmp_path_factory):
    g = datasets.synthetic_node_clf(800, 4000, DFEAT, CLASSES, seed=3).graph
    return {P: partition_graph(g, "synth", P,
                               str(tmp_path_factory.mktemp(f"spc{P}")))
            for P in (2, 4)}


def _sampled(graph, **kw):
    cfg = dict(num_epochs=2, batch_size=24, fanouts=(3, 4), eval_every=2,
               log_every=1000, dropout=0.5, seed=5, prefetch=1)
    model = DistSAGE(FEAT, HIDDEN, CLASSES, device="cpu",
                     generator=torch.Generator().manual_seed(2))
    return SampledTrainer(model, graph, TrainConfig(**{**cfg, **kw}),
                          device="cpu")


def _dist(book, layout, **kw):
    cfg = dict(num_epochs=2, batch_size=32, lr=0.01, fanouts=(4, 4),
               log_every=1000, eval_every=2, feats_layout=layout,
               dropout=0.0, sampler="device")
    model = DistSAGE(DFEAT, DHIDDEN, CLASSES, dropout=0.0, device="cpu",
                     generator=torch.Generator().manual_seed(4))
    return DistTrainer(model, book, TrainConfig(**{**cfg, **kw}),
                       device="cpu")


def _losses(out):
    return [x for rec in out["history"] for x in rec["losses"]]


def _assert_same(a, b):
    assert _losses(a) == _losses(b)
    assert a["step"] == b["step"]
    assert a["params"].keys() == b["params"].keys()
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k


@pytest.mark.parametrize("n,k", [(0, 3), (1, 3), (7, 1), (7, 3), (9, 3),
                                 (10, 4), (5, 8)])
def test_chunk_calls_matches_jax(n, k):
    items = [(b, 100 + b) for b in range(n)]
    assert chunk_calls(items, k) == jax_loop.chunk_calls(items, k)


def test_stack_minibatches_matches_jax(graph):
    tr = _sampled(graph, cap_policy="worst")
    mbs = [tr.sample(tr.train_ids[b * 24:(b + 1) * 24], b)
           for b in range(3)]
    got = stack_minibatches(mbs)
    want = jax_blocks.stack_minibatches([jax_blocks.MiniBatch(
        mb.input_nodes, mb.seeds,
        [jax_blocks.FanoutBlock(b.nbr, b.mask, b.num_src)
         for b in mb.blocks]) for mb in mbs])
    np.testing.assert_array_equal(got.input_nodes, want.input_nodes)
    np.testing.assert_array_equal(got.seeds, want.seeds)
    assert got.input_nodes.shape[0] == 3
    for g, w in zip(got.blocks, want.blocks):
        assert g.num_src == w.num_src and g.plan is None
        np.testing.assert_array_equal(g.nbr, w.nbr)
        np.testing.assert_array_equal(g.mask, w.mask)


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_sampled_k3_equals_k1_bit_for_bit(graph, sampler):
    """With dropout on: the K-step calls draw the same masks in the same
    order as single steps."""
    one = _sampled(graph, sampler=sampler).train()
    tr = _sampled(graph, sampler=sampler, steps_per_call=3)
    three = tr.train()
    assert one["step"] == 14 and len(_losses(one)) == 14
    _assert_same(one, three)
    rec = three["history"][0]
    # 7 steps: two calls of 3, then the tail's single step
    assert rec["calls"] == 3 and len(rec["step_s"]) == 7
    assert rec["graph"] is False and rec["graph_replays"] == 0
    assert "val_acc" not in rec and 0 <= three["history"][1]["val_acc"]


def test_device_sampler_draws_follow_the_global_step(graph):
    """The device sampler keys its draws on (seed, global step): a
    different seed gives other losses, the same seed the same."""
    a = _losses(_sampled(graph, sampler="device", dropout=0.0).train())
    b = _losses(_sampled(graph, sampler="device", dropout=0.0).train())
    c = _losses(_sampled(graph, sampler="device", dropout=0.0,
                         seed=6).train())
    assert a == b and a != c
    assert all(np.isfinite(a))


def test_device_sampler_caps_are_the_trees(graph):
    tr = _sampled(graph, sampler="device")
    assert tr.caps == [24, 24 * 5, 24 * 5 * 4]
    assert tr._indptr.dtype == torch.int32


@pytest.mark.parametrize("layout", LAYOUTS)
def test_dist_device_k3_equals_k1_and_owner_equals_replicated(books,
                                                              layout):
    one = _dist(books[2], layout).train()
    three = _dist(books[2], layout, steps_per_call=3).train()
    _assert_same(one, three)
    rep = _dist(books[2], "replicated").train()
    _assert_same(one, rep)
    rec = three["history"][-1]
    spe = len(rec["losses"])
    assert rec["graph"] is False and rec["h2d_bytes_per_step"] > 0
    assert rec["calls"] == spe // 3 + spe % 3
    if layout == "owner":
        # the same halo rows, counted on the device in either call form
        halo = [r["halo_rows_per_step"] for r in three["history"]]
        assert halo == [r["halo_rows_per_step"] for r in one["history"]]
        assert min(halo) > 0


def test_dist_device_owner_rows_are_the_stores_rows(books):
    """The owner layout's translated rows equal the replicated layout's
    rows for the same ids, four slots in one process."""
    own = _dist(books[4], "owner")
    rep = _dist(books[4], "replicated")
    gen = torch.Generator().manual_seed(0)
    ids = torch.stack([torch.randint(0, p.graph.num_nodes, (200,),
                                     generator=gen, dtype=torch.int32)
                       for p in own.parts])
    got = own.owner_rows(ids)
    want = torch.stack([rep.feats[i][ids[i].long()] for i in range(4)])
    assert torch.equal(got, want)
    # the halo rows counted: those neither core nor in the slot's cache
    owner_m, _ = own._host_halo
    fetched = 0
    for i, p in enumerate(own.parts):
        h = ids[i].numpy().astype(np.int64) - p.num_inner
        h = h[h >= 0]
        fetched += int(((own._cache_slot[i][h] < 0)
                        & (owner_m[i, h] >= 0)).sum())
    assert fetched > 0 and int(own._dev_halo_rows) == fetched


def test_dist_steps_per_call_needs_the_device_sampler(books):
    with pytest.raises(ValueError, match="requires sampler='device'"):
        _dist(books[2], "replicated", sampler="host", steps_per_call=2)


def test_graphed_call_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        GraphedCall(lambda: torch.zeros(1), torch.device("cpu"))


def _cut_and_resume(make, kill_at, ckpt_dir):
    """``make(**fields)``'s run that checkpoints every ``kill_at`` steps,
    killed as it begins the call after step ``kill_at``, then resumed by
    a fresh trainer."""
    first = make(ckpt_dir=ckpt_dir, ckpt_every=kill_at)
    call, taken = first.train_call, []

    def dying_call(batch):
        if len(taken) >= kill_at:
            raise RuntimeError("killed")
        losses, acc = call(batch)
        taken.extend([1] * len(losses))
        return losses, acc

    first.train_call = dying_call
    with pytest.raises(RuntimeError, match="killed"):
        first.train()
    assert CheckpointManager(ckpt_dir).latest_step() == kill_at
    return make(ckpt_dir=ckpt_dir).train()


def test_sampled_device_resume_is_bit_exact(graph, tmp_path):
    """K = 3 with dropout 0, cut after 10 steps (mid second epoch, at a
    call boundary: the epochs' calls end at steps 3, 6, 7, 10, 13, 14)
    and resumed."""
    def make(**kw):
        return _sampled(graph, sampler="device", steps_per_call=3,
                        dropout=0.0, **kw)

    want = make().train()
    got = _cut_and_resume(make, 10, str(tmp_path / "ck"))
    assert got["step"] == want["step"] == 14
    assert got["history"][0]["losses"] == _losses(want)[10:]
    for k, v in got["params"].items():
        assert torch.equal(v, want["params"][k]), k


@pytest.mark.parametrize("layout", LAYOUTS)
def test_dist_device_resume_is_bit_exact(books, tmp_path, layout):
    def make(**kw):
        return _dist(books[2], layout, steps_per_call=2, **kw)

    want = make().train()
    spe = len(want["history"][0]["losses"])
    kill_at = spe + 2
    got = _cut_and_resume(make, kill_at, str(tmp_path / "ck"))
    assert got["history"][0]["losses"] == _losses(want)[kill_at:]
    for k, v in got["params"].items():
        assert torch.equal(v, want["params"][k]), k


def _job(name, book, layout, **kw):
    return {"name": name, "book": book, "dims": [DFEAT, DHIDDEN, CLASSES],
            "cfg": dict(num_epochs=2, batch_size=32, lr=0.01,
                        fanouts=(4, 4), log_every=1000, eval_every=2,
                        feats_layout=layout, dropout=0.0, sampler="device",
                        **kw)}


@pytest.fixture(scope="module")
def mp_runs(books, tmp_path_factory):
    """Two gloo ranks and the single process on device-mode jobs, and a
    two-rank device-mode run cut and resumed."""
    tmp = str(tmp_path_factory.mktemp("spc_ranks"))
    init = state_dict_to_flax(DistSAGE(
        DFEAT, DHIDDEN, CLASSES, device="cpu",
        generator=torch.Generator().manual_seed(7)).state_dict())
    init_path = export_for_serving(tmp + os.sep, init)
    jobs = [_job("p2_owner_k1", books[2], "owner"),
            _job("p2_owner_k3", books[2], "owner", steps_per_call=3),
            _job("p2_replicated_k3", books[2], "replicated",
                 steps_per_call=3),
            _job("p4_owner_k2", books[4], "owner", steps_per_call=2)]
    spec = {"mode": "trainer", "hostfile": _hostfile(tmp),
            "init": init_path, "jobs": jobs,
            "resume": {"job": _job("resumed", books[2], "owner",
                                   steps_per_call=2),
                       "ckpt_dir": os.path.join(tmp, "ckpt"),
                       "kill_at": 4}}
    ranks = _run_two_ranks(spec, tmp)[1]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params = load_params(init_path)
        single = {}
        for job in jobs:
            single.update(worker.run_job(job, params))
    finally:
        torch.set_num_threads(threads)
    return ranks, single


def _params(arrays, name):
    prefix = f"{name}/params/"
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("name", ["p2_owner_k1", "p2_owner_k3",
                                  "p2_replicated_k3"])
def test_two_gloo_ranks_equal_one_process_in_device_mode(mp_runs, name):
    ranks, single = mp_runs
    for r, got in enumerate(ranks):
        assert got[f"{name}/my_parts"].tolist() == [r]
        for key in ("losses", "step", "caps", "acc"):
            np.testing.assert_array_equal(got[f"{name}/{key}"],
                                          single[f"{name}/{key}"], key)
        for k, v in _params(single, name).items():
            np.testing.assert_array_equal(_params(got, name)[k], v, k)
    np.testing.assert_array_equal(single["p2_owner_k1/losses"],
                                  single["p2_owner_k3/losses"])
    np.testing.assert_array_equal(single["p2_owner_k1/losses"],
                                  single["p2_replicated_k3/losses"])


def test_four_parts_on_two_gloo_ranks_in_device_mode(mp_runs):
    ranks, single = mp_runs
    name = "p4_owner_k2"
    want = single[f"{name}/losses"]
    for r, got in enumerate(ranks):
        assert got[f"{name}/my_parts"].tolist() == [2 * r, 2 * r + 1]
        np.testing.assert_allclose(got[f"{name}/losses"], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_two_gloo_ranks_resume_in_device_mode(mp_runs):
    ranks, _ = mp_runs
    for got in ranks:
        whole = got["p2_owner_k1/losses"]
        np.testing.assert_array_equal(got["resumed/losses"], whole[4:])
        want = _params(got, "p2_owner_k1")
        for k, v in _params(got, "resumed").items():
            np.testing.assert_array_equal(v, want[k], k)
