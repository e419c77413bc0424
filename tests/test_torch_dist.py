"""The port's partition-parallel trainer vs the JAX package's, end to end.

One 4-part book of ``synthetic_node_clf(800, 4000, 16, 4, seed=3)``
written by the JAX partitioner, as ``tests/test_dist.py`` builds it.
The JAX ``DistTrainer`` runs on a 4-slot virtual CPU mesh; the port's
``DistTrainer(device="cpu")`` starts from the JAX trainer's initial
params (``_init_params()``) and draws the same permutations and
per-slot sampling streams, so in both feature layouts the two must
agree: equal caps, pads, pair cap and steps per epoch, per-epoch losses
within rtol 1e-3, final params within 1e-3 and accuracies within one
node's share. Both sample with their C++ graph cores
(``test_torch_native.use_jax_graphcore``); the JAX side runs without
the tuned-manifest overlay and without its sentry.
"""

import jax
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph.partition import partition_graph
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.parallel import make_mesh
from dgl_operator_tpu.runtime import DistTrainer as JaxDistTrainer
from dgl_operator_tpu.runtime import TrainConfig as JaxTrainConfig
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models.sage import (DistSAGE, sage_inference,
                                                state_dict_from_flax,
                                                state_dict_to_flax)
from dgl_operator_tpu_torch.parallel.dp import slot_mean_step
from dgl_operator_tpu_torch.runtime.checkpoint import CheckpointManager
from dgl_operator_tpu_torch.runtime.dist import DistTrainer
from dgl_operator_tpu_torch.runtime.loop import TrainConfig
from test_torch_native import use_jax_graphcore

FEAT, HIDDEN, CLASSES = 16, 32, 4
LAYOUTS = ("replicated", "owner")
TRAIN_TOL = dict(rtol=1e-3, atol=1e-3)
PREDICT_IDS = np.arange(0, 800, 7)


def _graph_args():
    return dict(num_nodes=800, num_edges=4000, feat_dim=FEAT,
                num_classes=CLASSES, seed=3)


def _cfg_kw(layout):
    return dict(num_epochs=2, batch_size=32, lr=0.01, fanouts=(4, 4),
                log_every=1000, eval_every=2, feats_layout=layout)


@pytest.fixture(autouse=True)
def jax_library(monkeypatch, tmp_path_factory):
    use_jax_graphcore(monkeypatch, tmp_path_factory)
    monkeypatch.delenv("TPU_OPERATOR_TUNED_MANIFEST", raising=False)


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        use_jax_graphcore(mp, tmp_path_factory)
        ds = jax_datasets.synthetic_node_clf(**_graph_args())
        out = tmp_path_factory.mktemp("torch_dist")
        return partition_graph(ds.graph, "synth", 4, str(out))


@pytest.fixture(scope="module")
def jax_runs(book, tmp_path_factory):
    """Per layout: the JAX trainer, its initial params, its run and its
    logits for ``PREDICT_IDS`` with the final params."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        use_jax_graphcore(mp, tmp_path_factory)
        mp.delenv("TPU_OPERATOR_TUNED_MANIFEST", raising=False)
        for layout in LAYOUTS:
            tr = JaxDistTrainer(
                JaxDistSAGE(hidden_feats=HIDDEN, out_feats=CLASSES,
                            dropout=0.0), book, make_mesh(num_dp=4),
                JaxTrainConfig(**_cfg_kw(layout), sentry=False))
            init = jax.device_get(tr._init_params())
            out = tr.train()
            params = jax.device_get(out["params"])
            logits = tr.predict(params, PREDICT_IDS, sample_seed=3)
            runs[layout] = (tr, init, out, params, np.asarray(logits))
    return runs


def _port(book, layout, **kw):
    model = DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.0, device="cpu")
    cfg = TrainConfig(**dict(_cfg_kw(layout), dropout=0.0, **kw))
    return DistTrainer(model, book, cfg, device="cpu")


@pytest.fixture(scope="module")
def port_runs(book, jax_runs):
    return {layout: (tr, tr.train(init_params=jax_runs[layout][1]))
            for layout in LAYOUTS
            for tr in [_port(book, layout)]}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_static_shapes_match_jax(jax_runs, port_runs, layout):
    jtr = jax_runs[layout][0]
    tr = port_runs[layout][0]
    assert tr.caps == list(jtr.caps)
    assert (tr.n_pad, tr.c_pad, tr.h_pad) == (jtr.n_pad, jtr.c_pad,
                                              jtr.h_pad)
    assert tr.steps_per_epoch == max(jtr._global_min_train // 32, 1)
    assert [len(t) for t in tr.train_ids] == [len(t) for t in jtr.train_ids]
    if layout == "owner":
        assert tr.pair_cap == jtr._pair_cap
        assert tr.cache_rows == jtr.cache_rows
        assert tuple(tr.feats.shape) == tuple(jtr.feats.shape)
        assert tr.feats.shape[1] == tr.c_pad + tr.cache_rows < tr.n_pad
    else:
        assert tuple(tr.feats.shape) == (4, tr.n_pad, FEAT)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_training_matches_jax(jax_runs, port_runs, layout):
    _, _, want, ref, _ = jax_runs[layout]
    tr, got = port_runs[layout]
    assert got["step"] == want["step"] == 2 * tr.steps_per_epoch
    assert len(got["history"]) == len(want["history"]) == 2
    for g_rec, w_rec in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g_rec["loss"], w_rec["loss"], **TRAIN_TOL)
    final = state_dict_to_flax(got["params"])["params"]
    for layer, subs in final.items():
        for sub, leaves in subs.items():
            for leaf, value in leaves.items():
                np.testing.assert_allclose(
                    value, np.asarray(ref["params"][layer][sub][leaf]),
                    err_msg=f"{layer}/{sub}/{leaf}", **TRAIN_TOL)
    if layout == "owner":
        rec = got["history"][-1]
        # the JAX record rounds to 0.01 MiB
        assert rec["exchange_mib"] == pytest.approx(
            want["history"][-1]["exchange_mib"], abs=5e-3)
        assert rec["halo_rows_per_step"] > 0


def test_owner_layout_equals_replicated(port_runs):
    """Same rows, same math: the owner layout's losses are the
    replicated layout's, bit for bit on the CPU."""
    (_, rep), (_, own) = port_runs["replicated"], port_runs["owner"]
    assert [h["losses"] for h in own["history"]] == \
        [h["losses"] for h in rep["history"]]
    for k, v in rep["params"].items():
        assert torch.equal(own["params"][k], v), k


@pytest.mark.parametrize("layout", LAYOUTS)
def test_evaluate_matches_jax_and_single_graph_inference(jax_runs,
                                                         port_runs, layout):
    want = jax_runs[layout][2]["history"][-1]
    tr, got = port_runs[layout]
    rec = got["history"][-1]
    g = datasets.synthetic_node_clf(**_graph_args()).graph
    n = {k: int(g.ndata[k].sum()) for k in ("val_mask", "test_mask")}
    for key, mask in (("val_acc", "val_mask"), ("test_acc", "test_mask")):
        assert abs(rec[key] - want[key]) <= 1 / n[mask] + 1e-6, key
    # the same weights through the single-graph layer-wise inference
    with torch.no_grad():
        logits = sage_inference(tr.model, g,
                                torch.from_numpy(g.ndata["feat"]))
    pred = logits.argmax(-1).numpy()
    accs = tr.evaluate()
    for mask in ("val_mask", "test_mask"):
        m = g.ndata[mask].astype(bool)
        single = float((pred[m] == g.ndata["label"][m]).mean())
        assert abs(accs[mask] - single) <= 1 / n[mask] + 1e-6, mask


@pytest.mark.parametrize("layout", LAYOUTS)
def test_predict_matches_jax(book, jax_runs, layout):
    """The serving path with the JAX trainer's final params: logits
    within 1e-4 of the JAX trainer's ``predict``."""
    _, _, _, params, want = jax_runs[layout]
    tr = _port(book, layout)
    tr.model.load_state_dict(state_dict_from_flax(params))
    got = tr.predict(PREDICT_IDS, sample_seed=3)
    assert got.shape == want.shape == (len(PREDICT_IDS), CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_resume_is_bit_exact(book, tmp_path, layout):
    """A run killed after 4 of its 6 steps (checkpoints every 2) and
    resumed by a fresh trainer ends on the uninterrupted run's params,
    bit for bit."""
    full = _port(book, layout, eval_every=0)
    want = full.train()
    assert want["step"] == 6
    first = _port(book, layout, eval_every=0, ckpt_dir=str(tmp_path),
                  ckpt_every=2)
    step, taken = first.train_step, []

    def dying_step(batch):
        if len(taken) == 4:
            raise RuntimeError("killed")
        taken.append(1)
        return step(batch)

    first.train_step = dying_step
    with pytest.raises(RuntimeError, match="killed"):
        first.train()
    assert CheckpointManager(str(tmp_path)).latest_step() == 4
    resumed = _port(book, layout, eval_every=0, ckpt_dir=str(tmp_path))
    got = resumed.train()
    assert got["step"] == 6
    assert [h["epoch"] for h in got["history"]] == [1]
    assert got["history"][0]["losses"] == want["history"][1]["losses"][1:]
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    for i, st in want["opt_state"]["state"].items():
        for name, t in st.items():
            assert torch.equal(got["opt_state"]["state"][i][name], t)


def test_empty_slot_counts_in_the_gradient_mean():
    """The mean divides by every slot: a slot with no seeds adds a zero
    gradient and halves the others' weight."""
    w = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.SGD([w], lr=1.0)
    targets = [torch.tensor([1.0, 2.0, 3.0]), None]

    def loss_of(s):
        if targets[s] is None:
            return (w * 0).sum()
        return (w * targets[s]).sum()

    loss, stats = slot_mean_step(opt, loss_of, 2)
    assert stats is None
    assert float(loss) == 0.0
    assert torch.equal(w.detach(), -torch.tensor([0.5, 1.0, 1.5]))


@pytest.mark.parametrize("field,value", [
    ("sampler", "device"), ("steps_per_call", 2), ("feat_dtype", "bfloat16"),
    ("shard_update", True), ("shard_rules", ((".*", "dp"),)),
    ("zero_stage", 3), ("tp_axis_size", 2)])
def test_unported_dist_knobs_raise(book, field, value):
    """The knobs the port lacked. ``sampler="device"`` and
    ``feat_dtype="bfloat16"`` are ported: they are accepted and train
    (the store then holds bfloat16). ``steps_per_call > 1`` is ported
    for the device sampler only: with the host sampler it is the JAX
    trainer's ``ValueError``. The sharding knobs are ported: each trains
    (``tp_axis_size=2`` on its ``dp x mp`` mesh) with the replicated
    run's weights, bit for bit."""
    if field == "feat_dtype":
        tr = _port(book, "replicated", **{field: value})
        assert tr.feats.dtype == torch.bfloat16
        out = tr.train()
        assert out["step"] == 2 * tr.steps_per_epoch
        assert np.isfinite([x for r in out["history"]
                            for x in r["losses"]]).all()
        return
    if field == "sampler":
        tr = _port(book, "replicated", **{field: value})
        out = tr.train()
        assert out["step"] == 2 * tr.steps_per_epoch
        assert np.isfinite([x for r in out["history"]
                            for x in r["losses"]]).all()
        return
    if field == "steps_per_call":
        with pytest.raises(ValueError, match="requires sampler='device'"):
            _port(book, "replicated", **{field: value})
        return
    tr = _port(book, "replicated", num_epochs=1, **{field: value})
    out = tr.train()
    assert (tr._plan is not None) == (field != "tp_axis_size")
    if field == "tp_axis_size":
        assert tr.mesh.shape == {"dp": 4, "mp": 2}
    want = _port(book, "replicated", num_epochs=1).train()
    for k, v in want["params"].items():
        assert torch.equal(out["params"][k], v), k


def test_unknown_layout_and_pipeline_knobs_raise(book):
    with pytest.raises(ValueError, match="unknown feats_layout"):
        _port(book, "onwer")
    for field, value in (("pipeline_mode", "overlapped"),
                         ("pipeline_depth", 0)):
        with pytest.raises(ValueError, match=field):
            _port(book, "owner", **{field: value})
