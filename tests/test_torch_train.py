"""The port's sampled trainer vs the JAX package's, end to end.

Both packages build the same synthetic graph from one numpy seed. The
JAX ``SampledTrainer`` initialises its params on its warm-up batch; the
port's trainer starts from those params (``train(init_params=...)``)
and draws the same permutation and batch stream, so with dropout 0 the
two must agree: the same caps, per-epoch losses within rtol 1e-3,
final params within 1e-3 and evaluation accuracies within one node's
share. Both sample with their C++ graph cores (the JAX bridge on a
build of its own source, ``test_torch_native.use_jax_graphcore``), and
the JAX side runs without the tuned-manifest overlay.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.runtime import SampledTrainer as JaxSampledTrainer
from dgl_operator_tpu.runtime import TrainConfig as JaxTrainConfig
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models.sage import (DistSAGE,
                                                state_dict_from_flax,
                                                state_dict_to_flax)
from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                 TrainConfig, masked_loss)
from test_torch_native import use_jax_graphcore

FEAT, HIDDEN, CLASSES = 12, 16, 4
FANOUTS = (3, 4)
BATCH = 32
EPOCHS = 3
# Adam from the same params on the same batches: float32 sums taken in
# another order drift a little more each step
TRAIN_TOL = dict(rtol=1e-3, atol=1e-3)


def _graph_args():
    return dict(num_nodes=300, num_edges=1500, feat_dim=FEAT,
                num_classes=CLASSES, seed=11)


@pytest.fixture(autouse=True)
def jax_library(monkeypatch, tmp_path_factory):
    use_jax_graphcore(monkeypatch, tmp_path_factory)
    monkeypatch.delenv("TPU_OPERATOR_TUNED_MANIFEST", raising=False)


@pytest.fixture(scope="module")
def port_graph():
    return datasets.synthetic_node_clf(**_graph_args()).graph


def _cfg_kw(prefetch):
    return dict(num_epochs=EPOCHS, batch_size=BATCH, fanouts=FANOUTS,
                eval_every=1, log_every=1000, dropout=0.0, seed=5,
                prefetch=prefetch)


def _jax_run(prefetch):
    """The JAX trainer's run and the params it started from."""
    g = jax_datasets.synthetic_node_clf(**_graph_args()).graph
    model = JaxDistSAGE(hidden_feats=HIDDEN, out_feats=CLASSES,
                        dropout=0.0)
    tr = JaxSampledTrainer(model, g, JaxTrainConfig(
        **_cfg_kw(prefetch), sentry=False))
    # what train() does first: init on the warm-up batch
    mb = tr.sample(tr.train_ids[:BATCH], 0)
    init = jax.device_get(model.init(
        jax.random.PRNGKey(5), mb.blocks,
        tr.feats[jnp.asarray(mb.input_nodes)], train=False))
    return tr, init, tr.train()


@pytest.mark.parametrize("prefetch", [0, 2])
def test_trainer_matches_jax_trainer(port_graph, prefetch):
    jtr, init, want = _jax_run(prefetch)
    model = DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.0, device="cpu")
    tr = SampledTrainer(model, port_graph, TrainConfig(**_cfg_kw(prefetch)),
                        device="cpu")
    assert tr.caps == list(jtr.caps)
    got = tr.train(init_params=init)
    assert got["step"] == want["step"] == EPOCHS * (
        len(tr.train_ids) // BATCH)
    assert len(got["history"]) == len(want["history"]) == EPOCHS
    for g_rec, w_rec in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g_rec["loss"], w_rec["loss"],
                                   **TRAIN_TOL)
        n_val = int(port_graph.ndata["val_mask"].sum())
        n_test = int(port_graph.ndata["test_mask"].sum())
        assert abs(g_rec["val_acc"] - w_rec["val_acc"]) <= 1 / n_val + 1e-6
        assert abs(g_rec["test_acc"] - w_rec["test_acc"]) <= \
            1 / n_test + 1e-6
        assert len(g_rec["losses"]) == len(g_rec["step_s"])
        assert g_rec["losses"][-1] == g_rec["loss"]
    final = state_dict_to_flax(got["params"])["params"]
    ref = jax.device_get(want["params"])["params"]
    for layer, subs in final.items():
        for sub, leaves in subs.items():
            for leaf, value in leaves.items():
                np.testing.assert_allclose(
                    value, np.asarray(ref[layer][sub][leaf]),
                    err_msg=f"{layer}/{sub}/{leaf}", **TRAIN_TOL)


def test_first_step_loss_matches_jax_loss(port_graph):
    """The masked loss of one padded batch (padded seeds are -1) equals
    the JAX trainer's loss function on the same params and batch."""
    g = jax_datasets.synthetic_node_clf(**_graph_args()).graph
    jmodel = JaxDistSAGE(hidden_feats=HIDDEN, out_feats=CLASSES,
                         dropout=0.0)
    jtr = JaxSampledTrainer(jmodel, g, JaxTrainConfig(**_cfg_kw(0),
                                                       sentry=False))
    # a short final batch: 20 seeds padded to 32
    mb = jtr.sample(jtr.train_ids[:20], 3)
    init = jax.device_get(jmodel.init(jax.random.PRNGKey(0), mb.blocks,
                                      jtr.feats[jnp.asarray(
                                          mb.input_nodes)]))
    loss_fn = jtr._make_loss_fn()
    want_loss, want_acc = loss_fn(init, mb.blocks,
                                  jnp.asarray(mb.input_nodes),
                                  jnp.asarray(mb.seeds),
                                  jax.random.PRNGKey(1))
    model = DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.0, device="cpu")
    tr = SampledTrainer(model, port_graph, TrainConfig(**_cfg_kw(0)),
                        device="cpu")
    model.load_state_dict(state_dict_from_flax(init))
    pmb = tr.sample(tr.train_ids[:20], 3)
    assert (pmb.seeds == mb.seeds).all() and (pmb.seeds[20:] == -1).all()
    with torch.no_grad():
        loss, acc = tr.loss(tr.ship(pmb))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert abs(float(acc) - float(want_acc)) < 1e-6


def test_masked_loss_ignores_padded_seeds():
    logits = torch.tensor([[2.0, 0.0], [0.0, 3.0], [9.0, -9.0]])
    labels = torch.tensor([0, 1, 1])
    seeds = torch.tensor([0, 1, -1], dtype=torch.int32)
    loss, acc = masked_loss(logits, labels, seeds)
    want = torch.nn.functional.cross_entropy(logits[:2], labels[:2])
    assert torch.allclose(loss, want) and float(acc) == 1.0


def test_pipelined_and_inline_streams_are_identical(port_graph):
    model = DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.0, device="cpu")
    tr = SampledTrainer(model, port_graph,
                        TrainConfig(**_cfg_kw(2), num_samplers=3),
                        device="cpu")
    ids = np.random.default_rng(0).permutation(tr.train_ids)
    batches = [(ids[i * BATCH:(i + 1) * BATCH], 100 + i)
               for i in range(5)]
    inline = list(tr.sample_pipeline(batches, depth=0))
    piped = list(tr.sample_pipeline(batches, depth=2))
    assert len(inline) == len(piped) == 5
    for a, b in zip(inline, piped):
        assert np.array_equal(a.input_nodes, b.input_nodes)
        assert np.array_equal(a.seeds, b.seeds)
        for ba, bb in zip(a.blocks, b.blocks):
            assert ba.num_src == bb.num_src
            assert np.array_equal(ba.nbr, bb.nbr)
            assert np.array_equal(ba.mask, bb.mask)


def test_seeded_dropout_run_is_reproducible(port_graph):
    """With dropout on, two runs from one seed give the same losses, and
    a different seed gives others."""
    def run(seed):
        model = DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.5, device="cpu",
                         generator=torch.Generator().manual_seed(2))
        kw = dict(_cfg_kw(0), dropout=0.5, seed=seed, num_epochs=1,
                  eval_every=0)
        return SampledTrainer(model, port_graph, TrainConfig(**kw),
                              device="cpu").train()["history"][0]["losses"]

    assert run(3) == run(3)
    assert run(3) != run(4)


@pytest.mark.parametrize("field,value", [("sampler", "device"),
                                         ("steps_per_call", 2),
                                         ("zero_stage", 3)])
def test_unported_knobs_raise(port_graph, field, value):
    """The knobs the port lacked: ``sampler="device"``,
    ``steps_per_call`` and ``zero_stage`` are ported, so they are
    accepted and train (``SampledTrainer`` ignores ``zero_stage``, as
    the JAX trainer does; an invalid stage is the registry's
    ``ValueError``)."""
    if field == "zero_stage":
        with pytest.raises(ValueError):
            TrainConfig(zero_stage=2)
    model = DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.0, device="cpu")
    cfg = TrainConfig(**dict(_cfg_kw(0), num_epochs=1, eval_every=0,
                             **{field: value}))
    assert getattr(cfg, field) == value
    out = SampledTrainer(model, port_graph, cfg, device="cpu").train()
    losses = out["history"][0]["losses"]
    assert out["step"] == len(losses) > 0 and np.isfinite(losses).all()


@pytest.mark.parametrize("field", ["pipeline_mode", "pipeline_depth",
                                   "donate", "gather_depth"])
def test_jax_only_fields_are_not_fields(field):
    """The fields the port once lacked are fields now: the JAX default
    is the port's, and a value the knob registry refuses raises
    ``ValueError``."""
    want = JaxTrainConfig().__dict__[field]
    assert getattr(TrainConfig(), field) == want
    assert getattr(TrainConfig(**{field: want}), field) == want
    bad = {"pipeline_mode": "eager", "pipeline_depth": 0,
           "donate": "yes", "gather_depth": 0}[field]
    with pytest.raises(ValueError):
        TrainConfig(**{field: bad})


def test_trainer_checks_model_device_and_dropout(port_graph):
    """The trainer trains at ``cfg.dropout`` whatever the model was built
    with, refuses a rate outside [0, 1) and a model on another device."""
    cfg = TrainConfig(**_cfg_kw(0))
    model = DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.5, device="cpu")
    SampledTrainer(model, port_graph, cfg, device="cpu")
    assert model.dropout == cfg.dropout == 0.0
    with pytest.raises(ValueError, match="dropout"):
        TrainConfig(**dict(_cfg_kw(0), dropout=1.0))
    with pytest.raises(ValueError, match="parameters are on"):
        SampledTrainer(DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.0,
                                device="cpu"), port_graph, cfg,
                       device="meta")


@pytest.mark.cuda
def test_trainer_steps_on_card_launch_the_kernels(port_graph):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from dgl_operator_tpu_torch.ops import fanout, gather, scatter
    model = DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.5, device="cuda")
    tr = SampledTrainer(model, port_graph,
                        TrainConfig(**dict(_cfg_kw(2), dropout=0.5,
                                           num_epochs=1)))
    counts = (fanout.fanout_agg, gather.gather_rows,
              scatter.scatter_add_rows)
    before = [c.launches for c in counts]
    out = tr.train()
    steps = out["step"]
    after = [c.launches - b for c, b in zip(counts, before)]
    # the warm-up forward adds one gather and two aggregations
    assert after == [2 * steps + 2, steps + 1, steps]
    assert all(np.isfinite(out["history"][0]["losses"]))
