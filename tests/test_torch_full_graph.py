"""The port's full-graph loop vs the JAX package's: ``train_full_graph``
with ``GCN`` and ``GAT`` on a scaled synthetic Cora, the device view of
a graph, the synthetic Cora itself, and the node-classification entry
point's ``--model`` arms.

Both packages build the graph from one numpy seed; the port starts from
the flax params that the JAX loop initialises (``model.init`` with
``PRNGKey(cfg.seed)``), so with the same Adam the per-epoch losses must
agree within 1e-4 and the returned params within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.models.gat import GAT as JaxGAT
from dgl_operator_tpu.models.gcn import GCN as JaxGCN
from dgl_operator_tpu.runtime import TrainConfig as JaxTrainConfig
from dgl_operator_tpu.runtime import train_full_graph as jax_train_full_graph
from dgl_operator_tpu_torch.examples import node_classification
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models import GAT, GCN
from dgl_operator_tpu_torch.runtime.loop import TrainConfig, train_full_graph

# the node-classification example's --dataset_scale 0.25 graph
SCALED = dict(num_nodes=677, num_edges=2639, feat_dim=64, num_classes=7,
              seed=0)
EPOCHS = 12
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
MODELS = {"gcn": (lambda: JaxGCN(hidden_feats=16, num_classes=7),
                  lambda: GCN(64, 16, 7, device="cpu")),
          "gat": (lambda: JaxGAT(hidden_feats=8, num_classes=7,
                                 num_heads=4),
                  lambda: GAT(64, 8, 7, num_heads=4, device="cpu"))}


@pytest.fixture(scope="module")
def jax_runs():
    """Per model: the flax params the JAX loop starts from and its run."""
    g = jax_datasets.synthetic_node_clf(**SCALED).graph
    cfg = JaxTrainConfig(num_epochs=EPOCHS, lr=0.01, eval_every=4, seed=3)
    out = {}
    for name, (make, _) in MODELS.items():
        model = make()
        init = jax.device_get(model.init(
            jax.random.PRNGKey(cfg.seed), g.to_device(),
            jnp.asarray(g.ndata["feat"])))
        out[name] = (init, jax_train_full_graph(model, g, cfg))
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_train_full_graph_matches_jax(jax_runs, name):
    init, want = jax_runs[name]
    g = datasets.synthetic_node_clf(**SCALED).graph
    cfg = TrainConfig(num_epochs=EPOCHS, lr=0.01, eval_every=4, seed=3)
    got = train_full_graph(MODELS[name][1](), g, cfg, init_params=init,
                           device="cpu")
    assert [r["epoch"] for r in got["history"]] == list(range(EPOCHS))
    np.testing.assert_allclose([r["loss"] for r in got["history"]],
                               [r["loss"] for r in want["history"]],
                               **LOSS_TOL)
    assert got["history"][-1]["loss"] < got["history"][0]["loss"]
    n_val = int(g.ndata["val_mask"].sum())
    for g_rec, w_rec in zip(got["history"], want["history"]):
        assert g_rec.keys() == w_rec.keys()
        if "val_acc" in w_rec:
            assert abs(g_rec["val_acc"] - w_rec["val_acc"]) <= \
                1 / n_val + 1e-6
    n_test = int(g.ndata["test_mask"].sum())
    assert abs(got["test_acc"] - want["test_acc"]) <= 1 / n_test + 1e-6
    ref = jax.device_get(want["params"])["params"]
    assert got["params"]["params"].keys() == ref.keys()
    for layer, subs in ref.items():
        for sub, leaf in subs.items():
            pairs = (leaf.items() if isinstance(leaf, dict)
                     else [(None, leaf)])
            for key, w in pairs:
                v = got["params"]["params"][layer][sub]
                v = v[key] if key else v
                np.testing.assert_allclose(v, np.asarray(w), rtol=1e-3,
                                           atol=1e-3,
                                           err_msg=f"{layer}/{sub}/{key}")


@pytest.mark.parametrize("pad", [None, 40])
@pytest.mark.parametrize("sort", [True, False])
def test_device_view_matches_jax(sort, pad):
    jg = jax_datasets.synthetic_node_clf(**SCALED).graph
    g = datasets.synthetic_node_clf(**SCALED).graph.add_self_loop()
    assert g.num_edges == jg.num_edges + g.num_nodes
    pad_to = None if pad is None else g.num_edges + pad
    want = jg.add_self_loop().to_device(sort_by_dst=sort, pad_to=pad_to)
    got = g.to_device("cpu", sort_by_dst=sort, pad_to=pad_to)
    assert got.num_nodes == want.num_nodes == g.num_nodes
    assert got.num_edges == want.num_edges
    assert got.sorted_by_dst == want.sorted_by_dst == sort
    for key in ("src", "dst", "edge_mask"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(want, key)), key)
    with pytest.raises(ValueError, match="pad_to"):
        g.to_device("cpu", pad_to=g.num_edges - 1)


def test_cora_matches_jax():
    want = jax_datasets.cora().graph
    got = datasets.cora().graph
    assert (got.num_nodes, got.num_edges) == (2708, want.num_edges)
    np.testing.assert_array_equal(got.src, want.src)
    np.testing.assert_array_equal(got.dst, want.dst)
    for key in ("feat", "label", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(got.ndata[key], want.ndata[key], key)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_node_classification_entry_point(model, capsys):
    out = node_classification.main(
        ["--model", model, "--num_epochs", "6", "--dataset_scale", "0.25",
         "--num_heads", "2", "--device", "cpu"])
    losses = [r["loss"] for r in out["history"]]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert 0 <= out["test_acc"] <= 1
    prefix = "GATConv_0" if model == "gat" else "GraphConv_0"
    assert prefix in out["params"]["params"]
    assert "Final test accuracy" in capsys.readouterr().out


def test_train_full_graph_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = datasets.synthetic_node_clf(**SCALED).graph
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_full_graph(GCN(64, 16, 7, device="cpu"), g, TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        node_classification.main(["--dataset_scale", "0.25"])
