"""The port's link prediction against the JAX package's: the
latent-geometry graph and the edge split bit for bit, both predictors,
``LinkPredModel`` with both, the masked BCE loss and the AUC (values
and gradients), and ``examples/link_predict.py`` against the JAX
example's own loop from the same carried weights.

Inputs are drawn with numpy from fixed seeds; models agree within 1e-4.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph.graph import Graph as JaxGraph
from dgl_operator_tpu.models import link_predict as jax_lp
from dgl_operator_tpu.nn.predictors import DotPredictor as JaxDot
from dgl_operator_tpu.nn.predictors import MLPPredictor as JaxMLP
from dgl_operator_tpu_torch import models
from dgl_operator_tpu_torch.examples import link_predict
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.graph import Graph
from dgl_operator_tpu_torch.nn.predictors import DotPredictor, MLPPredictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
N, HID = 30, 6


def _assert_trees_close(got, want, tol, where=""):
    assert set(got) == set(want), (where, set(got), set(want))
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_trees_close(got[k], v, tol, f"{where}/{k}")
        else:
            np.testing.assert_allclose(got[k], np.asarray(v),
                                       err_msg=f"{where}/{k}", **tol)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))
        .astype(np.float32), params)


def _pair_graphs(seed, pad):
    """A random edge set over ``N`` nodes, padded by ``pad`` edges, as
    the JAX and the port device graphs."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, 50).astype(np.int32)
    dst = rng.integers(0, N, 50).astype(np.int32)
    return (JaxGraph(src, dst, N).to_device(pad_to=50 + pad),
            Graph(src, dst, N).to_device("cpu", pad_to=50 + pad))


@pytest.mark.parametrize("kw", [dict(seed=0),
                                dict(num_nodes=200, num_edges=400, seed=3),
                                dict(num_nodes=5, num_edges=40, seed=1)])
def test_link_pred_graph_is_bit_equal(kw):
    want = jax_datasets.link_pred_graph(**kw).graph
    got = datasets.link_pred_graph(**kw).graph
    assert got.num_nodes == want.num_nodes
    np.testing.assert_array_equal(got.src, want.src)
    np.testing.assert_array_equal(got.dst, want.dst)
    assert got.ndata.keys() == want.ndata.keys()
    for k in want.ndata:
        np.testing.assert_array_equal(got.ndata[k], want.ndata[k], k)


@pytest.mark.parametrize("seed", [0, 5])
def test_split_edges_is_bit_equal(seed):
    g = datasets.link_pred_graph(num_nodes=200, num_edges=400,
                                 seed=2).graph
    jg = jax_datasets.link_pred_graph(num_nodes=200, num_edges=400,
                                      seed=2).graph
    got = models.split_edges(g, test_frac=0.1, seed=seed)
    want = jax_lp.split_edges(jg, test_frac=0.1, seed=seed)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].num_nodes == want[k].num_nodes
        np.testing.assert_array_equal(got[k].src, want[k].src, k)
        np.testing.assert_array_equal(got[k].dst, want[k].dst, k)
    np.testing.assert_array_equal(got["train_g"].edata["orig_eid"],
                                  want["train_g"].edata["orig_eid"])
    pos = set(zip(g.src.tolist(), g.dst.tolist()))
    neg = got["train_neg"]
    assert not pos & set(zip(neg.src.tolist(), neg.dst.tolist()))


@pytest.mark.parametrize("predictor", ["dot", "mlp"])
def test_predictors_match_flax(predictor):
    """Scores on a padded edge set (padded edges read the last node's
    row, as JAX's clamped gather) and the gradients of ``sum(s * r)``
    in the parameters and in ``h``."""
    jdg, dg = _pair_graphs(1, 3)
    rng = np.random.default_rng(2)
    h = rng.normal(size=(N, HID)).astype(np.float32)
    r = rng.normal(size=dg.num_edges).astype(np.float32)
    jmod = JaxDot() if predictor == "dot" else JaxMLP(hidden=HID)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jdg,
                                  jnp.asarray(h)), 4)

    def loss(p, x):
        s = jmod.apply(p, jdg, x)
        return (s * r).sum(), s

    (_, want), (gp, gh) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        params, jnp.asarray(h))
    port = DotPredictor() if predictor == "dot" else \
        MLPPredictor(HID, HID, device="cpu")
    if predictor == "mlp":
        port.load_state_dict(models.flax_layout.state_dict_from_flax(
            params, "Dense"))
    x = torch.from_numpy(h).requires_grad_(True)
    s = port(dg, x)
    (s * torch.from_numpy(r)).sum().backward()
    assert s.shape == (dg.num_edges,)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gh), **TOL)
    if predictor == "mlp":
        got = models.flax_layout.state_dict_to_flax(
            {k: p.grad for k, p in port.named_parameters()}, "Dense")
        _assert_trees_close(got["params"], jax.device_get(gp)["params"],
                            TOL)


@pytest.mark.parametrize("predictor", ["dot", "mlp"])
def test_link_pred_model_matches_flax(predictor):
    """``LinkPredModel`` on padded positive and negative graphs: its
    scores, and the masked BCE loss's gradients in every parameter, the
    nested tree carried both ways."""
    jg, g = _pair_graphs(3, 0)
    jpos, pos = _pair_graphs(4, 5)
    jneg, neg = _pair_graphs(5, 2)
    x = np.random.default_rng(6).normal(size=(N, 7)).astype(np.float32)
    jmodel = jax_lp.LinkPredModel(hidden_feats=HID, predictor=predictor)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(1), jg,
                                    jnp.asarray(x), jpos, jneg), 7)

    def loss(p):
        ps, ns = jmodel.apply(p, jg, jnp.asarray(x), jpos, jneg)
        return jax_lp.bce_link_loss(ps, ns, jpos.edge_mask,
                                    jneg.edge_mask), (ps, ns)

    (want_l, (want_p, want_n)), gp = jax.value_and_grad(
        loss, has_aux=True)(params)
    port = models.LinkPredModel(7, HID, predictor, device="cpu")
    port.load_state_dict(models.state_dict_from_flax(params))
    _assert_trees_close(models.flax_params(port)["params"],
                        params["params"], dict(rtol=0, atol=0))
    ps, ns = port(g, torch.from_numpy(x), pos, neg)
    got_l = models.bce_link_loss(ps, ns, pos.edge_mask, neg.edge_mask)
    got_l.backward()
    np.testing.assert_allclose(ps.detach().numpy(), np.asarray(want_p),
                               **TOL)
    np.testing.assert_allclose(ns.detach().numpy(), np.asarray(want_n),
                               **TOL)
    np.testing.assert_allclose(float(got_l.detach()), float(want_l),
                               **TOL)
    got = models.flax_layout.state_dict_to_flax(
        {k: p.grad for k, p in port.named_parameters()}, port.flax_prefix)
    _assert_trees_close(got["params"], jax.device_get(gp)["params"], TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_bce_link_loss_matches_jax(masked):
    rng = np.random.default_rng(8)
    pos = (3 * rng.normal(size=12)).astype(np.float32)
    neg = (3 * rng.normal(size=9)).astype(np.float32)
    pm = (rng.random(12) > 0.3).astype(np.float32) if masked else None
    nm = (rng.random(9) > 0.3).astype(np.float32) if masked else None
    want, (gp, gn) = jax.value_and_grad(
        lambda a, b: jax_lp.bce_link_loss(a, b, pm, nm), argnums=(0, 1))(
        jnp.asarray(pos), jnp.asarray(neg))
    tp = torch.from_numpy(pos).requires_grad_(True)
    tn = torch.from_numpy(neg).requires_grad_(True)
    got = models.bce_link_loss(
        tp, tn, None if pm is None else torch.from_numpy(pm),
        None if nm is None else torch.from_numpy(nm))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(gn), rtol=1e-5,
                               atol=1e-7)


def test_auc_score_matches_jax():
    rng = np.random.default_rng(9)
    pos = rng.integers(0, 6, 40).astype(np.float32)      # many ties
    neg = rng.integers(0, 5, 50).astype(np.float32)
    assert models.auc_score(torch.from_numpy(pos), torch.from_numpy(neg)) \
        == jax_lp.auc_score(pos, neg)
    assert models.auc_score(np.ones(3), np.zeros(4)) == 1.0


def _load_jax_example():
    path = os.path.join(REPO, "examples", "link_predict", "train.py")
    spec = importlib.util.spec_from_file_location("jax_example_link_predict",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("predictor", ["dot", "mlp"])
def test_link_predict_example_matches_jax(predictor, capsys):
    """21 epochs of ``examples/link_predict.py`` against the JAX
    example's loop from the weights it starts from: the losses it prints
    (epochs 0 and 20) and the test AUC."""
    argv = ["--num_epochs", "21", "--predictor", predictor,
            "--dataset_scale", "0.05"]
    want = _load_jax_example().main(argv)
    printed = [float(ln.rsplit(" ", 1)[1]) for ln in
               capsys.readouterr().out.splitlines()
               if ln.startswith("In epoch")]
    ds = jax_datasets.link_pred_graph(num_nodes=200, num_edges=400, seed=0)
    split = jax_lp.split_edges(ds.graph, test_frac=0.1, seed=0)
    init = jax.device_get(jax_lp.LinkPredModel(
        hidden_feats=16, predictor=predictor).init(
        jax.random.PRNGKey(0), split["train_g"].to_device(),
        jnp.asarray(ds.graph.ndata["feat"]), split["train_pos"].to_device(),
        split["train_neg"].to_device()))
    got = link_predict.main(argv + ["--device", "cpu"], init_params=init)
    assert len(printed) == 2 and len(got["history"]) == 21
    np.testing.assert_allclose([got["history"][0], got["history"][20]],
                               printed, atol=6e-5)
    assert abs(got["auc"] - want["auc"]) <= 1e-3
    assert f"AUC {got['auc']:.4f}" in capsys.readouterr().out
