"""GIN graph classification in the port against the JAX package.

``gin_dataset`` and ``batch_graphs`` equal to the JAX package's (graphs,
features, labels; the packed ``src``, ``dst``, ``edge_mask``, features,
node-to-graph ids and mask); ``GINConv`` and ``GIN`` forward and
gradients within 1e-4 of the largest entry from carried weights (``eps``
the 0-d flax leaf, perturbed off 0); the flax layout both ways; and
``examples/graph_classification.py`` against the JAX example's loop on
80 graphs in batches of 16: every step's loss, the printed epoch mean
and the test accuracy.
"""

import importlib.util
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.models import gin as jax_gin
from dgl_operator_tpu.nn import GINConv as JaxGINConv
from dgl_operator_tpu_torch import models
from dgl_operator_tpu_torch.examples import graph_classification
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models import gin
from dgl_operator_tpu_torch.nn.conv import GINConv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--num_epochs", "2", "--num_graphs", "80", "--batch_size", "16",
        "--hidden", "16"]


def _close(got, want, rel=1e-4, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.normal(size=np.shape(x)))
        .astype(np.float32), params)


@pytest.mark.parametrize("kw", [{}, dict(num_graphs=40, seed=3)])
def test_gin_dataset_is_identical(kw):
    a, b = jax_datasets.gin_dataset(**kw), datasets.gin_dataset(**kw)
    assert (a.num_classes, a.dim_nfeats, a.name) == \
        (b.num_classes, b.dim_nfeats, b.name)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert len(a.graphs) == len(b.graphs) == kw.get("num_graphs", 300)
    for ga, gb in zip(a.graphs, b.graphs):
        assert ga.num_nodes == gb.num_nodes
        np.testing.assert_array_equal(ga.src, gb.src)
        np.testing.assert_array_equal(ga.dst, gb.dst)
        np.testing.assert_array_equal(ga.ndata["attr"], gb.ndata["attr"])


def _batch(idx, ds_j, ds_p, pad_nodes, pad_edges):
    j = jax_gin.batch_graphs([ds_j.graphs[i] for i in idx], "attr",
                             pad_nodes, pad_edges)
    p = gin.batch_graphs([ds_p.graphs[i] for i in idx], "attr", pad_nodes,
                         pad_edges, "cpu")
    return j, p


@pytest.fixture(scope="module")
def sets():
    return jax_datasets.gin_dataset(num_graphs=40), \
        datasets.gin_dataset(num_graphs=40)


def test_batch_graphs_match_jax(sets):
    ds_j, ds_p = sets
    idx = np.array([3, 0, 17, 8, 5])
    pad_nodes = 60 * len(idx)
    pad_edges = max(g.num_edges for g in ds_p.graphs) * len(idx)
    (jdg, jfeat, jgid, jmask), p = _batch(idx, ds_j, ds_p, pad_nodes,
                                          pad_edges)
    dg = p.graph
    assert dg.num_nodes == jdg.num_nodes == pad_nodes
    np.testing.assert_array_equal(dg.src.numpy(), jdg.src)
    np.testing.assert_array_equal(dg.dst.numpy(), jdg.dst)
    np.testing.assert_array_equal(dg.edge_mask.numpy(), jdg.edge_mask)
    np.testing.assert_array_equal(p.feat.numpy(), jfeat)
    np.testing.assert_array_equal(p.graph_id.numpy(), jgid)
    np.testing.assert_array_equal(p.mask.numpy(), jmask)
    # the plans agree with the arrays: dst into pad_nodes + 1 segments,
    # the readout into len(idx) + 1
    off = dg.dst_plan.offsets.numpy()
    np.testing.assert_array_equal(
        off[1:] - off[:-1], np.bincount(jdg.dst, minlength=pad_nodes + 1))
    roff = p.readout_plan.offsets.numpy()
    np.testing.assert_array_equal(
        roff[1:] - roff[:-1], np.bincount(jgid, minlength=len(idx) + 1))
    with pytest.raises(ValueError, match="caps are"):
        gin.batch_graphs([ds_p.graphs[i] for i in idx], "attr", 10,
                         pad_edges, "cpu")


def test_gin_conv_matches_flax(sets):
    ds_j, ds_p = sets
    idx = np.arange(6)
    (jdg, jfeat, _, _), p = _batch(idx, ds_j, ds_p, 60 * 6, 700 * 6)
    rng = np.random.default_rng(2)
    h = rng.normal(size=jfeat.shape).astype(np.float32) * jfeat[:, 1:]
    w = rng.normal(size=(h.shape[0], 5)).astype(np.float32)
    layer = JaxGINConv(mlp=fnn.Dense(5))
    params = _perturbed(layer.init(jax.random.PRNGKey(0), jdg,
                                   jnp.asarray(h))["params"], 1)
    assert np.shape(params["eps"]) == () and params["eps"] != 0

    def loss(prm, x):
        return (layer.apply({"params": prm}, jdg, x) * w).sum()

    want = layer.apply({"params": params}, jdg, jnp.asarray(h))
    gp, gh = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(h))

    port = GINConv(torch.nn.Linear(2, 5))
    port.load_state_dict({
        "eps": torch.tensor(float(params["eps"])),
        "mlp.weight": torch.from_numpy(np.ascontiguousarray(
            params["mlp"]["kernel"].T)),
        "mlp.bias": torch.from_numpy(params["mlp"]["bias"])})
    x = torch.from_numpy(h).requires_grad_(True)
    got = port(p.graph, x)
    _close(got.detach(), want, what="forward")
    (got * torch.from_numpy(w)).sum().backward()
    _close(x.grad, gh, what="dh")
    _close(port.eps.grad, gp["eps"], what="deps")
    _close(port.mlp.weight.grad.T, gp["mlp"]["kernel"], what="dkernel")
    _close(port.mlp.bias.grad, gp["mlp"]["bias"], what="dbias")


@pytest.mark.parametrize("num_layers", [2, 3])
def test_gin_matches_flax(sets, num_layers):
    ds_j, ds_p = sets
    idx = np.array([1, 4, 9, 2, 30, 11, 7, 0])
    B = len(idx)
    (jdg, jfeat, jgid, jmask), p = _batch(idx, ds_j, ds_p, 60 * B, 700 * B)
    lab = np.asarray(ds_j.labels)[idx]
    model = jax_gin.GIN(hidden_feats=8, num_classes=2,
                        num_layers=num_layers)
    params = _perturbed(jax.device_get(model.init(
        jax.random.PRNGKey(0), jdg, jfeat, jgid, jmask, B)), 3)
    tree = params["params"]
    assert set(tree) == {f"Dense_{j}" for j in range(2 * num_layers + 1)} \
        | {f"GINConv_{i}" for i in range(num_layers)}
    assert all(set(tree[f"GINConv_{i}"]) == {"eps"}
               for i in range(num_layers))

    def loss(prm):
        logits = model.apply(prm, jdg, jfeat, jgid, jmask, B)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, lab).mean()

    want = model.apply(params, jdg, jfeat, jgid, jmask, B)
    want_loss, grads = jax.value_and_grad(loss)(params)

    port = gin.GIN(2, 8, 2, num_layers=num_layers, device="cpu")
    port.load_state_dict(models.state_dict_from_flax(params))
    got = port(p.graph, p.feat, p.graph_id, p.mask, B, p.readout_plan)
    _close(got.detach(), want, what="logits")
    ll = F.cross_entropy(got, torch.from_numpy(lab.astype(np.int64)))
    np.testing.assert_allclose(float(ll.detach()), float(want_loss),
                               rtol=1e-5)
    ll.backward()
    got_grads = gin.state_dict_to_flax(
        {k: v.grad for k, v in port.named_parameters()})["params"]
    for name, node in grads["params"].items():
        for leaf, g in node.items():
            _close(got_grads[name][leaf], g, what=f"{name}/{leaf}")
    back = models.flax_params(port)["params"]
    for name, node in tree.items():
        for leaf, v in node.items():
            np.testing.assert_array_equal(back[name][leaf], v)
            assert np.shape(back[name][leaf]) == np.shape(v)


def _load_jax_example():
    path = os.path.join(REPO, "examples", "graph_classification",
                        "train.py")
    spec = importlib.util.spec_from_file_location("jax_example_gin", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_reference(init, epochs, B, lr):
    """The JAX example's training loop from ``init``: every step's
    loss."""
    ds = jax_datasets.gin_dataset(num_graphs=80)
    graphs, labels = ds.graphs, np.asarray(ds.labels)
    pad_nodes = max(g.num_nodes for g in graphs) * B
    pad_edges = max(g.num_edges for g in graphs) * B
    model = jax_gin.GIN(hidden_feats=16, num_classes=2)
    opt = optax.adam(lr)
    params, state = init, opt.init(init)

    @jax.jit
    def step(prm, s, dg, feat, gid, mask, lab):
        def loss_fn(q):
            logits = model.apply(q, dg, feat, gid, mask, B)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, lab).mean()
        loss, grads = jax.value_and_grad(loss_fn)(prm)
        updates, s = opt.update(grads, s, prm)
        return optax.apply_updates(prm, updates), s, loss

    rng = np.random.default_rng(0)
    n_train = int(0.8 * len(graphs))
    out = []
    for _ in range(epochs):
        order = rng.permutation(n_train)
        losses = []
        for b in range(0, n_train - B + 1, B):
            idx = order[b:b + B]
            dg, feat, gid, mask = jax_gin.batch_graphs(
                [graphs[i] for i in idx], "attr", pad_nodes, pad_edges)
            params, state, loss = step(params, state, dg, feat, gid, mask,
                                       labels[idx])
            losses.append(float(loss))
        out.append(losses)
    return out


def test_graph_classification_example_matches_jax(capsys):
    """Two epochs of ``examples/graph_classification.py`` from the JAX
    example's starting weights: each of the 8 steps' losses against the
    JAX loop's within 1e-4 relative, the printed epoch-0 mean, and the
    test accuracy of the JAX example itself."""
    want = _load_jax_example().main(ARGV)
    printed = [float(ln.rsplit(" ", 1)[1]) for ln in
               capsys.readouterr().out.splitlines()
               if ln.startswith("epoch")]
    ds = jax_datasets.gin_dataset(num_graphs=80)
    B = 16
    pad_nodes = max(g.num_nodes for g in ds.graphs) * B
    pad_edges = max(g.num_edges for g in ds.graphs) * B
    dg0, f0, g0, m0 = jax_gin.batch_graphs(ds.graphs[:B], "attr",
                                           pad_nodes, pad_edges)
    init = jax.device_get(jax_gin.GIN(hidden_feats=16, num_classes=2).init(
        jax.random.PRNGKey(0), dg0, jnp.asarray(f0), jnp.asarray(g0),
        jnp.asarray(m0), B))
    ref = _jax_reference(init, 2, B, 0.01)
    got = graph_classification.main(ARGV + ["--device", "cpu"],
                                     init_params=init)
    assert [len(h) for h in got["history"]] == [len(h) for h in ref] \
        == [4, 4]
    np.testing.assert_allclose(np.ravel(got["history"]), np.ravel(ref),
                               rtol=1e-4)
    # printed to 4 decimals; the losses here are O(100)
    np.testing.assert_allclose(np.mean(got["history"][0]), printed[0],
                               rtol=1e-5, atol=6e-5)
    assert got["test_acc"] == want["test_acc"]
    assert f"Test accuracy: {got['test_acc']:.4f}" in \
        capsys.readouterr().out
