"""RGCN link prediction in the port against the JAX package.

``RelGraphConv`` with bases (the reassociated ``h @ basis`` form, no
``[E, I, O]`` table) and without (the table form in runs of edges, each
over its own plan) against the flax layer from carried weights, forward
and gradients within 1e-4 of the largest entry; ``RGCNLinkPredict``'s
scores; the flax layout both ways; and ``examples/link_predict_rgcn.py``
against the JAX example on a tiny synthetic FB15k (224 entities, 20
relations, 7,247 train triples, hidden 8, 2 bases): the same negatives
drawn in the same order, three Adam epochs' losses and the AUC; and
``chip_smoke.py``'s card-against-CPU RGCN check against a planted fault.
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
from dgl_operator_tpu.models.rgcn import RGCNLinkPredict as JaxRGCN
from dgl_operator_tpu.nn import RelGraphConv as JaxRelGraphConv
from dgl_operator_tpu_torch import models
from dgl_operator_tpu_torch.examples import link_predict_rgcn
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.graph import Graph
from dgl_operator_tpu_torch.models import flax_layout, rgcn
from dgl_operator_tpu_torch.nn import conv
from dgl_operator_tpu_torch.nn.conv import RelGraphConv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, E, R, IN, OUT = 40, 300, 6, 5, 7
SCALE = 0.015            # fb15k at 224 entities, 20 relations


def _close(got, want, rel=1e-4, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _graphs(seed, pad):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    etype = rng.integers(0, R, E).astype(np.int64)
    jg = JaxGraph(src, dst, N).to_device(pad_to=E + pad)
    pg = Graph(src, dst, N).to_device("cpu", pad_to=E + pad)
    # the flax layer takes one type per edge of the padded list
    jet = np.concatenate([jg.permute_edata(etype), np.zeros(pad, np.int64)])
    return jg, jnp.asarray(jet), pg, pg.edge_types(etype, R)


def _layer_state(tree):
    sd = flax_layout.state_dict_from_flax({"rgcn_0": tree}, "rgcn")
    return {k[len("layers.0."):]: v for k, v in sd.items()}


@pytest.mark.parametrize("pad", [0, 13])
@pytest.mark.parametrize("num_bases", [2, 0])
def test_rel_graph_conv_matches_flax(num_bases, pad, monkeypatch):
    if num_bases == 0:
        # runs of 50 edges: several chunks, each over its own plan
        monkeypatch.setattr(conv, "REL_CHUNK_ELEMS", 50 * IN * OUT)
    jg, jet, pg, et = _graphs(3, pad)
    rng = np.random.default_rng(4)
    h = rng.normal(size=(N, IN)).astype(np.float32)
    w = rng.normal(size=(N, OUT)).astype(np.float32)
    layer = JaxRelGraphConv(OUT, R, num_bases=num_bases)
    params = jax.device_get(layer.init(jax.random.PRNGKey(1), jg,
                                       jnp.asarray(h), jet))["params"]
    want = layer.apply({"params": params}, jg, jnp.asarray(h), jet)

    def loss(p, x):
        return (layer.apply({"params": p}, jg, x, jet) * w).sum()

    gp, gh = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(h))

    port = RelGraphConv(IN, OUT, R, num_bases=num_bases, device="cpu")
    port.load_state_dict(_layer_state(params))
    x = torch.from_numpy(h).requires_grad_(True)
    got = port(pg, x, et)
    _close(got.detach(), want, what="forward")
    (got * torch.from_numpy(w)).sum().backward()
    _close(x.grad, gh, what="dh")
    grads = _layer_state(jax.tree_util.tree_map(np.asarray, gp))
    for name, p in port.named_parameters():
        _close(p.grad, grads[name], what=f"d{name}")
    if num_bases == 0:
        assert len(et.chunks(50)) == -(-(E + pad) // 50)


def test_rel_graph_conv_init_follows_flax_fans():
    """The basis' glorot bound takes its fans times B (flax's receptive
    field); the coefficients' are ``[R, B]``'s."""
    layer = RelGraphConv(32, 32, 100, num_bases=8, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    top = {k: float(v.detach().abs().max())
           for k, v in layer.named_parameters()}
    basis_bound = np.sqrt(6.0 / ((32 + 32) * 8))
    assert 0.9 * basis_bound < top["basis"] <= basis_bound
    coef_bound = np.sqrt(6.0 / (100 + 8))
    assert 0.9 * coef_bound < top["coef"] <= coef_bound
    assert layer.loop.bias is None


def _tiny_kg():
    return (jax_datasets.fb15k(seed=0, scale=SCALE),
            datasets.fb15k(seed=0, scale=SCALE))


def _jax_model_and_params(ds, hidden, bases, seed):
    h_tr, r_tr, t_tr = (np.asarray(a) for a in ds.train)
    dg = JaxGraph(h_tr.astype(np.int32), t_tr.astype(np.int32),
                  ds.n_entities).to_device()
    etype = jnp.asarray(dg.permute_edata(r_tr).astype(np.int32))
    model = JaxRGCN(n_entities=ds.n_entities, hidden_feats=hidden,
                    num_rels=ds.n_relations, num_bases=bases)
    pos = tuple(jnp.asarray(a) for a in (h_tr, r_tr, t_tr))
    params = jax.device_get(model.init(jax.random.PRNGKey(seed), dg, etype,
                                       pos, pos))
    return model, params, dg, etype


def test_rgcn_link_predict_scores_match_flax():
    jds, pds = _tiny_kg()
    assert (jds.n_entities, jds.n_relations, len(jds.train[0])) == \
        (pds.n_entities, pds.n_relations, len(pds.train[0])) == \
        (224, 20, 7247)
    model, params, jdg, jet = _jax_model_and_params(jds, 8, 2, 0)
    tree = params["params"]
    assert set(tree) == {"embed", "rgcn_0", "rgcn_1", "w_rel"}
    assert tree["rgcn_0"]["basis"].shape == (2, 8, 8)
    assert set(tree["rgcn_0"]["loop"]) == {"kernel"}
    h_te, r_te, t_te = (np.asarray(a) for a in jds.test)
    neg_t = np.random.default_rng(5).integers(0, jds.n_entities,
                                              len(t_te))
    want = model.apply(params, jdg, jet,
                       tuple(jnp.asarray(a) for a in (h_te, r_te, t_te)),
                       tuple(jnp.asarray(a) for a in (h_te, r_te, neg_t)))

    h_tr, r_tr, t_tr = (np.asarray(a) for a in pds.train)
    pdg = Graph(h_tr.astype(np.int32), t_tr.astype(np.int32),
                pds.n_entities).to_device("cpu")
    et = pdg.edge_types(r_tr, pds.n_relations)
    port = rgcn.RGCNLinkPredict(pds.n_entities, 8, pds.n_relations,
                                num_bases=2, device="cpu")
    port.load_state_dict(models.state_dict_from_flax(params))
    pos = rgcn.Triples.build(h_te, r_te, t_te, pds.n_entities,
                             pds.n_relations, "cpu")
    with torch.no_grad():
        got = port(pdg, et, pos, pos.with_tails(neg_t))
    for g, w in zip(got, want):
        _close(g, w, what="scores")
    # the layout round-trips, 3-D basis untransposed, loop transposed
    back = models.flax_params(port)["params"]
    for k in ("embed", "w_rel"):
        np.testing.assert_array_equal(back[k], tree[k])
    np.testing.assert_array_equal(back["rgcn_1"]["basis"],
                                  tree["rgcn_1"]["basis"])
    np.testing.assert_array_equal(back["rgcn_1"]["loop"]["kernel"],
                                  tree["rgcn_1"]["loop"]["kernel"])
    assert port.layers[0].loop.weight.shape == (8, 8)


def test_triples_plans_share_heads_and_relations():
    h, r, t = np.array([0, 3, 3, 1]), np.array([2, 0, 2, 2]), \
        np.array([1, 1, 0, 2])
    pos = rgcn.Triples.build(h, r, t, 4, 3, "cpu")
    neg = pos.with_tails(np.array([3, 3, 3, 0]))
    assert neg.head_plan is pos.head_plan and neg.rel_plan is pos.rel_plan
    assert neg.tail_plan is not pos.tail_plan
    np.testing.assert_array_equal(neg.tail_plan.offsets.numpy(),
                                  [0, 1, 1, 1, 4])
    bare = rgcn.Triples.build(h, r, t, 4, 3, "cpu", plans=False)
    assert bare.with_tails(t).tail_plan is None


class _Recorder:
    """A numpy Generator that records what ``integers`` draws."""

    def __init__(self, rng, log):
        self._rng, self._log = rng, log

    def integers(self, *a, **kw):
        out = self._rng.integers(*a, **kw)
        self._log.append(np.copy(out))
        return out

    def __getattr__(self, name):
        return getattr(self._rng, name)


def _load_jax_example():
    path = os.path.join(REPO, "examples", "link_predict_rgcn", "train.py")
    spec = importlib.util.spec_from_file_location("jax_example_rgcn", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_link_predict_rgcn_example_matches_jax(monkeypatch, capsys):
    """Three epochs of ``examples/link_predict_rgcn.py`` from the JAX
    example's starting weights: the same integer draws (the dataset's
    and every epoch's negatives, then the test negatives), the losses
    (epoch 0 as printed, the last exactly returned) and the AUC."""
    argv = ["--num_epochs", "3", "--dataset_scale", str(SCALE),
            "--hidden", "8", "--num_bases", "2"]
    jds = jax_datasets.fb15k(seed=0, scale=SCALE)
    _, init, _, _ = _jax_model_and_params(jds, 8, 2, 0)
    real = np.random.default_rng
    logs = {"jax": [], "port": []}
    side = {"now": "jax"}
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *a, **kw: _Recorder(real(*a, **kw),
                                                   logs[side["now"]]))
    want = _load_jax_example().main(argv)
    printed = [float(ln.rsplit(" ", 1)[1]) for ln in
               capsys.readouterr().out.splitlines()
               if ln.startswith("In epoch")]
    side["now"] = "port"
    got = link_predict_rgcn.main(argv + ["--device", "cpu"],
                                 init_params=init)
    n_tr, n_te = len(jds.train[0]), len(jds.test[0])
    negs = [a for a in logs["port"] if a.shape in ((n_tr,), (n_te,))]
    assert [a.shape for a in negs[-4:]] == [(n_tr,)] * 3 + [(n_te,)]
    assert len(logs["jax"]) == len(logs["port"])
    for a, b in zip(logs["jax"], logs["port"]):
        np.testing.assert_array_equal(a, b)
    assert len(got["history"]) == 3 and len(printed) == 1
    np.testing.assert_allclose(got["history"][0], printed[0], atol=6e-5)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert got["loss"] == got["history"][-1]
    assert abs(got["auc"] - want["auc"]) <= 1e-3
    assert set(got) >= {"auc", "loss"}


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rgcn", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rgcn_card_check_catches_shifted_edge_types():
    """``chip_smoke.py``'s synced RGCN check, a float32 side against a
    float64 one, both on the CPU: it passes as they are; with the float32
    side's edge types shifted by one relation (a planted fault of the
    encoder), the losses still agree within 1e-4 relative (all that a
    loss-only check would hold) while the gradients part by more than
    1e-4 of their largest entry in every epoch, and the check fails."""
    smoke = _load_chip_smoke()
    ds = datasets.fb15k(seed=0, scale=SCALE)
    w0 = models.flax_params(rgcn.RGCNLinkPredict(
        ds.n_entities, 8, ds.n_relations, num_bases=2, device="cpu"))
    r = np.asarray(ds.train[1])

    def sides(etype=None):
        side = smoke.RgcnSide(torch, ds, w0, "cpu")
        if etype is not None:
            side.etypes = side.dg.edge_types(etype, ds.n_relations)
        return side, smoke.RgcnSide(torch, ds, w0, "cpu",
                                    dtype=torch.float64)

    _, _, rel, worst, scores, _ = smoke.rgcn_synced_gaps(torch, *sides(),
                                                         ds, 2, 0)
    assert max(rel) <= 1e-5 and max(worst) <= 1e-4 and max(scores) <= 1e-4

    shifted = (r + 1) % ds.n_relations
    tails = [np.random.default_rng(0).integers(0, ds.n_entities, len(r))
             for _ in range(2)]
    fl, cl, gaps, _ = smoke.synced_step_gaps(torch, *sides(shifted), tails,
                                             smoke.rgcn_step)
    assert max(smoke.rel_gaps(fl, cl)) < 1e-4
    assert min(max(g.values()) for g in gaps) > 1e-4
    with pytest.raises(RuntimeError, match="check failed: rgcn"):
        smoke.rgcn_synced_gaps(torch, *sides(shifted), ds, 2, 0)
