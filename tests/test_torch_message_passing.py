"""The port's full-graph message-passing vocabulary against the JAX
package's: the device graph's plans, ``gspmm`` over every message op
and reduce, ``gsddmm`` over every op, ``segment_mean`` /
``segment_min``, ``SAGEConv`` (mean, sum, pool), ``WeightedSAGEConv``,
``GraphSAGE`` and the weight carrier, forward and gradients; then the
two new entry points (``examples/message_passing.py`` and
``examples/graphsage.py``) against the JAX examples' own loops from the
same carried weights.

Inputs are drawn with numpy from fixed seeds and go through both
packages; ops agree within 1e-5, layers and models within 1e-4, loops
within the tolerance their existing counterparts use.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph.blocks import FanoutBlock as JaxFanoutBlock
from dgl_operator_tpu.graph.graph import Graph as JaxGraph
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.models.sage import GraphSAGE as JaxGraphSAGE
from dgl_operator_tpu.nn.conv import SAGEConv as JaxSAGEConv
from dgl_operator_tpu.nn.conv import WeightedSAGEConv as JaxWeightedSAGEConv
from dgl_operator_tpu.ops import sddmm as jax_sddmm
from dgl_operator_tpu.ops import segment as jax_segment
from dgl_operator_tpu.ops import spmm as jax_spmm
from dgl_operator_tpu_torch import models
from dgl_operator_tpu_torch.examples import graphsage, message_passing
from dgl_operator_tpu_torch.graph.graph import Graph
from dgl_operator_tpu_torch.models import flax_layout
from dgl_operator_tpu_torch.nn.conv import SAGEConv, WeightedSAGEConv
from dgl_operator_tpu_torch.ops import sddmm, segment, spmm
from dgl_operator_tpu_torch.ops.scatter import ScatterPlan, scatter_plan
from test_torch_native import use_jax_graphcore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# duplicate edges (1 -> 0 twice), nodes 6 and 8 with no in-edge
SRC = np.array([0, 1, 1, 2, 3, 3, 4, 5, 6, 7, 0, 2, 6, 0], np.int32)
DST = np.array([1, 0, 0, 1, 2, 2, 2, 4, 4, 4, 7, 7, 3, 5], np.int32)
N, PAD = 9, 4
BINARY = ["copy_u", "copy_e", "u_mul_e", "u_add_e", "u_sub_e", "u_div_e",
          "e_sub_u", "e_div_u"]
REDUCES = ["sum", "mean", "max", "min"]
SDDMM = ["dot", "add", "sub", "mul", "div", "copy_u", "copy_v"]


def _graphs(pad=PAD):
    e = len(SRC) + pad
    return (JaxGraph(SRC, DST, N).to_device(pad_to=e),
            Graph(SRC, DST, N).to_device("cpu", pad_to=e))


def _nonzero(rng, shape):
    """Values of magnitude 0.5 to 1.5 with random signs (divisors)."""
    return (rng.uniform(0.5, 1.5, shape)
            * rng.choice([-1, 1], shape)).astype(np.float32)


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


# -- the device graph ---------------------------------------------------

@pytest.mark.parametrize("sort", [True, False])
def test_device_graph_plans_degrees_and_edata(sort):
    """Both plans hold every edge (padded ones on row 0 / the spare
    segment); the degrees count the valid edges; ``permute_edata``
    reorders host edge data as the JAX package's does."""
    e = len(SRC) + PAD
    jdg = JaxGraph(SRC, DST, N).to_device(sort_by_dst=sort, pad_to=e)
    dg = Graph(SRC, DST, N).to_device("cpu", sort_by_dst=sort, pad_to=e)
    src, dst = dg.src.numpy(), dg.dst.numpy()
    np.testing.assert_array_equal(src, np.asarray(jdg.src))
    np.testing.assert_array_equal(dst, np.asarray(jdg.dst))
    for plan, idx, rows in ((dg.src_plan, src, N),
                            (dg.dst_plan, dst, N + 1)):
        want = scatter_plan(idx[:, None], None, rows)
        assert plan.num_rows == rows
        for key in ScatterPlan.FIELDS:
            got = getattr(plan, key)
            assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), getattr(want, key),
                                          key)
    np.testing.assert_array_equal(dg.in_deg.numpy(),
                                  np.bincount(DST, minlength=N))
    np.testing.assert_array_equal(dg.out_deg.numpy(),
                                  np.bincount(SRC, minlength=N))
    w = np.random.default_rng(0).normal(size=(len(SRC), 2))
    np.testing.assert_array_equal(dg.permute_edata(w), jdg.permute_edata(w))
    assert (dg.edge_perm is None) == (not sort)


@pytest.mark.parametrize("relabel", [True, False])
@pytest.mark.parametrize("mask", [True, False])
def test_subgraphs_match_jax(relabel, mask):
    rng = np.random.default_rng(4)
    src = rng.integers(0, 30, 120).astype(np.int32)
    dst = rng.integers(0, 30, 120).astype(np.int32)
    g, jg = Graph(src, dst, 30), JaxGraph(src, dst, 30)
    for h in (g, jg):
        h.ndata["feat"] = np.arange(60, dtype=np.float32).reshape(30, 2)
        h.edata["w"] = np.arange(120, dtype=np.float32)
    nodes = rng.permutation(30)[:17]
    if mask:
        keep = np.zeros(30, bool)
        keep[nodes] = True
        nodes = keep
    for got, want in ((g.node_subgraph(nodes, relabel),
                       jg.node_subgraph(nodes, relabel)),
                      (g.edge_subgraph(np.arange(0, 120, 3), relabel),
                       jg.edge_subgraph(np.arange(0, 120, 3), relabel))):
        assert got.num_nodes == want.num_nodes
        np.testing.assert_array_equal(got.src, want.src)
        np.testing.assert_array_equal(got.dst, want.dst)
        for store in ("ndata", "edata"):
            a, b = getattr(got, store), getattr(want, store)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], f"{store}/{k}")
    with pytest.raises(ValueError, match="duplicate"):
        g.node_subgraph(np.array([1, 1]))
    with pytest.raises(ValueError, match="boolean node mask"):
        g.node_subgraph(np.ones(3, bool))


# -- gspmm and gsddmm ---------------------------------------------------

@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("op", BINARY)
def test_gspmm_matches_jax(op, reduce):
    """Every message op and reduce on float features of trailing shape
    ``[2, 3]``, padded edges and two nodes with no in-edge: the values
    and the gradients of ``sum(out * r)`` in both features."""
    jdg, dg = _graphs()
    rng = np.random.default_rng(BINARY.index(op) * 4 + REDUCES.index(reduce))
    u = _nonzero(rng, (N, 2, 3))
    e = _nonzero(rng, (dg.num_edges, 2, 3))
    r = rng.normal(size=(N, 2, 3)).astype(np.float32)
    use_u, use_e = op != "copy_e", op != "copy_u"

    def jax_loss(uf, ef):
        out = jax_spmm.gspmm(jdg, op, reduce, ufeat=uf if use_u else None,
                             efeat=ef if use_e else None)
        return (out * r).sum(), out

    (_, want), (gu, ge) = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(u), jnp.asarray(e))
    tu = torch.from_numpy(u).requires_grad_(True)
    te = torch.from_numpy(e).requires_grad_(True)
    got = spmm.gspmm(dg, op, reduce, tu if use_u else None,
                     te if use_e else None)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OP_TOL)
    assert not got[6].any() and not got[8].any()
    if use_u:
        np.testing.assert_allclose(tu.grad.numpy(), np.asarray(gu), **OP_TOL)
    if use_e:
        np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), **OP_TOL)


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("op", ["copy_u", "copy_e", "u_add_e", "u_mul_e",
                                "e_sub_u", "u_div_e"])
def test_gspmm_keeps_integer_features(op, reduce):
    """int32 features keep their dtype (the mean and the divisions give
    float32, as in JAX); the max and min take the type's extremes as
    their identity, so a message equal to one survives and padded edges
    never win."""
    jdg, dg = _graphs()
    rng = np.random.default_rng(5)
    u = rng.integers(-5, 6, (N, 3)).astype(np.int32)
    e = rng.integers(1, 4, (dg.num_edges, 3)).astype(np.int32)
    u[1, 0] = np.iinfo(np.int32).max
    u[3, 1] = np.iinfo(np.int32).min
    use_u, use_e = op != "copy_e", op != "copy_u"
    want = np.asarray(jax_spmm.gspmm(
        jdg, op, reduce, ufeat=jnp.asarray(u) if use_u else None,
        efeat=jnp.asarray(e) if use_e else None))
    got = spmm.gspmm(dg, op, reduce,
                     torch.from_numpy(u) if use_u else None,
                     torch.from_numpy(e) if use_e else None)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_allclose(got.numpy(), want, **OP_TOL)


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_host_graph_gspmm_extremes_match_jax(reduce, monkeypatch):
    """Over a host ``Graph`` the max and min run destination chunk by
    destination chunk (here 2 rows of 3 a chunk); 0 for a node with no
    in-edge."""
    monkeypatch.setattr(spmm, "CHUNK_ELEMS", 6)
    jdg, _ = _graphs(pad=0)
    x = np.random.default_rng(2).normal(size=(N, 3)).astype(np.float32)
    want = jax_spmm.gspmm(jdg, "copy_u", reduce, ufeat=jnp.asarray(x))
    got = spmm.gspmm(Graph(SRC, DST, N), "copy_u", reduce,
                     torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("op", SDDMM)
def test_gsddmm_matches_jax(op):
    """Every op, padded edges included (a padded edge reads the last
    node's row and sends it no gradient, as JAX's clamped gather); the
    gradients of ``sum(out * r)`` in both ends; the named forms equal
    ``gsddmm``."""
    jdg, dg = _graphs()
    rng = np.random.default_rng(SDDMM.index(op))
    u, v = _nonzero(rng, (N, 4)), _nonzero(rng, (N, 4))
    width = 1 if op == "dot" else 4
    r = rng.normal(size=(dg.num_edges, width)).astype(np.float32)
    use_u, use_v = op != "copy_v", op != "copy_u"

    def jax_loss(a, b):
        out = jax_sddmm.gsddmm(jdg, op, a if use_u else None,
                               b if use_v else None)
        return (out * r).sum(), out

    (_, want), (gu, gv) = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(u), jnp.asarray(v))
    tu = torch.from_numpy(u).requires_grad_(True)
    tv = torch.from_numpy(v).requires_grad_(True)
    got = sddmm.gsddmm(dg, op, tu if use_u else None, tv if use_v else None)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OP_TOL)
    if use_u:
        np.testing.assert_allclose(tu.grad.numpy(), np.asarray(gu), **OP_TOL)
    if use_v:
        np.testing.assert_allclose(tv.grad.numpy(), np.asarray(gv), **OP_TOL)
    named = {"dot": sddmm.u_dot_v, "add": sddmm.u_add_v,
             "sub": sddmm.u_sub_v}
    if op in named:
        a, b = torch.from_numpy(u), torch.from_numpy(v)
        assert torch.equal(named[op](dg, a, b), sddmm.gsddmm(dg, op, a, b))
    with pytest.raises(ValueError, match="unknown sddmm op"):
        sddmm.gsddmm(dg, "pow", tu, tv)


# -- segment_mean and segment_min ---------------------------------------

@pytest.mark.parametrize("planned", [False, True])
@pytest.mark.parametrize("fn", ["mean", "min"])
def test_segment_mean_and_min_match_jax(fn, planned):
    """Unsorted ids into 7 segments, two of them empty (the mean gives 0,
    the min +inf), rows of shape ``[3, 2]``; the mean's counts from the
    ids' plan or from ``bincount``; values and gradients."""
    rng = np.random.default_rng(9)
    ids = rng.choice([0, 1, 3, 4, 6], size=20).astype(np.int32)
    data = rng.normal(size=(20, 3, 2)).astype(np.float32)
    r = rng.normal(size=(7, 3, 2)).astype(np.float32)
    jfn = {"mean": jax_segment.segment_mean,
           "min": jax_segment.segment_min}[fn]

    def jax_loss(d):
        out = jfn(d, jnp.asarray(ids), 7, sorted=False)
        return (jnp.where(jnp.isfinite(out), out, 0.0) * r).sum(), out

    (_, want), gd = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(data))
    td = torch.from_numpy(data).requires_grad_(True)
    tid = torch.from_numpy(ids)
    if fn == "mean":
        plan = scatter_plan(ids[:, None], None, 7) if planned else None
        got = segment.segment_mean(td, tid, 7, plan)
    else:
        got = segment.segment_min(td, tid, 7)
    (torch.where(torch.isfinite(got), got, torch.zeros_like(got))
     * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OP_TOL)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(gd), **OP_TOL)


@pytest.mark.parametrize("fn", ["mean", "min", "max", "sum"])
def test_segment_ops_on_integers_match_jax(fn):
    rng = np.random.default_rng(1)
    ids = rng.choice([0, 2, 3], size=12).astype(np.int32)
    data = rng.integers(-9, 9, (12, 2)).astype(np.int32)
    want = np.asarray(getattr(jax_segment, f"segment_{fn}")(
        jnp.asarray(data), jnp.asarray(ids), 5, sorted=False))
    got = getattr(segment, f"segment_{fn}")(torch.from_numpy(data),
                                            torch.from_numpy(ids), 5)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


# -- SAGE layers and GraphSAGE ------------------------------------------

IN, HIDDEN, OUT = 6, 8, 5


def _layer_graphs():
    rng = np.random.default_rng(12)
    src = rng.integers(0, 40, 180).astype(np.int32)
    dst = rng.integers(0, 39, 180).astype(np.int32)     # node 39: no in-edge
    e = 180 + 7
    return (JaxGraph(src, dst, 40).to_device(pad_to=e),
            Graph(src, dst, 40).to_device("cpu", pad_to=e))


def _layer_state(tree):
    sd = flax_layout.state_dict_from_flax({"L_0": tree})
    return {k[len("layers.0."):]: v for k, v in sd.items()}


def _edge_weights(jdg, dg):
    """Random host edge weights ``[E, 1]`` in the graph's sorted order,
    the padded edges weighted 1."""
    w = np.random.default_rng(3).uniform(0.1, 2.0, (180, 1)).astype(
        np.float32)
    pad = np.ones((dg.num_edges - 180, 1), np.float32)
    got = np.concatenate([dg.permute_edata(w), pad])
    want = np.concatenate([jdg.permute_edata(w), pad])
    np.testing.assert_array_equal(got, want)
    return got


def _check_layer(jax_apply, params, port, args_of, h, r):
    """The port layer's output and gradients (parameters, input) against
    ``jax.value_and_grad`` of the flax layer's ``sum(out * r)``."""
    def jax_loss(p, x):
        out = jax_apply(p, x)
        return (out * r).sum(), out

    (_, want), (gp, gx) = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                             has_aux=True)(
        params, jnp.asarray(h))
    x = torch.from_numpy(h).requires_grad_(True)
    out = port(*args_of(x))
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), **MODEL_TOL)
    return gp


@pytest.mark.parametrize("aggregator", ["mean", "sum", "pool"])
def test_sage_conv_matches_flax(aggregator):
    jdg, dg = _layer_graphs()
    rng = np.random.default_rng(7)
    h = rng.normal(size=(40, IN)).astype(np.float32)
    r = rng.normal(size=(40, OUT)).astype(np.float32)
    conv = JaxSAGEConv(OUT, aggregator=aggregator)
    params = _perturbed(conv.init(jax.random.PRNGKey(0), jdg,
                                  jnp.asarray(h)), 1)
    port = SAGEConv(IN, OUT, aggregator, device="cpu")
    port.load_state_dict(_layer_state(params["params"]))
    gp = _check_layer(lambda p, x: conv.apply(p, jdg, x), params, port,
                      lambda x: (dg, x), h, r)
    sd = {f"layers.0.{k}": p.grad for k, p in port.named_parameters()}
    got = flax_layout.state_dict_to_flax(sd, "L")["params"]["L_0"]
    _assert_trees_close(got, jax.device_get(gp)["params"], MODEL_TOL)


def test_weighted_sage_conv_matches_flax():
    """Random edge weights, permuted into the graph's sorted order."""
    jdg, dg = _layer_graphs()
    rng = np.random.default_rng(8)
    h = rng.normal(size=(40, IN)).astype(np.float32)
    r = rng.normal(size=(40, OUT)).astype(np.float32)
    ew = _edge_weights(jdg, dg)
    conv = JaxWeightedSAGEConv(OUT)
    params = _perturbed(conv.init(jax.random.PRNGKey(1), jdg,
                                  jnp.asarray(h), jnp.asarray(ew)), 2)
    port = WeightedSAGEConv(IN, OUT, device="cpu")
    port.load_state_dict(_layer_state(params["params"]))
    gp = _check_layer(lambda p, x: conv.apply(p, jdg, x, jnp.asarray(ew)),
                      params, port, lambda x: (dg, x, torch.from_numpy(ew)),
                      h, r)
    sd = {f"layers.0.{k}": p.grad for k, p in port.named_parameters()}
    got = flax_layout.state_dict_to_flax(sd, "L")["params"]["L_0"]
    _assert_trees_close(got, jax.device_get(gp)["params"], MODEL_TOL)


@pytest.mark.parametrize("aggregator", ["mean", "pool"])
def test_graphsage_matches_flax(aggregator):
    jdg, dg = _layer_graphs()
    rng = np.random.default_rng(10)
    h = rng.normal(size=(40, IN)).astype(np.float32)
    r = rng.normal(size=(40, OUT)).astype(np.float32)
    model = JaxGraphSAGE(HIDDEN, OUT, aggregator=aggregator)
    params = _perturbed(model.init(jax.random.PRNGKey(2), jdg,
                                   jnp.asarray(h)), 3)
    port = models.GraphSAGE(IN, HIDDEN, OUT, aggregator=aggregator,
                            device="cpu")
    port.load_state_dict(models.state_dict_from_flax(params))
    gp = _check_layer(lambda p, x: model.apply(p, jdg, x), params, port,
                      lambda x: (dg, x), h, r)
    got = flax_layout.state_dict_to_flax(
        {k: p.grad for k, p in port.named_parameters()}, port.flax_prefix)
    _assert_trees_close(got["params"], jax.device_get(gp)["params"],
                        MODEL_TOL)


def test_every_family_round_trips_through_the_carrier():
    """``flax_params`` then ``state_dict_from_flax`` gives every model
    of :data:`models.FAMILIES` (and both link predictors) its weights
    back bit for bit, and the new families read the JAX package's
    trees."""
    port_models = [
        models.DistSAGE(IN, HIDDEN, OUT, aggregator="pool", device="cpu"),
        models.DistGAT(IN, HIDDEN, OUT, num_heads=2, device="cpu"),
        models.DistGATv2(IN, HIDDEN, OUT, num_heads=2, device="cpu"),
        models.GAT(IN, HIDDEN, OUT, num_heads=2, device="cpu"),
        models.GCN(IN, HIDDEN, OUT, device="cpu"),
        models.GraphSAGE(IN, HIDDEN, OUT, aggregator="pool", device="cpu"),
        models.WeightedSAGE(IN, HIDDEN, OUT, device="cpu"),
        models.LinkPredModel(IN, HIDDEN, "dot", device="cpu"),
        models.LinkPredModel(IN, HIDDEN, "mlp", device="cpu")]
    covered = {type(m).__name__ for m in port_models}
    assert covered >= {cls.__name__ for cls in models.FAMILIES.values()}
    for m in port_models:
        tree = models.flax_params(m)
        back = models.state_dict_from_flax(tree)
        sd = m.state_dict()
        assert back.keys() == sd.keys(), type(m).__name__
        for k, v in sd.items():
            assert torch.equal(back[k], v), k
    jdg, _ = _layer_graphs()
    h = jnp.ones((40, IN))
    weighted = _load_jax_example("message_passing").TwoLayerSAGE(
        HIDDEN, OUT, weighted=True)
    for jax_model, port in (
            (JaxGraphSAGE(HIDDEN, OUT, aggregator="pool"), port_models[5]),
            (weighted, port_models[6])):
        tree = jax.device_get(jax_model.init(jax.random.PRNGKey(0), jdg, h))
        port.load_state_dict(models.state_dict_from_flax(tree))
        _assert_trees_close(models.flax_params(port)["params"],
                            tree["params"], dict(rtol=0, atol=0))
    with pytest.raises(ValueError, match="one layer family"):
        models.state_dict_from_flax({"params": {"SAGEConv_0": {},
                                                "GraphConv_1": {}}})


# -- the entry points against the JAX examples ---------------------------

def _load_jax_example(name):
    path = os.path.join(REPO, "examples", name, "train.py")
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("weighted", [False, True])
def test_message_passing_example_matches_jax(weighted):
    """Six epochs of ``examples/message_passing.py`` against the JAX
    example's loop, from the flax weights that loop starts from."""
    jax_mp = _load_jax_example("message_passing")
    argv = ["--num_epochs", "6", "--dataset_scale", "0.25"]
    argv += ["--weighted"] if weighted else []
    want = jax_mp.main(argv)
    jg = jax_datasets.synthetic_node_clf(677, 2639, 64, 7, seed=0).graph
    init = jax.device_get(jax_mp.TwoLayerSAGE(16, 7, weighted=weighted)
                          .init(jax.random.PRNGKey(0), jg.to_device(),
                                jnp.asarray(jg.ndata["feat"])))
    got = message_passing.main(argv + ["--device", "cpu"], init_params=init)
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]],
                               **MODEL_TOL)
    n_test = int(jg.ndata["test_mask"].sum())
    assert abs(got["test_acc"] - want["test_acc"]) <= 1 / n_test + 1e-6
    _assert_trees_close(got["params"]["params"],
                        jax.device_get(want["params"])["params"],
                        dict(rtol=1e-3, atol=1e-3))


def test_graphsage_example_matches_jax(monkeypatch, tmp_path_factory):
    """Two epochs of ``examples/graphsage.py`` against the JAX example's
    loop (host sampler, the same batch stream), from the flax weights
    that loop starts from, with dropout 0 on both sides (the dropout
    draws differ between the packages)."""
    use_jax_graphcore(monkeypatch, tmp_path_factory)
    jax_gs = _load_jax_example("GraphSAGE")

    def no_dropout(cls):
        return functools.wraps(cls)(
            lambda *a, **kw: cls(*a, **{**kw, "dropout": 0.0}))

    # the JAX trainer takes the model's rate, the port's the config's
    monkeypatch.setattr(jax_gs, "DistSAGE", no_dropout(JaxDistSAGE))
    monkeypatch.setattr(graphsage, "TrainConfig",
                        no_dropout(graphsage.TrainConfig))
    argv = ["--num_epochs", "2", "--batch_size", "100", "--fan_out", "4,6",
            "--dataset_scale", "0.0001", "--prefetch", "0"]
    want = jax_gs.main(argv)
    blk = JaxFanoutBlock(jnp.zeros((2, 3), jnp.int32),
                         jnp.ones((2, 3), jnp.float32), 4)
    init = jax.device_get(JaxDistSAGE(hidden_feats=16, out_feats=47,
                                      dropout=0.0).init(
        jax.random.PRNGKey(0), [blk, blk], jnp.ones((4, 100)),
        train=False))
    got = graphsage.main(argv + ["--device", "cpu"], init_params=init)
    assert got["step"] == want["step"] == 12
    assert len(got["history"]) == len(want["history"]) == 2
    for g_rec, w_rec in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g_rec["loss"], w_rec["loss"], **MODEL_TOL)
    n_test = int(np.count_nonzero(jax_datasets.ogbn_products(
        scale=0.0001).graph.ndata["test_mask"]))
    assert abs(got["history"][-1]["test_acc"]
               - want["history"][-1]["test_acc"]) <= 1 / n_test + 1e-6
    # --remat recomputes each layer in the backward: the same run
    remat = graphsage.main(argv + ["--remat", "--device", "cpu"],
                           init_params=init)
    assert [r["losses"] for r in remat["history"]] == \
        [r["losses"] for r in got["history"]]


def test_dist_evaluate_with_pool_matches_single_graph_inference(tmp_path):
    """``DistTrainer.evaluate`` with the pool aggregator (each slot's
    local max, destination chunk by destination chunk) against the
    single-graph ``sage_inference`` of the same weights."""
    from dgl_operator_tpu_torch.graph import datasets
    from dgl_operator_tpu_torch.graph.partition import partition_graph
    from dgl_operator_tpu_torch.models.sage import sage_inference
    from dgl_operator_tpu_torch.runtime.dist import DistTrainer
    from dgl_operator_tpu_torch.runtime.loop import TrainConfig

    g = datasets.synthetic_node_clf(600, 3000, 12, 5, seed=6).graph
    book = partition_graph(g, "pool", 2, str(tmp_path))
    model = models.DistSAGE(12, 16, 5, aggregator="pool", dropout=0.0,
                            device="cpu",
                            generator=torch.Generator().manual_seed(4))
    tr = DistTrainer(model, book, TrainConfig(batch_size=32, fanouts=(4, 4),
                                              dropout=0.0), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spmm, "CHUNK_ELEMS", 64 * 16)
        accs = tr.evaluate()
    with torch.no_grad():
        pred = sage_inference(tr.model, g, torch.from_numpy(
            g.ndata["feat"])).argmax(-1).numpy()
    for mask in ("val_mask", "test_mask"):
        m = g.ndata[mask].astype(bool)
        single = float((pred[m] == g.ndata["label"][m]).mean())
        assert abs(accs[mask] - single) <= 1 / m.sum() + 1e-6, mask
