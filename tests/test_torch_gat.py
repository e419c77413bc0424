"""The port's attention layers, GAT stacks and segment ops vs flax.

Inputs come from numpy with a seed; flax params come from ``init``
(perturbed so every entry counts) and cross through the port's
converter. Each layer's forward and its gradients of params and inputs
(of ``sum(out * R)``, ``R`` a fixed random cotangent) must match the
JAX package's within 1e-5: the fanout layers on a padded two-layer
minibatch whose padded destination rows have no valid slot, the
full-graph layers on a padded ``DeviceGraph``. A model's forward,
losses and full-graph inference match within 1e-4. ``DistGAT`` and
``DistGATv2`` train in ``SampledTrainer`` against the JAX trainer
(dropout 0, its C++ graph core sampling both), and the device sampler
with a GAT stack is held against itself: K = 4 equals K = 1 and a
resumed run equals the uninterrupted one, bit for bit.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_operator_tpu import ops as jax_ops
from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph.blocks import FanoutBlock as JaxFanoutBlock
from dgl_operator_tpu.models import gat as jax_gat
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.nn import conv as jax_conv
from dgl_operator_tpu.runtime import SampledTrainer as JaxSampledTrainer
from dgl_operator_tpu.runtime import TrainConfig as JaxTrainConfig
from dgl_operator_tpu_torch import models
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.blocks import (build_fanout_blocks,
                                                 pad_minibatch)
from dgl_operator_tpu_torch.models import flax_layout
from dgl_operator_tpu_torch.models.gat import (DistGAT, DistGATv2,
                                               gat_inference)
from dgl_operator_tpu_torch.nn import conv
from dgl_operator_tpu_torch.ops import segment
from dgl_operator_tpu_torch.ops.scatter import (attach_plans, scatter_plan,
                                                slot_plan,
                                                tree_scatter_plan)
from dgl_operator_tpu_torch.runtime.checkpoint import CheckpointManager
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig
from test_torch_native import use_jax_graphcore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# float32 sums of a few dozen terms, taken in another order than XLA's
OP_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
IN, OUT, HEADS = 12, 5, 3
FANOUTS = (3, 4)
SEEDS, BATCH = 8, 12      # 4 padded seed rows: blocks with no valid slot
KINDS = {"gat": (jax_conv.FanoutGATConv, conv.FanoutGATConv,
                 jax_conv.GATConv, conv.GATConv),
         "gatv2": (jax_conv.FanoutGATv2Conv, conv.FanoutGATv2Conv,
                   jax_conv.GATv2Conv, conv.GATv2Conv)}
STACKS = {"gat": (jax_gat.DistGAT, DistGAT),
          "gatv2": (jax_gat.DistGATv2, DistGATv2)}


@pytest.fixture(autouse=True)
def jax_library(monkeypatch, tmp_path_factory):
    use_jax_graphcore(monkeypatch, tmp_path_factory)
    monkeypatch.delenv("TPU_OPERATOR_TUNED_MANIFEST", raising=False)


@pytest.fixture(scope="module")
def graph():
    return datasets.synthetic_node_clf(200, 900, IN, 4, seed=4).graph


@pytest.fixture(scope="module")
def batch(graph):
    """One padded two-layer minibatch and its input rows."""
    mb = build_fanout_blocks(graph.csc(), np.arange(SEEDS, dtype=np.int64),
                             FANOUTS, seed=5)
    mb = pad_minibatch(mb, BATCH, FANOUTS, graph.num_nodes)
    assert not mb.blocks[1].mask[SEEDS:].any()
    h = graph.ndata["feat"][mb.input_nodes].astype(np.float32)
    return mb, h


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))
        .astype(np.float32), params)


def _layer_state(tree):
    """A one-layer flax subtree as the port layer's state dict."""
    sd = flax_layout.state_dict_from_flax({"L_0": tree})
    return {k[len("layers.0."):]: v for k, v in sd.items()}


def _cotangent(shape, seed=7):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port_grads(layer, args, h, r):
    """Forward of ``layer(*args, h)`` and the grads of ``sum(out * r)``:
    the output, the flax-named param grads, the input grad."""
    x = torch.from_numpy(h).requires_grad_(True)
    out = layer(*args, x)
    (out * torch.from_numpy(r)).sum().backward()
    sd = {f"layers.0.{k}": p.grad for k, p in layer.named_parameters()}
    tree = flax_layout.state_dict_to_flax(sd, "L")["params"]["L_0"]
    return out.detach().numpy(), tree, x.grad.numpy()


def _jax_grads(module, params, args, h, r):
    """The flax forward and its gradients, each one jitted program."""
    def apply(p, x):
        return module.apply(p, *args, x)

    def f(p, x):
        return (apply(p, x) * r).sum()

    out = np.asarray(jax.jit(apply)(params, jnp.asarray(h)))
    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(h))
    return out, jax.device_get(gp)["params"], np.asarray(gx)


def _assert_trees_close(got, want, tol, where=""):
    assert set(got) == set(want), (where, set(got), set(want))
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_trees_close(got[k], v, tol, f"{where}/{k}")
        else:
            np.testing.assert_allclose(got[k], np.asarray(v),
                                       err_msg=f"{where}/{k}", **tol)


# -- segment ops ----------------------------------------------------------
def _segment_data():
    rng = np.random.default_rng(3)
    ids = np.array([0, 0, 2, 2, 2, 5, 5, 3], np.int32)   # 1, 4 empty
    scores = rng.normal(size=(8, 2)).astype(np.float32)
    scores[5:7, 0] = -np.inf      # segment 5, head 0: all -inf
    scores[3, 1] = -np.inf        # one -inf in segment 2
    return ids, scores


@pytest.mark.parametrize("op", ["segment_sum", "segment_max"])
def test_segment_reductions_match_jax(op):
    ids, scores = _segment_data()
    data = np.where(np.isfinite(scores), scores, 0.0).astype(np.float32)
    want = np.asarray(getattr(jax_ops, op)(jnp.asarray(data),
                                           jnp.asarray(ids), 6,
                                           sorted=False))
    got = getattr(segment, op)(torch.from_numpy(data),
                               torch.from_numpy(ids), 6).numpy()
    np.testing.assert_allclose(got, want, **OP_TOL)
    if op == "segment_max":
        assert np.isneginf(got[[1, 4]]).all()


def test_segment_softmax_matches_jax_with_empty_and_inf_segments():
    ids, scores = _segment_data()
    r = _cotangent(scores.shape)

    def f(s):
        return (jax_ops.segment_softmax(s, jnp.asarray(ids), 6,
                                        sorted=False) * r).sum()

    want = np.asarray(jax_ops.segment_softmax(
        jnp.asarray(scores), jnp.asarray(ids), 6, sorted=False))
    want_g = np.asarray(jax.grad(f)(jnp.asarray(scores)))
    s = torch.from_numpy(scores).requires_grad_(True)
    got = segment.segment_softmax(s, torch.from_numpy(ids), 6)
    (got * torch.from_numpy(r)).sum().backward()
    assert np.isfinite(got.detach().numpy()).all()
    assert (got.detach().numpy()[5:7, 0] == 0).all()
    np.testing.assert_allclose(got.detach().numpy(), want, **OP_TOL)
    np.testing.assert_allclose(s.grad.numpy(), np.nan_to_num(want_g),
                               **OP_TOL)


# -- fanout layers ----------------------------------------------------------
@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("layer", [0, 1])
def test_fanout_attention_matches_flax(batch, kind, concat, layer):
    mb, h = batch
    blk = mb.blocks[layer]
    if layer == 1:      # block 1 reads block 0's destinations
        h = _cotangent((blk.num_src, IN), seed=11)
    jblk = JaxFanoutBlock(jnp.asarray(blk.nbr), jnp.asarray(blk.mask),
                          blk.num_src)
    jcls, pcls = KINDS[kind][:2]
    mod = jcls(OUT, num_heads=HEADS, concat_heads=concat)
    params = _perturbed(mod.init(jax.random.PRNGKey(1), jblk,
                                 jnp.asarray(h)), 2)
    r = _cotangent((blk.num_dst, HEADS * OUT if concat else OUT))
    want, want_gp, want_gx = _jax_grads(mod, params, (jblk,), h, r)
    port = pcls(IN, OUT, num_heads=HEADS, concat_heads=concat,
                device="cpu")
    port.load_state_dict(_layer_state(params["params"]))
    got, got_gp, got_gx = _port_grads(port, (blk,), h, r)
    assert got.shape == want.shape
    if layer == 1:      # the padded destinations attend to nothing
        assert np.abs(got[SEEDS:]).max() == 0
    assert np.isfinite(got_gx).all()
    np.testing.assert_allclose(got, want, **OP_TOL)
    np.testing.assert_allclose(got_gx, want_gx, **OP_TOL)
    _assert_trees_close(got_gp, want_gp, OP_TOL)


# -- full-graph layers --------------------------------------------------------
@pytest.mark.parametrize("kind", list(KINDS))
def test_full_graph_attention_matches_flax(graph, kind):
    jg = jax_datasets.synthetic_node_clf(200, 900, IN, 4, seed=4).graph
    jdg = jg.to_device(pad_to=jg.num_edges + 13)
    dg = graph.to_device("cpu", pad_to=graph.num_edges + 13)
    h = graph.ndata["feat"].astype(np.float32)
    jcls, pcls = KINDS[kind][2:]
    mod = jcls(OUT, num_heads=HEADS)
    params = _perturbed(mod.init(jax.random.PRNGKey(3), jdg,
                                 jnp.asarray(h)), 4)
    r = _cotangent((graph.num_nodes, HEADS * OUT))
    want, want_gp, want_gx = _jax_grads(mod, params, (jdg,), h, r)
    port = pcls(IN, OUT, num_heads=HEADS, device="cpu")
    port.load_state_dict(_layer_state(params["params"]))
    got, got_gp, got_gx = _port_grads(port, (dg,), h, r)
    np.testing.assert_allclose(got, want, **OP_TOL)
    np.testing.assert_allclose(got_gx, want_gx, **OP_TOL)
    _assert_trees_close(got_gp, want_gp, OP_TOL)


@pytest.mark.parametrize("out", [5, 20])     # projects first / last
@pytest.mark.parametrize("norm", ["both", "right", "none"])
def test_graph_conv_matches_flax(graph, norm, out):
    jg = jax_datasets.synthetic_node_clf(200, 900, IN, 4, seed=4).graph
    jdg = jg.to_device(pad_to=jg.num_edges + 5)
    dg = graph.to_device("cpu", pad_to=graph.num_edges + 5)
    h = graph.ndata["feat"].astype(np.float32)
    mod = jax_conv.GraphConv(out, norm=norm)
    params = _perturbed(mod.init(jax.random.PRNGKey(0), jdg,
                                 jnp.asarray(h)), 5)
    r = _cotangent((graph.num_nodes, out))
    want, want_gp, want_gx = _jax_grads(mod, params, (jdg,), h, r)
    port = conv.GraphConv(IN, out, norm=norm, device="cpu")
    port.load_state_dict(_layer_state(params["params"]))
    got, got_gp, got_gx = _port_grads(port, (dg,), h, r)
    np.testing.assert_allclose(got, want, **OP_TOL)
    np.testing.assert_allclose(got_gx, want_gx, **OP_TOL)
    _assert_trees_close(got_gp, want_gp, OP_TOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_fanout_attention_matches_full_graph(graph, kind):
    """With a fanout of at least the largest in-degree a block holds
    every in-edge of its destinations, so the sampled layer equals its
    full-graph twin with the same weights (``tests/test_nn.py``'s
    parity)."""
    seeds = np.arange(graph.num_nodes, dtype=np.int64)
    fan = int(graph.in_degrees().max())
    mb = build_fanout_blocks(graph.csc(), seeds, [fan], seed=0)
    x = torch.from_numpy(graph.ndata["feat"].astype(np.float32))
    _, fcls, _, gcls = KINDS[kind]
    sampled = fcls(IN, OUT, num_heads=HEADS, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    full = gcls(IN, OUT, num_heads=HEADS, device="cpu")
    full.load_state_dict(sampled.state_dict())
    with torch.no_grad():
        got = sampled(mb.blocks[0], x[torch.from_numpy(mb.input_nodes)])
        want = full(graph.to_device("cpu"), x)
    np.testing.assert_allclose(got.numpy(), want.numpy()[seeds],
                               rtol=2e-5, atol=2e-5)


# -- stacks, converters, inference --------------------------------------------
def _jax_stack(kind, batch, dropout=0.0):
    mb, h = batch
    jblocks = [JaxFanoutBlock(jnp.asarray(b.nbr), jnp.asarray(b.mask),
                              b.num_src) for b in mb.blocks]
    model = STACKS[kind][0](hidden_feats=8, out_feats=4, num_heads=2,
                            dropout=dropout)
    params = _perturbed(model.init(jax.random.PRNGKey(0), jblocks,
                                   jnp.asarray(h)), 3)
    return model, params, jblocks


@pytest.mark.parametrize("kind", list(STACKS))
def test_dist_gat_matches_flax(batch, kind):
    """Forward in both modes at dropout 0 and the masked loss's
    gradients, from params carried across by the converter."""
    mb, h = batch
    model, params, jblocks = _jax_stack(kind, batch)
    labels = np.random.default_rng(2).integers(0, 4, BATCH)
    valid = (mb.seeds >= 0).astype(np.float32)

    def loss(p):
        logits = model.apply(p, jblocks, jnp.asarray(h), train=False)
        ll = -jax.nn.log_softmax(logits)[jnp.arange(BATCH), labels]
        return (ll * valid).sum() / valid.sum()

    want = np.asarray(jax.jit(lambda p: model.apply(
        p, jblocks, jnp.asarray(h), train=False))(params))
    want_g = jax.device_get(jax.jit(jax.grad(loss))(params))
    port = STACKS[kind][1](IN, 8, 4, num_heads=2, dropout=0.0,
                           device="cpu")
    port.load_state_dict(models.state_dict_from_flax(params))
    for mode in (port.eval, port.train):
        mode()
        logits = port(mb.blocks, torch.from_numpy(h))
        np.testing.assert_allclose(logits.detach().numpy(), want,
                                   **MODEL_TOL)
    ll = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(labels), reduction="none")
    v = torch.from_numpy(valid)
    ((ll * v).sum() / v.sum()).backward()
    got_g = flax_layout.state_dict_to_flax(
        {k: p.grad for k, p in port.named_parameters()}, port.flax_prefix)
    _assert_trees_close(got_g["params"], want_g["params"], MODEL_TOL)


def test_converter_picks_the_family_both_ways(batch):
    mb, h = batch
    jblocks = [JaxFanoutBlock(jnp.asarray(b.nbr), jnp.asarray(b.mask),
                              b.num_src) for b in mb.blocks]
    trees = {"gat": _jax_stack("gat", batch)[1],
             "gatv2": _jax_stack("gatv2", batch)[1],
             "sage": jax.device_get(JaxDistSAGE(
                 hidden_feats=8, out_feats=4).init(
                     jax.random.PRNGKey(1), jblocks, jnp.asarray(h)))}
    ports = {"gat": DistGAT(IN, 8, 4, num_heads=2, device="cpu"),
             "gatv2": DistGATv2(IN, 8, 4, num_heads=2, device="cpu"),
             "sage": models.DistSAGE(IN, 8, 4, device="cpu")}
    for name, tree in trees.items():
        port = ports[name]
        port.load_state_dict(models.state_dict_from_flax(tree))
        back = models.flax_params(port)
        _assert_trees_close(back["params"], tree["params"],
                            dict(rtol=0, atol=0), name)
    mixed = {"params": {"FanoutGATConv_0": {}, "FanoutSAGEConv_1": {}}}
    with pytest.raises(ValueError, match="one layer family"):
        models.state_dict_from_flax(mixed)
    with pytest.raises(ValueError, match="no model of the port"):
        models.state_dict_from_flax({"params": {"Dense_0": {}}})


@pytest.mark.parametrize("kind", list(STACKS))
def test_gat_inference_matches_jax(graph, batch, kind):
    """The port's sparse full-graph inference (repeated edges merged
    into counts) against the JAX edge-softmax inference."""
    _, params, _ = _jax_stack(kind, batch)
    jg = jax_datasets.synthetic_node_clf(200, 900, IN, 4, seed=4).graph
    fn = jax_gat.gatv2_inference if kind == "gatv2" else \
        jax_gat.gat_inference
    dg = jg.to_device()
    want = np.asarray(jax.jit(lambda p, x: fn(p, dg, x, 2, 2))(
        params, jnp.asarray(jg.ndata["feat"])))
    port = STACKS[kind][1](IN, 8, 4, num_heads=2, device="cpu")
    port.load_state_dict(models.state_dict_from_flax(params))
    with torch.no_grad():
        got = gat_inference(port, graph, torch.from_numpy(
            graph.ndata["feat"]))
        chunked = models.full_graph_inference(port, graph, torch.from_numpy(
            graph.ndata["feat"]))
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    np.testing.assert_array_equal(chunked.numpy(), got.numpy())


def test_sparse_edge_attention_chunks_agree(graph, monkeypatch):
    """The logits' chunking changes nothing: one entry a chunk equals
    one chunk for all."""
    port = DistGATv2(IN, 8, 4, num_heads=2, device="cpu")
    layer = port.layers[0]
    x = torch.from_numpy(graph.ndata["feat"])
    fs, fd, attn = conv.gatv2_projection_raw(layer, x)

    def logits_of(u, v):
        return (layer.act(fs[u] + fd[v]) * attn).sum(-1)

    with torch.no_grad():
        whole = conv.sparse_edge_attention(graph, fs, logits_of, True)
        monkeypatch.setattr(conv, "ATTENTION_CHUNK_ELEMS", 16)
        bits = conv.sparse_edge_attention(graph, fs, logits_of, True)
    np.testing.assert_allclose(bits.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)


# -- per-slot plans ---------------------------------------------------------
def test_slot_plans_host_and_tree(batch):
    """A per-slot plan is the row plan of the flattened table over the
    valid slots; the plan built for a tree block equals the host's."""
    mb, _ = batch
    blk = mb.blocks[1]
    got = slot_plan(blk.nbr, blk.mask, blk.num_src)
    want = scatter_plan(blk.nbr.reshape(-1, 1), blk.mask.reshape(-1, 1),
                        blk.num_src)
    for k in got.FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.cnt.shape == (blk.nbr.size,)
    attach_plans(mb.blocks, True)
    assert all(b.plan.cnt.shape == (b.nbr.size,) for b in mb.blocks)
    n, f = 5, 3
    mask = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, (n, f)).astype(np.uint8))
    pos = (n + torch.arange(n * f)).view(n, f).numpy()
    tree = tree_scatter_plan(mask, slots=True)
    host = slot_plan(pos, mask.numpy(), n * (f + 1))
    nnz = int(mask.sum())
    for k in host.FIELDS:
        a, b = getattr(tree, k).numpy(), getattr(host, k)
        if k == "src":
            a = a[:nnz]
        np.testing.assert_array_equal(a, b, k)


# -- SampledTrainer ---------------------------------------------------------
SFEAT, SCLASSES, SBATCH = 12, 4, 32


def _sampled_kw(**kw):
    return dict(dict(num_epochs=2, batch_size=SBATCH, fanouts=FANOUTS,
                     eval_every=2, log_every=1000, dropout=0.0, seed=5,
                     lr=0.01, prefetch=0), **kw)


@pytest.fixture(scope="module")
def jax_sampled(tmp_path_factory):
    """Per stack: the JAX trainer's run, its initial and final params."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        use_jax_graphcore(mp, tmp_path_factory)
        mp.delenv("TPU_OPERATOR_TUNED_MANIFEST", raising=False)
        g = jax_datasets.synthetic_node_clf(300, 1500, SFEAT, SCLASSES,
                                            seed=11).graph
        for kind, (jcls, _) in STACKS.items():
            model = jcls(hidden_feats=8, out_feats=SCLASSES, num_heads=2,
                         dropout=0.0)
            tr = JaxSampledTrainer(model, g, JaxTrainConfig(
                **_sampled_kw(), sentry=False))
            mb = tr.sample(tr.train_ids[:SBATCH], 0)
            init = jax.device_get(model.init(
                jax.random.PRNGKey(5), mb.blocks,
                tr.feats[jnp.asarray(mb.input_nodes)], train=False))
            run = tr.train()
            out[kind] = (init, run, jax.device_get(run["params"]))
    return out


@pytest.fixture(scope="module")
def sampled_graph():
    return datasets.synthetic_node_clf(300, 1500, SFEAT, SCLASSES,
                                       seed=11).graph


@pytest.mark.parametrize("kind", list(STACKS))
def test_sampled_trainer_matches_jax(jax_sampled, sampled_graph, kind):
    init, want, final = jax_sampled[kind]
    model = STACKS[kind][1](SFEAT, 8, SCLASSES, num_heads=2, device="cpu")
    tr = SampledTrainer(model, sampled_graph, TrainConfig(**_sampled_kw()),
                        device="cpu")
    got = tr.train(init_params=init)
    assert got["step"] == want["step"]
    for g_rec, w_rec in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g_rec["loss"], w_rec["loss"],
                                   **MODEL_TOL)
    n_val = int(sampled_graph.ndata["val_mask"].sum())
    assert abs(got["history"][-1]["val_acc"]
               - want["history"][-1]["val_acc"]) <= 1 / n_val + 1e-6
    # evaluate: the port's inference of the JAX trainer's final weights
    # against the JAX inference of them
    port = STACKS[kind][1](SFEAT, 8, SCLASSES, num_heads=2, device="cpu")
    port.load_state_dict(models.state_dict_from_flax(final))
    fn = jax_gat.gatv2_inference if kind == "gatv2" else \
        jax_gat.gat_inference
    jg = jax_datasets.synthetic_node_clf(300, 1500, SFEAT, SCLASSES,
                                         seed=11).graph
    dg = jg.to_device()
    w_logits = np.asarray(jax.jit(lambda p, x: fn(p, dg, x, 2, 2))(
        final, jnp.asarray(jg.ndata["feat"])))
    with torch.no_grad():
        g_logits = gat_inference(port, sampled_graph, torch.from_numpy(
            sampled_graph.ndata["feat"])).numpy()
    np.testing.assert_allclose(g_logits, w_logits, **MODEL_TOL)
    tr.model.load_state_dict(port.state_dict())
    accs = tr.evaluate()
    for name in ("val_mask", "test_mask"):
        m = sampled_graph.ndata[name]
        hit = (w_logits.argmax(-1) == sampled_graph.ndata["label"])[m]
        assert accs[name] == pytest.approx(hit.mean(), abs=1e-6)


def _device_run(graph, kind, **kw):
    model = STACKS[kind][1](SFEAT, 8, SCLASSES, num_heads=2, device="cpu",
                            generator=torch.Generator().manual_seed(2))
    return SampledTrainer(model, graph, TrainConfig(**_sampled_kw(
        sampler="device", **kw)), device="cpu")


def _losses(out):
    return [x for rec in out["history"] for x in rec["losses"]]


@pytest.mark.parametrize("kind", list(STACKS))
def test_device_sampler_gat_k4_equals_k1_and_resume(sampled_graph, kind,
                                                    tmp_path):
    """K = 4 trains exactly what K = 1 trains (dropout 0.5 from the
    trainer's generator), and a run with dropout 0 cut at a checkpoint
    and resumed equals the uninterrupted run, bit for bit."""
    one = _device_run(sampled_graph, kind, dropout=0.5).train()
    four = _device_run(sampled_graph, kind, dropout=0.5,
                       steps_per_call=4).train()
    assert _losses(one) == _losses(four)
    for k, v in one["params"].items():
        assert torch.equal(v, four["params"][k]), k
    assert np.isfinite(_losses(one)).all()
    whole = _device_run(sampled_graph, kind).train()
    spe = len(whole["history"][0]["losses"])
    cut = _device_run(sampled_graph, kind, num_epochs=1,
                      ckpt_dir=str(tmp_path), ckpt_every=3).train()
    assert CheckpointManager(str(tmp_path)).latest_step() == spe
    resumed = _device_run(sampled_graph, kind,
                          ckpt_dir=str(tmp_path)).train()
    assert resumed["step"] == whole["step"]
    assert resumed["history"][-1]["losses"] == whole["history"][-1]["losses"]
    assert cut["history"][0]["losses"] == whole["history"][0]["losses"]
    for k, v in whole["params"].items():
        assert torch.equal(v, resumed["params"][k]), k


def test_leaky_branch_probe_shares_branches():
    """The probe's float64 run on the float32 run's LeakyReLU branches
    leaves only float32 rounding between the two gradients (the
    smoke's card-against-CPU check relies on ``chip_smoke.Branches``)."""
    spec = importlib.util.spec_from_file_location(
        "leaky_branch_probe", os.path.join(REPO, "leaky_branch_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    (rec,) = probe.main(["--scale", "0.001", "--batches", "1"])
    assert rec["leaky_inputs"] > 0
    assert rec["branches_differing"] <= 1e-5 * rec["leaky_inputs"]
    assert rec["worst_gap_same_branches"] < 1e-5
    assert rec["worst_gap_same_branches"] <= rec["worst_gap"]
