"""Port layers and model vs flax, and serving exports across packages.

Flax params come from ``model.init`` (biases perturbed so they count),
go through ``state_dict_from_flax``, and the port's forward, its
parameter gradients (dropout 0) and its full-graph ``sage_inference``
must match flax's to 1e-4 on the same inputs. Dropout is seeded by a
``torch.Generator``. Exports written by either package's
``export_for_serving`` load in the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph.blocks import FanoutBlock as JaxFanoutBlock
from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.models.sage import \
    sage_inference as jax_sage_inference
from dgl_operator_tpu.nn.conv import FanoutSAGEConv as JaxFanoutSAGEConv
from dgl_operator_tpu.runtime import checkpoint as jax_ckpt
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.blocks import (build_fanout_blocks,
                                                 pad_minibatch)
from dgl_operator_tpu_torch.models.sage import (DistSAGE, sage_inference,
                                                state_dict_from_flax,
                                                state_dict_to_flax)
from dgl_operator_tpu_torch.models.sage import dropout as sage_dropout
from dgl_operator_tpu_torch.nn.conv import FanoutSAGEConv
from dgl_operator_tpu_torch.runtime import checkpoint

# float32 forward through two matmuls of width <= 32 plus a fanout
# reduction, summed in another order than XLA's
TOL = dict(rtol=1e-4, atol=1e-4)
IN, HIDDEN, OUT = 12, 16, 5
FANOUTS = (3, 4)
BATCH = 8


@pytest.fixture(scope="module")
def batch():
    """One padded two-layer minibatch and its input rows."""
    ds = datasets.synthetic_node_clf(200, 900, IN, OUT, seed=4)
    csc = ds.graph.csc()
    seeds = np.arange(BATCH, dtype=np.int64)
    mb = build_fanout_blocks(csc, seeds, FANOUTS, seed=5)
    mb = pad_minibatch(mb, BATCH, FANOUTS, ds.graph.num_nodes)
    h = ds.graph.ndata["feat"][mb.input_nodes].astype(np.float32)
    return mb, h


def _jax_blocks(mb):
    return [JaxFanoutBlock(jnp.asarray(b.nbr), jnp.asarray(b.mask),
                           b.num_src) for b in mb.blocks]


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))
        .astype(np.float32), params)


@pytest.mark.parametrize("aggregator", ["mean", "sum", "pool"])
def test_fanout_sage_conv_matches_flax(batch, aggregator):
    mb, h = batch
    blk = mb.blocks[0]
    jblk = _jax_blocks(mb)[0]
    conv = JaxFanoutSAGEConv(7, aggregator=aggregator)
    params = _perturbed(conv.init(jax.random.PRNGKey(1), jblk,
                                  jnp.asarray(h)), 2)
    want = np.asarray(conv.apply(params, jblk, jnp.asarray(h)))
    sd = state_dict_from_flax({"params": {"FanoutSAGEConv_0":
                                          params["params"]}})
    port = FanoutSAGEConv(IN, 7, aggregator, device="cpu")
    port.load_state_dict({k[len("layers.0."):]: v for k, v in sd.items()})
    got = port(blk, torch.from_numpy(h)).detach().numpy()
    assert got.shape == want.shape == (blk.num_dst, 7)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("aggregator", ["mean", "sum", "pool"])
def test_dist_sage_matches_flax(batch, aggregator):
    mb, h = batch
    model = JaxDistSAGE(hidden_feats=HIDDEN, out_feats=OUT,
                        aggregator=aggregator, dropout=0.0)
    jblocks = _jax_blocks(mb)
    params = _perturbed(model.init(jax.random.PRNGKey(0), jblocks,
                                   jnp.asarray(h)), 3)
    want = np.asarray(model.apply(params, jblocks, jnp.asarray(h),
                                  train=False))
    port = DistSAGE(IN, HIDDEN, OUT, aggregator=aggregator, device="cpu")
    port.load_state_dict(state_dict_from_flax(params))
    port.eval()     # flax ran with train=False: no dropout
    with torch.inference_mode():
        got = port(mb.blocks, torch.from_numpy(h)).numpy()
    assert got.shape == want.shape == (BATCH, OUT)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_state_dict_flax_round_trip():
    port = DistSAGE(IN, HIDDEN, OUT, aggregator="pool", device="cpu",
                    generator=torch.Generator().manual_seed(9))
    tree = state_dict_to_flax(port.state_dict())
    assert tree["params"]["FanoutSAGEConv_0"]["self"]["kernel"].shape \
        == (IN, HIDDEN)
    assert "bias" not in tree["params"]["FanoutSAGEConv_1"]["neigh"]
    back = state_dict_from_flax(tree)
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k


def test_same_seed_same_weights_and_device_is_required(monkeypatch):
    a = DistSAGE(IN, HIDDEN, OUT, device="cpu",
                 generator=torch.Generator().manual_seed(1))
    b = DistSAGE(IN, HIDDEN, OUT, device="cpu",
                 generator=torch.Generator().manual_seed(1))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistSAGE(IN, HIDDEN, OUT)


def _flax_params():
    model = JaxDistSAGE(hidden_feats=HIDDEN, out_feats=OUT, dropout=0.0)
    blk = JaxFanoutBlock(jnp.zeros((2, 3), jnp.int32),
                         jnp.ones((2, 3), jnp.float32), 4)
    return jax.device_get(model.init(jax.random.PRNGKey(0), [blk, blk],
                                     jnp.ones((4, IN))))


def test_jax_export_loads_in_port_with_verified_sidecar(tmp_path):
    params = _flax_params()
    path = jax_ckpt.export_for_serving(str(tmp_path) + "/", params)
    tree = checkpoint.load_params(str(tmp_path))
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    # a torn export is refused
    with open(path, "r+b") as f:
        f.seek(-8, 2)
        f.write(b"\0" * 8)
    with pytest.raises(checkpoint.CheckpointCorrupt):
        checkpoint.load_params(path)


def test_port_export_loads_in_jax(tmp_path):
    port = DistSAGE(IN, HIDDEN, OUT, device="cpu")
    tree = state_dict_to_flax(port.state_dict())
    path = checkpoint.export_for_serving(str(tmp_path / "s.npz"), tree)
    back = jax_ckpt.load_params(path)
    np.testing.assert_array_equal(
        back["params"]["FanoutSAGEConv_1"]["self"]["kernel"],
        port.layers[1].self.weight.detach().numpy().T)
    sd = state_dict_from_flax(back)
    for k, v in port.state_dict().items():
        assert torch.equal(sd[k], v), k


# -- training: gradients, dropout, full-graph inference ----------------

@pytest.mark.parametrize("aggregator", ["mean", "sum", "pool"])
def test_dist_sage_grads_match_flax(batch, aggregator):
    """Every parameter's gradient of a masked cross-entropy equals
    ``jax.grad`` through the flax model (dropout 0). The first layer's
    input needs no gradient, so only the second layer's aggregation
    runs its backward, and its input gets the gradients of both the
    prefix slice and the aggregation."""
    mb, h = batch
    model = JaxDistSAGE(hidden_feats=HIDDEN, out_feats=OUT,
                        aggregator=aggregator, dropout=0.0)
    jblocks = _jax_blocks(mb)
    params = _perturbed(model.init(jax.random.PRNGKey(0), jblocks,
                                   jnp.asarray(h)), 4)
    labels = np.random.default_rng(0).integers(0, OUT, size=BATCH)

    def jax_loss(p):
        logits = model.apply(p, jblocks, jnp.asarray(h), train=True)
        logp = jax.nn.log_softmax(logits)
        return -logp[jnp.arange(BATCH), labels].mean()

    want = state_dict_from_flax(jax.device_get(jax.grad(jax_loss)(params)))
    port = DistSAGE(IN, HIDDEN, OUT, aggregator=aggregator, dropout=0.0,
                    device="cpu")
    port.load_state_dict(state_dict_from_flax(params))
    logits = port(mb.blocks, torch.from_numpy(h))
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(labels)).backward()
    got = dict(port.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), w.numpy(),
                                   err_msg=name, **TOL)


def test_dropout_is_seeded_train_only_and_keep_scaled(batch):
    mb, h = batch
    x = torch.from_numpy(h)
    port = DistSAGE(IN, HIDDEN, OUT, dropout=0.5, device="cpu")

    def run(seed):
        return port(mb.blocks, x,
                    generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    port.eval()
    plain = port(mb.blocks, x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(plain, port(mb.blocks, x))
    assert not torch.equal(plain, a)
    # kept elements are scaled by 1 / (1 - p), the rest are zero
    y = torch.rand(2000) + 0.5
    out = sage_dropout(y, 0.25, torch.Generator().manual_seed(0))
    kept = out != 0
    torch.testing.assert_close(out[kept], y[kept] / 0.75)
    assert 0.7 < float(kept.float().mean()) < 0.8
    with pytest.raises(ValueError):
        DistSAGE(IN, HIDDEN, OUT, dropout=1.0, device="cpu")


@pytest.mark.parametrize("aggregator", ["mean", "sum"])
def test_sage_inference_matches_jax(aggregator):
    ds = datasets.synthetic_node_clf(150, 700, IN, OUT, seed=8)
    jg = jax_datasets.synthetic_node_clf(150, 700, IN, OUT, seed=8).graph
    model = JaxDistSAGE(hidden_feats=HIDDEN, out_feats=OUT,
                        aggregator=aggregator, dropout=0.0)
    blk = JaxFanoutBlock(jnp.zeros((2, 3), jnp.int32),
                         jnp.ones((2, 3), jnp.float32), 4)
    params = _perturbed(model.init(jax.random.PRNGKey(3), [blk, blk],
                                   jnp.ones((4, IN))), 5)
    x = ds.graph.ndata["feat"]
    want = jax_sage_inference(params, jg.to_device(), jnp.asarray(x), 2,
                              aggregator)
    port = DistSAGE(IN, HIDDEN, OUT, aggregator=aggregator, device="cpu")
    port.load_state_dict(state_dict_from_flax(params))
    with torch.no_grad():
        got = sage_inference(port, ds.graph, torch.from_numpy(x))
    assert got.shape == (150, OUT) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sage_inference_pool_is_not_ported():
    ds = datasets.synthetic_node_clf(50, 200, IN, OUT, seed=1)
    port = DistSAGE(IN, HIDDEN, OUT, aggregator="pool", device="cpu")
    with pytest.raises(NotImplementedError):
        sage_inference(port, ds.graph,
                       torch.from_numpy(ds.graph.ndata["feat"]))
