"""Port layers and model vs flax, and serving exports across packages.

Flax params come from ``model.init`` (biases perturbed so they count),
go through ``state_dict_from_flax``, and the port's forward must match
flax's to 1e-4 on the same padded blocks and input rows. Exports
written by either package's ``export_for_serving`` load in the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph.blocks import FanoutBlock as JaxFanoutBlock
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.nn.conv import FanoutSAGEConv as JaxFanoutSAGEConv
from dgl_operator_tpu.runtime import checkpoint as jax_ckpt
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.blocks import (build_fanout_blocks,
                                                 pad_minibatch)
from dgl_operator_tpu_torch.models.sage import (DistSAGE,
                                                state_dict_from_flax,
                                                state_dict_to_flax)
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
