"""The port's training checkpoints and resume.

``CheckpointManager`` against the JAX package's checkpoint contract
(the counterparts of ``tests/test_runtime.py``'s checkpoint tests), and
``SampledTrainer`` resume: with dropout 0 a run resumed at an epoch
boundary or mid-epoch equals the uninterrupted run bit for bit, and its
per-epoch losses match the JAX ``SampledTrainer``'s resumed run from
the same initial params and batch stream (rtol 1e-3). Both packages
sample with their C++ graph cores (``test_torch_native.use_jax_graphcore``).
"""

import os

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
from dgl_operator_tpu_torch.models.sage import DistSAGE, state_dict_to_flax
from dgl_operator_tpu_torch.obs import get_obs
from dgl_operator_tpu_torch.runtime.checkpoint import (CheckpointCorrupt,
                                                       CheckpointManager,
                                                       load_state_npz,
                                                       load_train_state,
                                                       save_state_npz,
                                                       train_state)
from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                 TrainConfig, resume_seed)
from test_torch_native import use_jax_graphcore

FEAT, HIDDEN, CLASSES = 12, 16, 4
FANOUTS = (3, 4)
BATCH = 32
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


def _npz(directory):
    return sorted(f for f in os.listdir(directory) if f.endswith(".npz"))


# -- CheckpointManager -------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_keep=2)
    state = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
             "b": np.float32(1.5)}
    for step in (3, 7, 9):
        mgr.save(step, state)
    assert mgr.latest_step() == 9
    like = {"w": np.zeros((2, 3), np.float32), "b": np.float32(0)}
    step, got = mgr.restore(None, like)
    assert step == 9
    np.testing.assert_array_equal(got["w"], state["w"])
    assert float(got["b"]) == 1.5
    # GC kept the newest two, each with its sidecar
    assert _npz(tmp_path) == ["ckpt_7.npz", "ckpt_9.npz"]
    assert os.path.exists(tmp_path / "ckpt_9.npz.sha256")
    step, got = mgr.restore(7, like)
    assert step == 7


def test_checkpoint_restore_many_leaves_by_name(tmp_path):
    """13 leaves come back under their names, whatever the order of
    the archive's members (lexicographic order puts leaf_10 before
    leaf_2)."""
    mgr = CheckpointManager(str(tmp_path))
    state = {f"leaf_{i}": np.full((2,), i, np.float32) for i in range(13)}
    mgr.save(1, state)
    like = {k: np.zeros((2,), np.float32) for k in state}
    step, got = mgr.restore(None, like)
    assert step == 1
    for k, v in state.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_checkpoint_async_save_and_error_surfacing(tmp_path):
    """wait=False saves land after close(); a failing background write
    re-raises on close instead of vanishing."""
    mgr = CheckpointManager(str(tmp_path / "ok"), max_keep=2)
    w = torch.arange(4, dtype=torch.float32)
    mgr.save(1, {"w": w}, wait=False)
    w += 10          # the save copied the leaves before returning
    mgr.save(2, {"w": w}, wait=False)   # joins save 1 first
    mgr.close()
    assert mgr.latest_step() == 2
    _, got = mgr.restore(1, {"w": torch.zeros(4)})
    assert torch.equal(got["w"], torch.arange(4, dtype=torch.float32))
    _, got = mgr.restore(None, {"w": torch.zeros(4)})
    assert torch.equal(got["w"], w)

    bad = CheckpointManager(str(tmp_path / "bad"), max_keep=2)
    os.rmdir(tmp_path / "bad")          # the writer meets a missing dir
    bad.save(1, {"w": w}, wait=False)
    with pytest.raises(OSError):
        bad.close()


def _stomp(path):
    with open(path, "r+b") as f:
        f.write(b"\x00CORRUPT\x00")


def test_corrupt_newest_falls_back_then_all_corrupt_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    like = {"w": np.zeros(3, np.float32)}
    mgr.save(1, {"w": np.ones(3, np.float32)})
    mgr.save(2, {"w": np.full(3, 2, np.float32)})
    _stomp(tmp_path / "ckpt_2.npz")
    fallbacks = get_obs().metrics.counter("ckpt_restore_fallback_total")
    before = fallbacks.value()
    step, got = mgr.restore(None, like)
    assert step == 1 and float(got["w"][0]) == 1.0
    assert fallbacks.value() == before + 1
    assert [e for e in get_obs().events
            if e["kind"] == "ckpt_restore_fallback" and e["step"] == 2]
    with pytest.raises(CheckpointCorrupt, match="sha256"):
        mgr.restore(2, like)
    _stomp(tmp_path / "ckpt_1.npz")
    with pytest.raises(CheckpointCorrupt, match="all 2 candidate"):
        mgr.restore(None, like)
    with pytest.raises(FileNotFoundError):
        mgr.restore(5, like)


def test_restore_refuses_another_skeleton(tmp_path):
    """A checkpoint whose leaves are not the skeleton's (another model)
    is corrupt for this state, not a partial restore."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": np.ones(3, np.float32)})
    with pytest.raises(CheckpointCorrupt, match="partial restore"):
        mgr.restore(None, {"w": np.zeros(3), "b": np.zeros(1)})
    with pytest.raises(CheckpointCorrupt, match="shapes"):
        mgr.restore(None, {"w": np.zeros(4)})
    assert mgr.restore(None, {"w": np.zeros(3, np.float32)})[0] == 1


def test_no_checkpoint_restores_nothing(tmp_path):
    like = {"w": np.zeros(2)}
    assert CheckpointManager(str(tmp_path)).restore(None, like) == (0, like)


def test_state_npz_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(3.0)},
             "opt": {"0": {"step": np.float32(4)}}}
    path = save_state_npz(str(tmp_path / "s" / "state.npz"), state)
    got = load_state_npz(path)
    np.testing.assert_array_equal(got["params"]["w"], [0.0, 1.0, 2.0])
    assert float(got["opt"]["0"]["step"]) == 4.0


def test_train_state_roundtrip_continues_adam_exactly():
    """Model and Adam state through a checkpoint tree: the next step
    from the restored state equals the next step of the original."""
    torch.manual_seed(0)
    x = torch.randn(8, 5)

    def make():
        m = torch.nn.Linear(5, 3)
        return m, torch.optim.Adam(m.parameters(), lr=0.01)

    def step(m, opt):
        opt.zero_grad()
        m(x).square().sum().backward()
        opt.step()

    m, opt = make()
    skeleton = train_state(m, opt)      # zero moments before any step
    assert set(skeleton["opt"]) == {"0", "1"}
    assert float(skeleton["opt"]["0"]["step"]) == 0.0
    for _ in range(3):
        step(m, opt)
    saved = {k: {n: v.clone() for n, v in d.items()} if k == "params"
             else {i: {n: t.clone() for n, t in s.items()}
                   for i, s in d.items()}
             for k, d in train_state(m, opt).items()}
    m2, opt2 = make()
    load_train_state(m2, opt2, saved)
    step(m, opt)
    step(m2, opt2)
    for a, b in zip(m.parameters(), m2.parameters()):
        assert torch.equal(a, b)


# -- SampledTrainer resume ---------------------------------------------
def _cfg(tmp_path, **kw):
    base = dict(num_epochs=2, batch_size=BATCH, fanouts=FANOUTS,
                eval_every=0, log_every=1000, dropout=0.0, seed=5,
                ckpt_dir=str(tmp_path), prefetch=0)
    base.update(kw)
    return TrainConfig(**base)


def _trainer(graph, cfg):
    model = DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.0, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    return SampledTrainer(model, graph, cfg, device="cpu")


def _assert_same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("where", ["epoch_boundary", "mid_epoch"])
def test_sampled_trainer_resume_is_bit_exact(port_graph, tmp_path, where):
    full = _trainer(port_graph, _cfg(tmp_path / "full", ckpt_dir=None))
    want = full.train()
    spe = len(full.train_ids) // BATCH
    assert want["step"] == 2 * spe and spe >= 3
    if where == "epoch_boundary":
        first = _trainer(port_graph, _cfg(tmp_path / "ck", num_epochs=1))
        assert first.train()["step"] == spe
        resume_at = spe
    else:
        # checkpoints every 2 steps; the run dies as it begins the step
        # after an even global step inside the second epoch
        resume_at = spe + 1 + (spe + 1) % 2
        first = _trainer(port_graph, _cfg(tmp_path / "ck", ckpt_every=2))
        step, taken = first.train_step, []

        def dying_step(mb):
            if len(taken) == resume_at:
                raise RuntimeError("killed")
            taken.append(1)
            return step(mb)

        first.train_step = dying_step
        with pytest.raises(RuntimeError, match="killed"):
            first.train()
        assert CheckpointManager(str(tmp_path / "ck")).latest_step() \
            == resume_at
    resumed = _trainer(port_graph, _cfg(tmp_path / "ck"))
    got = resumed.train()
    assert got["step"] == want["step"]
    _assert_same_state(got["params"], want["params"])
    # the resumed steps' losses are the uninterrupted run's last ones
    assert [h["epoch"] for h in got["history"]] == [1]
    assert got["history"][0]["losses"] == \
        want["history"][1]["losses"][resume_at - spe:]
    # nothing left: a third trainer restores the final step, trains none
    again = _trainer(port_graph, _cfg(tmp_path / "ck"))
    out = again.train()
    assert out["step"] == want["step"] and out["history"] == []
    _assert_same_state(out["params"], want["params"])


def test_resume_never_ignores_checkpoints(port_graph, tmp_path):
    _trainer(port_graph, _cfg(tmp_path, num_epochs=1)).train()
    assert CheckpointManager(str(tmp_path)).latest_step() > 0
    out = _trainer(port_graph, _cfg(tmp_path, num_epochs=1,
                                    resume="never")).train()
    fresh = _trainer(port_graph, _cfg(tmp_path / "x", num_epochs=1,
                                      ckpt_dir=None)).train()
    assert out["step"] == fresh["step"]
    assert out["history"][0]["losses"] == fresh["history"][0]["losses"]


def test_resume_reseeds_dropout_from_the_step():
    assert resume_seed(5, 12) == resume_seed(5, 12)
    assert len({resume_seed(5, 12), resume_seed(5, 13),
                resume_seed(6, 12)}) == 3


def _jax_cfg(tmp_path, num_epochs):
    return JaxTrainConfig(num_epochs=num_epochs, batch_size=BATCH,
                          fanouts=FANOUTS, eval_every=0, log_every=1000,
                          dropout=0.0, seed=5, prefetch=0, sentry=False,
                          ckpt_dir=str(tmp_path))


def test_resumed_losses_match_jax_resumed_run(port_graph, tmp_path):
    """Both packages train one epoch with checkpoints, then a fresh
    trainer of each resumes to three epochs: the resumed epochs' losses
    and the final params agree."""
    g = jax_datasets.synthetic_node_clf(**_graph_args()).graph

    def jax_trainer(n):
        return JaxSampledTrainer(
            JaxDistSAGE(hidden_feats=HIDDEN, out_feats=CLASSES,
                        dropout=0.0), g, _jax_cfg(tmp_path / "jax", n))

    first = jax_trainer(1)
    mb = first.sample(first.train_ids[:BATCH], 0)
    init = jax.device_get(first.model.init(
        jax.random.PRNGKey(5), mb.blocks,
        first.feats[jnp.asarray(mb.input_nodes)], train=False))
    first.train()
    want = jax_trainer(3).train()

    _trainer(port_graph, _cfg(tmp_path / "port", num_epochs=1)).train(
        init_params=init)
    got = _trainer(port_graph, _cfg(tmp_path / "port", num_epochs=3)).train()
    assert got["step"] == want["step"]
    assert [h["epoch"] for h in got["history"]] == \
        [h["epoch"] for h in want["history"]] == [1, 2]
    for g_rec, w_rec in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g_rec["loss"], w_rec["loss"], **TRAIN_TOL)
    final = state_dict_to_flax(got["params"])["params"]
    ref = jax.device_get(want["params"])["params"]
    for layer, subs in final.items():
        for sub, leaves in subs.items():
            for leaf, value in leaves.items():
                np.testing.assert_allclose(
                    value, np.asarray(ref[layer][sub][leaf]),
                    err_msg=f"{layer}/{sub}/{leaf}", **TRAIN_TOL)
