"""The port's checkpoint fences, quarantine and serving promotion
against the JAX package's.

Mirrors the JAX package's fenced-checkpoint tests (epoch directories,
the zombie refused at open and at publish, the epoch taken from the
elastic launcher's env), its quarantine test, and its promotion flow
(stage, commit, rollback, a concurrent promoter's fence race). The
fence files are the JAX package's format: each package's ``read_fence``
and ``promotion_history`` read the other's ``fence.json`` and
``promotion.json``.
"""

import os

import numpy as np
import pytest

from dgl_operator_tpu.runtime import checkpoint as jax_ckpt
from dgl_operator_tpu_torch.obs import get_obs
from dgl_operator_tpu_torch.parallel.bootstrap import FENCE_EPOCH_ENV
from dgl_operator_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                       FencedOut,
                                                       ServingPromotion,
                                                       load_params,
                                                       promotion_history,
                                                       read_fence)


def _state(v: float) -> dict:
    return {"w": np.full((3, 2), v, np.float32),
            "b": np.arange(4, dtype=np.float32) + v}


def test_fence_epoch_dirs_and_cross_epoch_restore(tmp_path):
    mgr0 = CheckpointManager(str(tmp_path), fence_epoch=0)
    mgr0.save(3, _state(1), wait=True)
    assert os.path.exists(tmp_path / "epoch-0" / "ckpt_3.npz")
    # the next incarnation restores the previous epoch's checkpoint
    mgr1 = CheckpointManager(str(tmp_path), fence_epoch=1)
    assert mgr1.latest_step() == 3
    step, got = mgr1.restore(None, _state(0))
    assert step == 3 and np.array_equal(got["w"], _state(1)["w"])
    mgr1.save(5, _state(2), wait=True)
    assert os.path.exists(tmp_path / "epoch-1" / "ckpt_5.npz")
    assert CheckpointManager(str(tmp_path)).latest_step() == 5
    # an older epoch's checkpoint outranks nothing: epoch 1's step 5
    # stays the newest after epoch 0's directory gains a higher step
    (tmp_path / "epoch-0" / "ckpt_9.npz").write_bytes(
        (tmp_path / "epoch-0" / "ckpt_3.npz").read_bytes())
    assert CheckpointManager(str(tmp_path)).latest_step() == 5


def test_zombie_publication_rejected_by_fence(tmp_path):
    """A trainer of epoch N-1 waking after a newer incarnation claimed
    the directory fails to publish, and the newer state survives; it
    cannot even open against the newer fence."""
    zombie = CheckpointManager(str(tmp_path), fence_epoch=1)
    zombie.save(5, _state(1), wait=True)
    newer = CheckpointManager(str(tmp_path), fence_epoch=2)
    newer.save(7, _state(2), wait=True)
    rejections = get_obs().metrics.counter("ckpt_fence_rejections_total")
    c0 = rejections.value()
    with pytest.raises(FencedOut):
        zombie.save(9, _state(99), wait=True)
    assert rejections.value() == c0 + 1
    assert not os.path.exists(tmp_path / "epoch-1" / "ckpt_9.npz")
    step, got = CheckpointManager(str(tmp_path)).restore(None, _state(0))
    assert step == 7 and np.array_equal(got["w"], _state(2)["w"])
    with pytest.raises(FencedOut):
        CheckpointManager(str(tmp_path), fence_epoch=1)
    # an asynchronous zombie publish surfaces at close
    twin = CheckpointManager(str(tmp_path), fence_epoch=2)
    newer.save(11, _state(3), wait=False)
    with pytest.raises(FencedOut):
        newer.close()
    twin.save(12, _state(4), wait=True)
    assert CheckpointManager(str(tmp_path)).latest_step() == 12


def test_fence_epoch_adopted_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv(FENCE_EPOCH_ENV, "3")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.fence_epoch == 3
    mgr.save(1, _state(1), wait=True)
    assert os.path.exists(tmp_path / "epoch-3" / "ckpt_1.npz")
    assert read_fence(str(tmp_path))["epoch"] == 3
    assert jax_ckpt.read_fence(str(tmp_path))["epoch"] == 3


@pytest.mark.parametrize("fence_epoch", [None, 2])
def test_quarantine_rolls_back_to_last_known_good(tmp_path, fence_epoch):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), fence_epoch=fence_epoch)
    for s in (2, 4, 6):
        mgr.save(s, _state(s), wait=s != 6)
    # step 6's write is still in the background: the quarantine drains
    # it before it moves anything
    assert mgr.quarantine_from(5) == 4
    d = mgr._active_dir
    bad = sorted(fn for fn in os.listdir(d) if fn.endswith(".bad"))
    assert bad == ["ckpt_6.npz.bad", "ckpt_6.npz.sha256.bad"]
    step, got = mgr.restore(None, _state(0))
    assert step == 4 and np.array_equal(got["b"], _state(4)["b"])
    ev = [e for e in get_obs().events if e["kind"] == "ckpt_quarantined"]
    assert ev[-1]["steps"] == [6] and ev[-1]["rolled_back_to"] == 4
    assert mgr.quarantine_from(1) is None


def _params(v: float) -> dict:
    return {"params": {"FanoutSAGEConv_0": {
        "self": {"kernel": np.full((3, 2), v, np.float32)}}}}


def test_serving_promotion_stage_commit_rollback(tmp_path):
    promo = ServingPromotion(str(tmp_path))
    assert promo.incumbent_epoch == 0 and read_fence(str(tmp_path)) is None
    # a rolled-back candidate leaves the fence and the live export alone
    bad = promo.stage(_params(np.nan))
    cand_dir = os.path.dirname(bad)
    assert os.path.basename(cand_dir) == "candidate-epoch-1"
    assert np.isnan(load_params(bad)["params"]["FanoutSAGEConv_0"]
                    ["self"]["kernel"]).all()
    promo.rollback(reason="nonfinite")
    assert os.path.isdir(cand_dir + ".bad") and not os.path.isdir(cand_dir)
    assert read_fence(str(tmp_path)) is None
    assert not os.path.exists(tmp_path / "serving_params.npz")
    # a clean candidate commits at epoch 1
    promo.stage(_params(1.0))
    live = promo.commit()
    assert live == str(tmp_path / "serving_params.npz")
    assert read_fence(str(tmp_path))["epoch"] == 1
    assert promo.incumbent_epoch == 1
    np.testing.assert_array_equal(
        load_params(live)["params"]["FanoutSAGEConv_0"]["self"]["kernel"],
        np.full((3, 2), 1.0, np.float32))
    assert [h["action"] for h in promotion_history(str(tmp_path))] == [
        "rolled_back", "promoted"]
    with pytest.raises(RuntimeError, match="no candidate"):
        promo.commit()


def test_promotion_fence_race_raises_fenced_out(tmp_path):
    """Two promoters stage epoch 1; the first commit wins the fence and
    the second is refused."""
    a, b = ServingPromotion(str(tmp_path)), ServingPromotion(str(tmp_path))
    a.stage(_params(1.0))
    b.stage(_params(2.0))
    a.commit()
    with pytest.raises(FencedOut, match="concurrent promoter"):
        b.commit()
    assert read_fence(str(tmp_path))["epoch"] == 1


def test_fence_files_read_across_packages(tmp_path):
    """Each package reads the other's fence.json and promotion.json."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    p = ServingPromotion(str(port_dir))
    p.stage(_params(1.0))
    p.rollback(reason="divergence")
    p.stage(_params(2.0))
    p.commit()
    j = jax_ckpt.ServingPromotion(str(jax_dir))
    j.stage(_params(3.0))
    j.commit()
    j.stage(_params(4.0))
    j.rollback(reason="nonfinite")
    for d in (port_dir, jax_dir):
        assert read_fence(str(d)) == jax_ckpt.read_fence(str(d))
        assert read_fence(str(d))["epoch"] == 1
        assert promotion_history(str(d)) == jax_ckpt.promotion_history(
            str(d))
    assert [h["action"] for h in jax_ckpt.promotion_history(
        str(port_dir))] == ["rolled_back", "promoted"]
    assert [h["action"] for h in promotion_history(str(jax_dir))] == [
        "promoted", "rolled_back"]
    # a promoter of either package takes the other's incumbent epoch,
    # and the other's live export loads
    assert ServingPromotion(str(jax_dir)).incumbent_epoch == 1
    assert jax_ckpt.ServingPromotion(str(port_dir)).incumbent_epoch == 1
    np.testing.assert_array_equal(
        load_params(str(jax_dir))["params"]["FanoutSAGEConv_0"]["self"]
        ["kernel"], np.full((3, 2), 3.0, np.float32))
    # the port's trainer fence, read by the JAX package, and back
    CheckpointManager(str(tmp_path / "ckpt"), fence_epoch=4)
    assert jax_ckpt.read_fence(str(tmp_path / "ckpt"))["epoch"] == 4
    jax_ckpt.CheckpointManager(str(tmp_path / "ckpt"), use_orbax=False,
                               fence_epoch=5)
    with pytest.raises(FencedOut):
        CheckpointManager(str(tmp_path / "ckpt"), fence_epoch=4)
