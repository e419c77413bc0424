"""The KGE numerics sentry against the JAX package's, on the CPU.

The port's 4-slot ``DistKGETrainer`` from the JAX ``DistKGETrainer``'s
state on ``make_mesh(num_dp=4)``: every update's stats as the monitors
see them, ``grad_norm`` and ``part_loss`` within 1e-5 relative and the
non-finite counts equal; the port's run with the sentry on equals its
run with it off bit for bit (losses and every table); a NaN entity row
faults the port at the JAX trainer's step and partition; and a rollback
quarantines the checkpoints at or past the fault and leaves the fault
marker.
"""

import jax
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import kge_sampler as jax_sampler
from dgl_operator_tpu.models import kge as jax_models
from dgl_operator_tpu.obs import quality as JQ
from dgl_operator_tpu.parallel import make_mesh
from dgl_operator_tpu.runtime import kge as jax_runtime
from dgl_operator_tpu_torch.graph import kge_sampler
from dgl_operator_tpu_torch.models.kge import kge_state_from_numpy
from dgl_operator_tpu_torch.obs import quality as Q
from dgl_operator_tpu_torch.runtime.checkpoint import CheckpointManager
from dgl_operator_tpu_torch.runtime.kge import DistKGETrainer
import torch_kge_mp_worker as worker

pytestmark = pytest.mark.quality

STATS_TOL = dict(rtol=1e-5, atol=0)
STATE = ("entity", "entity_state", "relation", "relation_state")


def _ready_pushes(monkeypatch):
    """The JAX trainer's tap, ready at every push. Its ``poll`` returns
    only the newest of the entries that ripen together, and a replicated
    loss can read back before every shard is ready, so on a loaded host
    it skips steps; ready at its push, it observes every step, as the
    port's loop does."""
    push = JQ.StatsTap.push

    def ready_push(self, step, loss, stats):
        jax.block_until_ready((loss, stats))
        push(self, step, loss, stats)

    monkeypatch.setattr(JQ.StatsTap, "push", ready_push)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ("TPU_OPERATOR_CHAOS", "TPU_OPERATOR_WORKSPACE",
                 "TPU_OPERATOR_TUNED_MANIFEST", "TPU_OPERATOR_RANK"):
        monkeypatch.delenv(name, raising=False)
    _ready_pushes(monkeypatch)


def _recorder(monkeypatch, cls):
    seen = []
    observe = cls.observe

    def wrapped(self, step, loss, stats=None):
        seen.append((int(step), float(loss), stats))
        return observe(self, step, loss, stats)

    monkeypatch.setattr(cls, "observe", wrapped)
    return seen


def _jax(ds, sd=None, **fields):
    cfg, tcfg = worker.configs(ds)
    jt = jax_runtime.DistKGETrainer(
        jax_models.KGEConfig(**vars(cfg)),
        jax_runtime.KGETrainConfig(**{
            **{k: getattr(tcfg, k) for k in (
                "lr", "max_step", "batch_size", "neg_sample_size",
                "neg_chunk_size", "log_interval", "seed")}, **fields}),
        make_mesh(num_dp=4))
    if sd is not None:
        jt.load_state_dict(sd)
    return jt


def _port(ds, sd, **fields):
    tr = DistKGETrainer(*worker.configs(ds, **fields), num_slots=4,
                        device="cpu")
    tr.load_state_dict(kge_state_from_numpy(sd))
    return tr


def _data(mod, ds):
    return mod.TrainDataset(ds.train, ds.n_entities, ds.n_relations,
                            ranks=4)


@pytest.fixture(scope="module")
def jax_stats():
    """The JAX trainer's initial state and the stats its monitor saw."""
    ds = worker.dataset()
    with pytest.MonkeyPatch.context() as mp:
        _ready_pushes(mp)
        seen = _recorder(mp, JQ.QualityMonitor)
        jt = _jax(ds)
        sd0 = jt.state_dict()
        jt.train(_data(jax_sampler, ds))
    return ds, sd0, seen


def test_stats_match_the_jax_trainer(jax_stats, monkeypatch):
    ds, sd0, want = jax_stats
    got = _recorder(monkeypatch, Q.QualityMonitor)
    _port(ds, sd0).train(_data(kge_sampler, ds))
    assert [s for s, _, _ in got] == [s for s, _, _ in want] == list(
        range(1, 7))
    for (step, loss, st), (_, jloss, jst) in zip(got, want):
        assert loss == pytest.approx(jloss, rel=1e-5)
        for k in ("grad_norm", "part_loss"):
            np.testing.assert_allclose(st[k], np.asarray(jst[k]),
                                       err_msg=f"{k} at step {step}",
                                       **STATS_TOL)
        assert st["part_loss"].shape == (4,)
        for k in ("nonfinite", "part_nonfinite"):
            assert np.asarray(st[k]).tolist() == np.asarray(
                jst[k]).tolist() == np.zeros_like(jst[k]).tolist()


def test_sentry_on_and_off_are_bit_equal(jax_stats):
    ds, sd0, _ = jax_stats
    runs = []
    for sentry in (False, True):
        tr = _port(ds, sd0, sentry=sentry)
        out = tr.train(_data(kge_sampler, ds))
        runs.append((out["losses"], tr.state_dict(), tr.last_stats))
    (l0, s0, st0), (l1, s1, st1) = runs
    assert l0 == l1
    assert all(np.array_equal(s0[k], s1[k]) for k in STATE)
    assert st0 is None and float(st1["grad_norm"]) > 0


def _nan_row(sd0, row):
    sd = {k: np.array(v, copy=True) for k, v in sd0.items()}
    sd["entity"][row] = np.nan
    return sd


def test_nan_entity_row_faults_at_the_jax_step(jax_stats):
    ds, sd0, _ = jax_stats
    sd = _nan_row(sd0, 17)
    jt = _jax(ds, sd, quality_action="halt")
    with pytest.raises(JQ.NumericsFault) as want:
        jt.train(_data(jax_sampler, ds))
    tr = _port(ds, sd, quality_action="halt")
    with pytest.raises(Q.NumericsFault) as got:
        tr.train(_data(kge_sampler, ds))
    assert (got.value.step, got.value.partition, got.value.kind) == (
        want.value.step, want.value.partition, want.value.kind)
    assert got.value.partition is not None


def test_rollback_quarantines_and_marks(jax_stats, tmp_path, monkeypatch):
    """The entity table turns NaN before update 4; checkpoints of every
    step: those at or past the fault go aside, step 3 survives."""
    ds, sd0, _ = jax_stats
    ws = tmp_path / "ws"
    ws.mkdir()
    monkeypatch.setenv(Q.WORKSPACE_ENV, str(ws))
    ckpt = str(tmp_path / "ckpt")
    tr = _port(ds, sd0, ckpt_dir=ckpt, ckpt_every=1)
    device_step = tr.device_step
    calls = []

    def poisoned(hs):
        calls.append(1)
        if len(calls) == 4:
            with torch.no_grad():
                tr.entity.fill_(float("nan"))
        return device_step(hs)

    tr.device_step = poisoned
    with pytest.raises(Q.NumericsFault) as got:
        tr.train(_data(kge_sampler, ds))
    assert got.value.step == 4
    assert CheckpointManager(ckpt).latest_step() == 3
    assert Q.take_fault_marker(str(ws))["step"] == 4
