"""The port's numerics sentry against the JAX package's.

Both packages run in one process on the same numpy inputs:
``grad_stats`` and ``dp_slot_stats`` agree within rtol 1e-6; the two
``QualityMonitor``s give the same verdicts and detector events on the
same synthetic streams (NaN attribution, divergence and explosion
rising edges, plateau, ``warn``); ``StatsTap`` delays, bounds its lag
and drains; the fault marker round-trips. The trainers: with the
sentry on and off ``SampledTrainer`` (host and device sampler, K = 1
and 4) and ``DistTrainer`` (both layouts) train bit-identically; NaN
feature rows make the port and the JAX trainer fault at the same
global step with the host sampler over the shared C++ graph core (and
name the same partition under ``DistTrainer``); ``halt_for_rollback``
quarantines and leaves the marker, and a resume from the survivor with
the rows restored completes the epoch.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph.partition import partition_graph
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.obs import obs_run
from dgl_operator_tpu.obs import quality as JQ
from dgl_operator_tpu.parallel import make_mesh
from dgl_operator_tpu.runtime import DistTrainer as JaxDistTrainer
from dgl_operator_tpu.runtime import SampledTrainer as JaxSampledTrainer
from dgl_operator_tpu.runtime import TrainConfig as JaxTrainConfig
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.obs import get_obs
from dgl_operator_tpu_torch.obs import quality as Q
from dgl_operator_tpu_torch.runtime.checkpoint import CheckpointManager
from dgl_operator_tpu_torch.runtime.dist import DistTrainer
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig
from test_torch_native import use_jax_graphcore

FEAT, HIDDEN, CLASSES = 12, 16, 4
STATS_TOL = dict(rtol=1e-6, atol=0)
DETECTOR_EVENTS = ("numerics_fault", "loss_divergence", "grad_explosion",
                   "loss_plateau")


@pytest.fixture(autouse=True)
def jax_library(monkeypatch, tmp_path_factory):
    use_jax_graphcore(monkeypatch, tmp_path_factory)
    monkeypatch.delenv("TPU_OPERATOR_TUNED_MANIFEST", raising=False)
    monkeypatch.delenv("TPU_OPERATOR_WORKSPACE", raising=False)
    monkeypatch.delenv("TPU_OPERATOR_CHAOS", raising=False)
    monkeypatch.delenv("TPU_OPERATOR_RANK", raising=False)


# ---------------------------------------------------------------------
# in-step stats
# ---------------------------------------------------------------------
def _leaves(rng, poison=0):
    shapes = [(7, 5), (5,), (5, 3), (3,)]
    out = [rng.normal(size=s).astype(np.float32) for s in shapes]
    flat = out[0].reshape(-1)
    flat[:poison] = np.nan
    if poison:
        out[2][0, 0] = np.inf
    return out


@pytest.mark.parametrize("poison", [0, 3])
def test_grad_stats_match_jax(poison):
    rng = np.random.default_rng(poison)
    grads, updates, params = (_leaves(rng, poison), _leaves(rng),
                              _leaves(rng))
    loss = np.float32(np.nan if poison else 0.75)
    want = JQ.grad_stats(jnp.asarray(loss), [jnp.asarray(g) for g in grads],
                         [jnp.asarray(u) for u in updates],
                         [jnp.asarray(p) for p in params])
    got = Q.grad_stats(torch.tensor(loss),
                       *[[torch.from_numpy(a) for a in t]
                         for t in (grads, updates, params)])
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, equal_nan=True, **STATS_TOL)
    assert int(got["nonfinite"]) == (poison + 2 if poison else 0)


@pytest.mark.parametrize("poison", [0, 2])
def test_dp_slot_stats_match_jax(poison):
    rng = np.random.default_rng(10 + poison)
    raw, reduced, updates, params = (_leaves(rng, poison), _leaves(rng),
                                     _leaves(rng), _leaves(rng))
    loss = np.float32(1.25)
    j = [[jnp.asarray(a) for a in t] for t in (raw, reduced, updates,
                                                params)]
    want = JQ.dp_slot_stats(jnp.asarray(loss), *j)
    got = Q.dp_slot_stats(torch.tensor(loss),
                          *[[torch.from_numpy(a) for a in t]
                            for t in (raw, reduced, updates, params)])
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **STATS_TOL)
    assert got["part_nonfinite"].tolist() == [poison + 1 if poison else 0]


# ---------------------------------------------------------------------
# the monitor: the same verdicts and events as the JAX monitor
# ---------------------------------------------------------------------
def _stats(gnorm=1.0, nonfin=0, part_nonfin=(0, 0), part_loss=(0.5, 0.5)):
    return {"grad_norm": np.float32(gnorm), "param_norm": np.float32(3.0),
            "update_ratio": np.float32(1e-3),
            "nonfinite": np.int32(nonfin),
            "part_nonfinite": np.asarray(part_nonfin, np.int32),
            "part_loss": np.asarray(part_loss, np.float32)}


def _streams():
    flat = [(i, 0.7, _stats()) for i in range(12)]
    return {
        "nan_attribution": (dict(action="halt", parts=[4, 7]),
                            [(12, 0.5, _stats(nonfin=3,
                                              part_nonfin=(0, 3)))]),
        "nan_part_loss": (dict(action="rollback", parts=[2, 5]),
                          [(3, 0.5, _stats(nonfin=1,
                                           part_loss=(0.5, np.nan)))]),
        "nan_loss_single_part": (dict(action="halt", parts=[3]),
                                 [(5, float("nan"), None)]),
        "warn": (dict(action="warn", parts=[0]),
                 [(5, float("inf"), _stats(nonfin=1)), (6, 0.5, _stats())]),
        "divergence": (dict(action="warn", window=8, z_max=4.0),
                       [(i, 1.0 + 0.01 * (i % 3), _stats())
                        for i in range(20)]
                       + [(20, 50.0, _stats()), (21, 55.0, _stats())]),
        "explosion": (dict(action="warn", window=8, grad_ratio_max=10.0),
                      [(i, 1.0, _stats(gnorm=1.0 + 0.01 * i))
                       for i in range(10)]
                      + [(10, 1.0, _stats(gnorm=500.0)),
                         (11, 1.0, _stats(gnorm=1.0))]),
        "plateau": (dict(action="warn", plateau_window=6, plateau_rel=1e-3),
                    flat),
    }


def _run_monitor(make, stream):
    mon, verdicts, fault = make(), [], None
    for rec in stream:
        try:
            verdicts.append(mon.observe(*rec))
        except (Q.NumericsFault, JQ.NumericsFault) as exc:
            fault = (exc.step, exc.partition, exc.kind)
            break
    return verdicts, fault, mon.last


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (np.isnan(a) and np.isnan(b)) or a == b
    return a == b


@pytest.mark.parametrize("name", sorted(_streams()))
def test_monitor_verdicts_match_jax(name, tmp_path):
    kw, stream = _streams()[name]
    with obs_run(str(tmp_path / "obs"), role="test", console=False):
        want = _run_monitor(lambda: JQ.QualityMonitor(**kw), stream)
        with open(tmp_path / "obs" / "events.jsonl") as f:
            jax_events = [(e["event"], e["step"]) for e in map(json.loads, f)
                          if e["event"] in DETECTOR_EVENTS]
    n0 = len(get_obs().events)
    got = _run_monitor(lambda: Q.QualityMonitor(**kw), stream)
    events = [(e["kind"], e["step"]) for e in list(get_obs().events)[n0:]
              if e["kind"] in DETECTOR_EVENTS]
    assert got[1] == want[1]
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0] + [got[2]], want[0] + [want[2]]):
        assert g.keys() == w.keys()
        assert all(_same(g[k], w[k]) for k in g), (g, w)
    assert events == jax_events and events


# ---------------------------------------------------------------------
# the tap and the marker
# ---------------------------------------------------------------------
def test_stats_tap_delay_max_lag_and_drain(monkeypatch):
    tap = Q.StatsTap(delay=1)
    tap.push(1, torch.tensor([0.4, 0.5]), None)
    assert tap.poll() is None            # one entry: not ripe
    stats = {"grad_norm": torch.tensor(2.0),
             "nonfinite": torch.tensor(3),
             "part_nonfinite": torch.tensor([0.0, 3.0])}
    tap.push(2, torch.tensor(0.6), stats)
    step, loss, got = tap.poll()
    assert (step, got) == (1, None) and loss == pytest.approx(0.5)
    step, loss, got = tap.drain()        # the held entry too
    assert step == 2 and loss == pytest.approx(0.6)
    assert got["grad_norm"] == 2.0 and got["nonfinite"] == 3
    assert got["part_nonfinite"].tolist() == [0, 3]
    assert got["part_nonfinite"].dtype == np.int64
    assert tap.drain() is None
    # an entry whose copy has not landed waits, until max_lag forces it
    tap = Q.StatsTap(delay=1, max_lag=3)
    monkeypatch.setattr(Q._Entry, "ready", lambda self: False)
    for s in (1, 2, 3):
        tap.push(s, torch.tensor(float(s)), None)
        assert tap.poll() is None
    tap.push(4, torch.tensor(4.0), None)
    assert tap.poll()[0] == 1            # past max_lag: the oldest
    assert tap.poll() is None
    assert tap.drain()[0] == 4


def test_fault_marker_roundtrip(tmp_path, monkeypatch):
    ws = tmp_path / "ws"
    ws.mkdir()
    monkeypatch.setenv(Q.WORKSPACE_ENV, str(ws))
    fault = Q.NumericsFault("boom", 9, partition=2, kind="nonfinite_grad")
    path = Q.write_fault_marker(fault)
    assert path and os.path.exists(path)
    # the JAX package's launcher reads the port's marker, and back
    assert JQ.take_fault_marker(str(ws))["step"] == 9
    JQ.write_fault_marker(JQ.NumericsFault("x", 4, partition=1))
    rec = Q.take_fault_marker(str(ws))
    assert rec["step"] == 4 and rec["partition"] == 1
    assert Q.take_fault_marker(str(ws)) is None


def test_halt_for_rollback_quarantines_and_marks(tmp_path, monkeypatch):
    ws = tmp_path / "ws"
    ws.mkdir()
    monkeypatch.setenv(Q.WORKSPACE_ENV, str(ws))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, {"w": np.ones(2, np.float32)})
    mgr.save(8, {"w": np.ones(2, np.float32)})
    fault = Q.NumericsFault("boom", 7, partition=1)
    with pytest.raises(Q.NumericsFault):
        Q.halt_for_rollback(fault, ckpt=mgr, action="rollback")
    assert mgr.latest_step() == 2
    assert Q.take_fault_marker(str(ws))["step"] == 7
    mgr.save(9, {"w": np.ones(2, np.float32)})
    with pytest.raises(Q.NumericsFault):
        Q.halt_for_rollback(fault, ckpt=mgr, action="halt")
    assert mgr.latest_step() == 9
    assert Q.take_fault_marker(str(ws)) is None


def test_train_config_validates_the_quality_knobs():
    cfg = TrainConfig()
    assert (cfg.sentry, cfg.quality_action, cfg.quality_window,
            cfg.quality_z_max, cfg.quality_grad_ratio_max,
            cfg.quality_plateau_window, cfg.quality_plateau_rel) == (
        JaxTrainConfig().sentry, "rollback", 32, 6.0, 50.0, 0, 1e-3)
    for field, value in (("quality_action", "explode"),
                         ("quality_window", 1), ("quality_z_max", -1.0),
                         ("sentry", "yes")):
        with pytest.raises(ValueError):
            TrainConfig(**{field: value})


# ---------------------------------------------------------------------
# the trainers: bit-identical with the sentry on and off
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def small_graph():
    # 300 nodes: 7 steps an epoch of 24 seeds, so K = 4 leaves a tail
    return datasets.synthetic_node_clf(300, 1500, FEAT, CLASSES,
                                       seed=11).graph


def _params_equal(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("sampler,k", [("host", 1), ("host", 4),
                                       ("device", 1), ("device", 4)])
def test_sampled_trainer_sentry_is_bit_identical(small_graph, sampler, k):
    runs = []
    for sentry in (False, True):
        model = DistSAGE(FEAT, HIDDEN, CLASSES, device="cpu",
                         generator=torch.Generator().manual_seed(2))
        cfg = TrainConfig(num_epochs=2, batch_size=24, fanouts=(3, 4),
                          eval_every=0, log_every=1000, dropout=0.5, seed=5,
                          prefetch=1, sampler=sampler, steps_per_call=k,
                          sentry=sentry)
        tr = SampledTrainer(model, small_graph, cfg, device="cpu")
        out = tr.train()
        runs.append(([x for r in out["history"] for x in r["losses"]],
                     out["params"], tr.last_stats))
    (l0, p0, s0), (l1, p1, s1) = runs
    assert l0 == l1 and _params_equal(p0, p1)
    assert s0 is None and set(s1) == set(Q.STAT_KEYS)
    assert int(s1["nonfinite"]) == 0 and float(s1["grad_norm"]) > 0


@pytest.fixture(scope="module")
def book4(tmp_path_factory):
    g = datasets.synthetic_node_clf(800, 4000, 16, CLASSES, seed=3).graph
    from dgl_operator_tpu_torch.graph.partition import \
        partition_graph as port_partition
    return port_partition(g, "synth", 4, str(tmp_path_factory.mktemp("q4")))


@pytest.mark.parametrize("layout", ["replicated", "owner"])
@pytest.mark.parametrize("sampler,k", [("host", 1), ("device", 4)])
def test_dist_trainer_sentry_is_bit_identical(book4, layout, sampler, k):
    runs = []
    for sentry in (False, True):
        model = DistSAGE(16, 32, CLASSES, dropout=0.0, device="cpu",
                         generator=torch.Generator().manual_seed(4))
        cfg = TrainConfig(num_epochs=1, batch_size=32, lr=0.01,
                          fanouts=(4, 4), log_every=1000, eval_every=0,
                          feats_layout=layout, dropout=0.0, sampler=sampler,
                          steps_per_call=k, sentry=sentry)
        tr = DistTrainer(model, book4, cfg, device="cpu")
        out = tr.train()
        runs.append((out["history"][0]["losses"], out["params"],
                     tr.last_stats))
    (l0, p0, s0), (l1, p1, s1) = runs
    assert l0 == l1 and _params_equal(p0, p1)
    assert s0 is None
    assert s1["part_loss"].shape == s1["part_nonfinite"].shape == (4,)
    assert int(s1["part_nonfinite"].sum()) == 0


# ---------------------------------------------------------------------
# NaN feature rows: the same fault step (and partition) as JAX
# ---------------------------------------------------------------------
NAN_GRAPH = dict(num_nodes=1200, num_edges=4800, feat_dim=FEAT,
                 num_classes=CLASSES, seed=7)


def _poison(g, ids):
    g.ndata["feat"] = np.array(g.ndata["feat"], np.float32, copy=True)
    g.ndata["feat"][ids] = np.nan
    return g


def _nan_ids(g, seed: int, batch: int, at_batch: int):
    """The first seed of batch ``at_batch`` of the first epoch's shuffle
    (the trainers' numpy stream seeded with ``seed``)."""
    train = np.nonzero(g.ndata["train_mask"])[0]
    perm = np.random.default_rng(seed).permutation(train)
    return perm[[at_batch * batch]]


def _nan_cfg(**kw):
    return dict(num_epochs=1, batch_size=16, fanouts=(2, 2),
                eval_every=0, log_every=1, dropout=0.0, seed=5,
                prefetch=0, **kw)


def _port_sampled(g, **kw):
    model = DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.0, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    return SampledTrainer(model, g, TrainConfig(**_nan_cfg(**kw)),
                          device="cpu")


def test_nan_rows_fault_at_the_jax_step(tmp_path, monkeypatch):
    jg = jax_datasets.synthetic_node_clf(**NAN_GRAPH).graph
    ids = _nan_ids(jg, 5, 16, at_batch=6)
    jtr = JaxSampledTrainer(JaxDistSAGE(hidden_feats=HIDDEN,
                                        out_feats=CLASSES, dropout=0.0),
                            _poison(jg, ids),
                            JaxTrainConfig(**_nan_cfg(),
                                           quality_action="halt"))
    with pytest.raises(JQ.NumericsFault) as want:
        jtr.train()
    with pytest.raises(Q.NumericsFault) as got:
        _port_sampled(_poison(datasets.synthetic_node_clf(
            **NAN_GRAPH).graph, ids), quality_action="halt").train()
    assert 1 <= got.value.step <= 7
    assert (got.value.step, got.value.partition, got.value.kind) == (
        want.value.step, want.value.partition, want.value.kind) == (
        got.value.step, 0, "nonfinite_loss")

    # the rollback drill: checkpoints every 2 steps, a fault quarantines
    # those at or past it, and a resume from the survivor with the rows
    # restored completes the epoch
    ws = tmp_path / "ws"
    ws.mkdir()
    monkeypatch.setenv(Q.WORKSPACE_ENV, str(ws))
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(Q.NumericsFault) as rolled:
        _port_sampled(_poison(datasets.synthetic_node_clf(
            **NAN_GRAPH).graph, ids), ckpt_dir=ckpt, ckpt_every=2).train()
    assert rolled.value.step == got.value.step
    survivor = CheckpointManager(ckpt).latest_step()
    assert survivor is not None and survivor < got.value.step
    assert Q.take_fault_marker(str(ws))["step"] == got.value.step
    resumed = _port_sampled(datasets.synthetic_node_clf(**NAN_GRAPH).graph,
                            ckpt_dir=ckpt, ckpt_every=2)
    out = resumed.train()
    assert out["step"] == len(resumed.train_ids) // 16
    assert np.isfinite(out["history"][0]["losses"]).all()
    assert all(torch.isfinite(v).all() for v in out["params"].values())


def test_dist_nan_rows_name_the_jax_partition(tmp_path):
    jg = jax_datasets.synthetic_node_clf(**dict(NAN_GRAPH,
                                                feat_dim=16)).graph
    book = partition_graph(jg, "synth", 4, str(tmp_path / "clean"))
    node_map = np.load(tmp_path / "clean" / "node_map.npy")
    train = np.nonzero(jg.ndata["train_mask"])[0]
    ids = train[node_map[train] == 2][5:7]
    book = partition_graph(_poison(jg, ids), "synth", 4,
                           str(tmp_path / "nan"))
    cfg = dict(num_epochs=1, batch_size=16, lr=0.01, fanouts=(2, 2),
               log_every=1, eval_every=0, quality_action="halt")
    jtr = JaxDistTrainer(JaxDistSAGE(hidden_feats=HIDDEN, out_feats=CLASSES,
                                     dropout=0.0), book, make_mesh(num_dp=4),
                         JaxTrainConfig(**cfg))
    init = jax.device_get(jtr._init_params())
    with pytest.raises(JQ.NumericsFault) as want:
        jtr.train()
    model = DistSAGE(16, HIDDEN, CLASSES, dropout=0.0, device="cpu")
    tr = DistTrainer(model, book, TrainConfig(**cfg, dropout=0.0),
                     device="cpu")
    with pytest.raises(Q.NumericsFault) as got:
        tr.train(init_params=init)
    assert (got.value.step, got.value.partition, got.value.kind) == (
        want.value.step, want.value.partition, want.value.kind)
    assert got.value.partition is not None
