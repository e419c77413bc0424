"""The port's state sharding through ``DistTrainer`` and the KGE trainer
against the replicated runs and the JAX package's trainers.

One 4-part book of ``synthetic_node_clf(800, 4000, 16, 4, seed=3)``
written by the JAX partitioner, as ``tests/test_torch_dist.py`` builds
it; the port starts from the JAX trainer's initial params. Each of
``shard_update``, ``shard_rules`` (zero_stage 1), ``zero_stage=3`` with
``gather_depth`` 1, 2 and 4, and ``zero_stage=3, tp_axis_size=2`` on a
2 x 2 mesh trains a trajectory ``torch.equal`` to the replicated one on
the same mesh (losses, weights and the logical Adam state). Against the
JAX ``DistTrainer`` (one run a module for weight-update sharding on 4
slots, one for ZeRO-3 with tensor-parallel rules on 2 x 2): losses and
weights within 1e-4, and the byte model's ``sharding_summary`` equal to
the JAX trainer's gauges. A ZeRO-3 checkpoint written at 4 slots restores
bit for bit at 2 slots and in a replicated trainer. Two gloo ranks
(``tests/torch_shard_worker.py``) with ``shard_update`` equal the one
process bit for bit, each holding half of its optimizer state. The KGE
grid with relation ``shard_rules`` trains bit-equal to unsharded, in
one process and (to float rounding) on two ranks, with the JAX
messages and byte model.
"""

import jax
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph.partition import partition_graph
from dgl_operator_tpu.models import kge as jax_models
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.obs import get_obs as jax_get_obs
from dgl_operator_tpu.parallel import make_mesh as jax_make_mesh
from dgl_operator_tpu.parallel import shardrules as jsr
from dgl_operator_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from dgl_operator_tpu.runtime import DistTrainer as JaxDistTrainer
from dgl_operator_tpu.runtime import TrainConfig as JaxTrainConfig
from dgl_operator_tpu.runtime import kge as jax_kge
from dgl_operator_tpu_torch.models.sage import state_dict_to_flax
from dgl_operator_tpu_torch.parallel import shardrules as sr
from dgl_operator_tpu_torch.parallel.mesh import make_mesh, make_train_mesh
from dgl_operator_tpu_torch.runtime.dist import DistTrainer
from dgl_operator_tpu_torch.runtime.kge import DistKGETrainer
from dgl_operator_tpu_torch.runtime.loop import open_checkpoints
from test_torch_native import use_jax_graphcore
import torch_kge_grid_worker as kge_worker
import torch_shard_worker as worker

TP_RULES = (("kernel", (None, "mp")), (".*", "dp"))
TOL = dict(rtol=1e-4, atol=1e-4)
MODES = {
    "wus": dict(shard_update=True),
    "rules": dict(shard_rules=(("neigh", "dp"), (".*", None))),
    "z3_gd1": dict(zero_stage=3, gather_depth=1),
    "z3_gd2": dict(zero_stage=3, gather_depth=2),
    "z3_gd4": dict(zero_stage=3, gather_depth=4),
    # fresh storage before every call (a caller's tensors keep theirs)
    "wus_no_donate": dict(shard_update=True, donate=False),
    "z3_no_donate": dict(zero_stage=3, donate=False),
}


@pytest.fixture(autouse=True)
def jax_library(monkeypatch, tmp_path_factory):
    use_jax_graphcore(monkeypatch, tmp_path_factory)
    monkeypatch.delenv("TPU_OPERATOR_TUNED_MANIFEST", raising=False)


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        use_jax_graphcore(mp, tmp_path_factory)
        ds = jax_datasets.synthetic_node_clf(num_nodes=800, num_edges=4000,
                                             feat_dim=worker.FEAT,
                                             num_classes=worker.CLASSES,
                                             seed=3)
        return partition_graph(ds.graph, "synth", 4,
                               str(tmp_path_factory.mktemp("torch_zero")))


def _jax_summary():
    snap = jax_get_obs().metrics.snapshot()
    got = {}
    for x in snap["train_state_mib_per_slot"]["samples"]:
        lab = x["labels"]
        if lab["role"] == "dist":
            got[f"{lab['kind']}_mib_per_slot_{lab['mode']}"] = x["value"]
    got["state_savings_ratio"] = next(
        x["value"] for x in snap["train_state_savings_ratio"]["samples"]
        if x["labels"]["role"] == "dist")
    return got


@pytest.fixture(scope="module")
def jax_runs(book, tmp_path_factory):
    """The JAX trainer with weight-update sharding on 4 slots and with
    ZeRO-3 and tensor-parallel rules on 2 x 2: per run its initial
    params, losses, final params and state summary."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        use_jax_graphcore(mp, tmp_path_factory)
        mp.delenv("TPU_OPERATOR_TUNED_MANIFEST", raising=False)
        for name, mesh, kw in (
                ("wus", jax_make_mesh(num_dp=4), dict(shard_update=True)),
                ("z3_tp", jax_make_mesh_2d(2, 2),
                 dict(zero_stage=3, tp_axis_size=2, shard_rules=TP_RULES))):
            tr = JaxDistTrainer(
                JaxDistSAGE(hidden_feats=worker.HIDDEN,
                            out_feats=worker.CLASSES, dropout=0.0), book,
                mesh, JaxTrainConfig(**worker.DIST_FIELDS, sentry=False,
                                     **kw))
            init = jax.device_get(tr._init_params())
            out = tr.train()
            runs[name] = (init, [r["loss"] for r in out["history"]],
                          jax.device_get(out["params"]), _jax_summary())
    return runs


def _run(book, init, mesh=None, **kw):
    return worker.run_dist(book, init, mesh, **kw)


@pytest.fixture(scope="module")
def port_runs(book, jax_runs):
    init = jax_runs["wus"][0]
    runs = {"repl": _run(book, init)}
    for name, kw in MODES.items():
        runs[name] = _run(book, init, **kw)
    runs["repl_dp2"] = _run(book, init, make_mesh(2))
    runs["z3_tp"] = _run(book, init, make_train_mesh(2, 2), zero_stage=3,
                         tp_axis_size=2, shard_rules=TP_RULES)
    return runs


def _same_run(a, b):
    assert [r["losses"] for r in a["history"]] == \
        [r["losses"] for r in b["history"]]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    sa, sb = a["opt_state"]["state"], b["opt_state"]["state"]
    assert sorted(sa) == sorted(sb)
    for i in sa:
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]),
                               torch.as_tensor(sb[i][k])), (i, k)


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_trajectory_equals_replicated(port_runs, mode):
    tr, out = port_runs[mode]
    assert tr._plan is not None and tr._plan.zero_stage == \
        MODES[mode].get("zero_stage", 1)
    _same_run(port_runs["repl"][1], out)


def test_zero3_tp_on_2x2_equals_replicated(port_runs):
    tr, out = port_runs["z3_tp"]
    assert tr.mesh.shape == {"dp": 2, "mp": 2}
    kinds = {lf.path: lf.kind for lf in tr._plan.leaves}
    assert {k for k, v in kinds.items() if v == "dim"} == {
        p for p in kinds if p.endswith("kernel")}
    _same_run(port_runs["repl_dp2"][1], out)


def _close_to_jax(out, want_losses, want_params):
    np.testing.assert_allclose([r["loss"] for r in out["history"]],
                               want_losses, **TOL)
    got = state_dict_to_flax(out["params"])["params"]
    for path, value in sr.tree_paths(got):
        want = want_params["params"]
        for part in path.split("/"):
            want = want[part]
        np.testing.assert_allclose(value, np.asarray(want), err_msg=path,
                                   **TOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_runs_match_jax(port_runs, jax_runs, mode):
    _, losses, params, _ = jax_runs["wus"]
    _close_to_jax(port_runs[mode][1], losses, params)


def test_zero3_tp_matches_jax(port_runs, jax_runs):
    _, losses, params, _ = jax_runs["z3_tp"]
    _close_to_jax(port_runs["z3_tp"][1], losses, params)


@pytest.mark.parametrize("mode,jax_mode", [("wus", "wus"),
                                           ("z3_tp", "z3_tp")])
def test_state_summary_is_the_jax_trainers(port_runs, jax_runs, mode,
                                           jax_mode):
    assert port_runs[mode][0].state_summary == jax_runs[jax_mode][3]


def test_zero3_bytes_per_slot_is_the_jax_models(port_runs, jax_runs):
    tr = port_runs["z3_gd2"][0]
    params = sr.param_tree(sr.param_leaves(tr.model))
    jparams = jax_runs["wus"][0]
    for n in (1, 2, 4, 8):
        assert sr.zero3_bytes_per_slot(params, n) == \
            jsr.zero3_bytes_per_slot(jparams, n)
    measured = tr._plan.slot_bytes()
    assert {b["params"] for b in measured.values()} == {
        sr.zero3_bytes_per_slot(params, 4)}


def test_measured_state_is_a_quarter_a_slot(port_runs):
    repl = sum(p.numel() * 4 for p in port_runs["repl"][0].model.parameters())
    for mode, kind in (("wus", "opt_state"), ("z3_gd2", "params")):
        got = port_runs[mode][0]._plan.slot_bytes()[0][kind]
        want = repl * (2 if kind == "opt_state" else 1)
        # padding and torch's per-tensor step counters aside
        assert got <= 0.30 * want, (mode, got, want)


def test_zero3_params_are_resident_shards_between_steps(book, jax_runs):
    tr, out = _run(book, jax_runs["wus"][0], zero_stage=3)
    plan = tr._plan
    assert plan._full            # train() hands back full weights
    plan.release()
    assert all(lf.param.numel() == 0 for lf in plan.leaves
               if lf.kind != "repl")
    tr.evaluate()                # gathers them back
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, out["params"][k]), k


def test_zero3_checkpoint_restores_across_mesh_shapes(book, jax_runs,
                                                      tmp_path):
    """A ZeRO-3 run at 4 slots checkpoints the logical tree; a ZeRO-3
    trainer at 2 slots (with tensor-parallel blocks) and a replicated
    trainer each restore it bit for bit."""
    ck = str(tmp_path / "ckpt")
    _, out = _run(book, jax_runs["wus"][0], zero_stage=3, ckpt_dir=ck)
    for mesh, kw in ((make_train_mesh(2, 2), dict(
            zero_stage=3, tp_axis_size=2, shard_rules=TP_RULES)),
            (make_mesh(2), {})):
        tr, _ = worker.run_dist(book, jax_runs["wus"][0], mesh,
                                num_epochs=0, **kw)
        cfg = worker.dist_config(ckpt_dir=ck, **kw)
        _, step = open_checkpoints(cfg, tr.model, tr.optimizer,
                                   plan=tr._plan)
        assert step == out["step"]
        state = (tr._plan.train_state() if tr._plan is not None else
                 {"params": tr.model.state_dict(),
                  "opt": tr.optimizer.state_dict()["state"]})
        for k, v in out["params"].items():
            assert torch.equal(state["params"][k], v), k
        for i, st in out["opt_state"]["state"].items():
            got = state["opt"][str(i) if tr._plan is not None else i]
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(got[k], st[k]), (i, k)


def test_shard_knobs_are_checked(book):
    with pytest.raises(ValueError, match="not both"):
        _run(book, None, shard_update=True, shard_rules=((".*", "dp"),))
    with pytest.raises(ValueError, match="only supports 'dp'"):
        _run(book, None, shard_rules=((".*", "mp"),))
    with pytest.raises(ValueError, match="needs a mesh with a 'mp' axis"):
        _run(book, None, make_mesh(2), tp_axis_size=2)
    with pytest.raises(ValueError, match="does not compose"):
        _run(book, None, steps_per_call=2, sampler="device",
             shard_update=True)


def test_two_ranks_weight_update_sharding(book, tmp_path):
    """Two gloo ranks of two slots each with ``shard_update``: each
    rank's losses, weights and logical Adam state equal the group's
    replicated run's bit for bit and the one process's to float rounding
    (the ranks' slot sums add in another order), each rank holds about
    half of the replicated optimizer state, and a checkpoint directory
    is refused with the JAX message."""
    got = worker.run_two("wus", str(tmp_path / "w"), book)
    _, want = _run(book, None, shard_update=True)
    for g in got:
        assert g["losses"] == g["repl_losses"]
        _same_run({"history": [{"losses": x} for x in g["losses"]],
                   "params": g["params"], "opt_state": g["opt_state"]},
                  {"history": [{"losses": x} for x in g["repl_losses"]],
                   "params": g["repl_params"],
                   "opt_state": g["repl_opt_state"]})
        np.testing.assert_allclose(
            np.concatenate(g["losses"]),
            np.concatenate([r["losses"] for r in want["history"]]),
            rtol=1e-6)
        for k, v in want["params"].items():
            np.testing.assert_allclose(g["params"][k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-6)
        assert g["opt_bytes"] <= 0.55 * g["repl_opt_bytes"], g
        assert "single-controller-only" in g["ckpt_guard"]


# ----------------------------------------------------------------- KGE
def _kge_jax(rules):
    ds = kge_worker.dataset()
    cfg, tcfg = kge_worker.configs(ds)
    return jax_kge.DistKGETrainer(
        jax_models.KGEConfig(**vars(cfg)),
        jax_kge.KGETrainConfig(lr=tcfg.lr, max_step=tcfg.max_step,
                               batch_size=tcfg.batch_size,
                               neg_sample_size=tcfg.neg_sample_size,
                               neg_chunk_size=tcfg.neg_chunk_size,
                               seed=tcfg.seed, shard_rules=rules),
        jax_make_mesh_2d(2, 2))


@pytest.fixture(scope="module")
def kge_plain():
    """The unsharded KGE grid run both KGE comparisons hold to."""
    return worker.kge_run()


def test_kge_relation_rules_train_bit_equal_to_unsharded(kge_plain):
    plain, p_out = kge_plain
    tr, out = worker.kge_run(worker.KGE_RULES)
    assert tr._rel_sharded and tr.relation.shape[0] == tr._rel_pad
    assert tr._rel_pad % 2 == 0 and not plain._rel_sharded
    assert out["losses"] == p_out["losses"]
    for k, v in plain.state_dict().items():
        assert np.array_equal(tr.state_dict()[k], v), k
    assert tr.state_sharding_summary() == \
        _kge_jax(worker.KGE_RULES).state_sharding_summary()
    assert plain.state_sharding_summary() == \
        _kge_jax(None).state_sharding_summary()


@pytest.mark.parametrize("rules", [(("entity", "dp"), (".*", None)),
                                   (("relation", "mp"), (".*", None))])
def test_kge_rule_errors_are_the_jax_messages(rules):
    ds = kge_worker.dataset()
    cfg, tcfg = kge_worker.configs(ds, shard_rules=rules)
    with pytest.raises(ValueError) as port_err:
        DistKGETrainer(cfg, tcfg, device="cpu",
                       mesh=kge_worker.mesh_of((2, 2)))
    with pytest.raises(ValueError) as jax_err:
        _kge_jax(rules)
    assert str(port_err.value) == str(jax_err.value)


def test_two_ranks_kge_relation_rules(tmp_path, kge_plain):
    """Two gloo ranks of the 2 x 2 grid, each keeping its half of the
    relation rows: losses and tables within 1e-6 of the one-process
    unsharded run (the relation accumulator sums its slots in another
    order across ranks)."""
    got = worker.run_two("kge_rel", str(tmp_path / "k"))
    plain, p_out = kge_plain
    want = plain.state_dict()
    for g in got:
        assert g["rel_rows"][0] == plain.cfg.n_relations // 2 + \
            plain.cfg.n_relations % 2
        np.testing.assert_allclose(g["losses"], p_out["losses"], rtol=1e-6)
        for k, v in want.items():
            assert np.abs(g["state"][k] - v).max() <= 1e-6 * np.abs(
                v).max(), k
