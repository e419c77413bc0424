"""The port's rule-driven state sharding (``parallel/shardrules.py``)
and its step (``parallel/dp.py::ShardPlan``) against the JAX package's.

The cases of the JAX ``tests/test_shardrules.py`` on the port: rule
matching (first match, scalars, the unmatched error and its nearest
patterns, the JAX messages), the derived optimizer placement over the
same optax state trees, and the byte model, each equal to the JAX
function's result on the same inputs; then a toy model's replicated,
weight-update-sharded, rule-sharded, ZeRO-3 and tensor-parallel
trajectories over a CPU ``SlotMesh``, ``torch.equal`` to the replicated
one for Adam and Adagrad, with the measured per-slot bytes at 1/N and
equal to the byte model, a ZeRO-3 kill and resume, and a checkpoint
restored bit for bit under other mesh shapes.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dgl_operator_tpu.parallel import shardrules as jsr
from dgl_operator_tpu.parallel.dp import _validate_dp_rules as j_validate
from dgl_operator_tpu_torch.obs import get_obs
from dgl_operator_tpu_torch.parallel import shardrules as sr
from dgl_operator_tpu_torch.parallel.dp import ShardPlan, slot_mean_step
from dgl_operator_tpu_torch.parallel.mesh import (DP_AXIS, MP_AXIS, SlotMesh,
                                                  make_mesh, make_mesh_2d)


def _params():
    return {"embed": {"table": np.zeros((16, 4), np.float32)},
            "dense": {"kernel": np.zeros((4, 4), np.float32),
                      "bias": np.zeros((4,), np.float32)},
            "scale": np.zeros((), np.float32)}


def _jparams():
    return {"embed": {"table": jnp.zeros((16, 4))},
            "dense": {"kernel": jnp.zeros((4, 4)), "bias": jnp.zeros((4,))},
            "scale": jnp.zeros(())}


def _same_specs(port_tree, jax_tree):
    got = [(p, tuple(s)) for p, s in sr.tree_paths(port_tree)]
    want = [(p, tuple(s)) for p, s in jsr.tree_paths(jax_tree)]
    assert got == want


# ------------------------------------------------- match_partition_rules
def test_match_rules_first_match_wins():
    rules = ((r"embed/table", "dp"), (r"table", "mp"), (r".*", None))
    specs = sr.match_partition_rules(rules, _params())
    assert specs["embed"]["table"] == ("dp",)
    assert specs["dense"]["kernel"] == () == specs["dense"]["bias"]
    _same_specs(specs, jsr.match_partition_rules(rules, _jparams()))


def test_match_rules_scalar_passthrough():
    specs = sr.match_partition_rules(((r".*", "dp"),), _params())
    assert specs["scale"] == ()
    assert specs["dense"]["bias"] == ("dp",)
    _same_specs(specs, jsr.match_partition_rules(((r".*", "dp"),),
                                                 _jparams()))


def _error(fn, *args):
    with pytest.raises(ValueError) as ei:
        fn(*args)
    return str(ei.value)


def test_match_rules_unmatched_leaf_raises():
    rules = ((r"embed", "dp"),)
    msg = _error(sr.match_partition_rules, rules, _params())
    assert "dense/" in msg
    assert msg == _error(jsr.match_partition_rules, rules, _jparams())


def test_to_pspec_coercions():
    assert sr.to_pspec(None) == ()
    assert sr.to_pspec("dp") == ("dp",)
    assert sr.to_pspec(("dp", "mp")) == ("dp", "mp")
    assert sr.to_pspec(["dp", ["dp", "mp"]]) == ("dp", ("dp", "mp"))
    for spec in (None, "dp", ("dp", "mp"), (None, "mp")):
        assert tuple(sr.to_pspec(spec)) == tuple(jsr.to_pspec(spec))
    with pytest.raises(TypeError):
        sr.to_pspec(7)


# ------------------------------------------------------ opt_state_specs
@pytest.mark.parametrize("opt", [optax.adam(1e-2), optax.adagrad(1e-2)])
def test_opt_state_specs_inherit_and_scalars(opt):
    """The same optax state tree through both packages: a moment
    inherits its parameter's spec, the count stays replicated."""
    rules = ((r"embed/table", "dp"), (r".*", None))
    state = opt.init(_jparams())
    pspecs = sr.match_partition_rules(rules, _params())
    ospecs = sr.opt_state_specs(state, _params(), pspecs)
    for (path, leaf), (_, spec) in zip(sr.tree_paths(state),
                                       sr.tree_paths(ospecs)):
        if sr.is_scalar_leaf(leaf):
            assert spec == (), path
        elif path.endswith("embed/table"):
            assert spec == ("dp",), path
        else:
            assert spec == (), path
    _same_specs(ospecs, jsr.opt_state_specs(
        state, _jparams(), jsr.match_partition_rules(rules, _jparams())))


def test_opt_state_specs_flat_wus_leaves_inherit_by_path():
    params = {"w": np.zeros((6, 5)), "b": np.zeros((5,))}
    pspecs = {"w": sr.to_pspec("dp"), "b": sr.to_pspec(None)}
    state = optax.adam(1e-2).init({"w": jnp.zeros((8,)),
                                   "b": jnp.zeros((5,))})
    ospecs = sr.opt_state_specs(state, params, pspecs)
    for (path, _), (_, spec) in zip(sr.tree_paths(state),
                                    sr.tree_paths(ospecs)):
        assert spec == (("dp",) if path.endswith("/w") else ()), path


def test_opt_state_specs_longest_suffix_wins():
    params = {"b": np.zeros((3,)), "emb": {"b": np.zeros((4, 2))}}
    pspecs = {"b": sr.to_pspec(None), "emb": {"b": sr.to_pspec("dp")}}
    state = optax.adagrad(1e-2).init({"b": jnp.zeros((3,)),
                                      "emb": {"b": jnp.zeros((4, 2))}})
    ospecs = sr.opt_state_specs(state, params, pspecs)
    for (path, _), (_, spec) in zip(sr.tree_paths(state),
                                    sr.tree_paths(ospecs)):
        assert spec == (("dp",) if path.endswith("emb/b") else ()), path


def test_opt_state_specs_tiny_moment_inherits_not_scalar():
    params = {"b": np.zeros((4,))}
    state = optax.adam(1e-2).init({"b": jnp.zeros((1,))})
    ospecs = sr.opt_state_specs(state, params, {"b": sr.to_pspec("dp")})
    for (path, _), (_, spec) in zip(sr.tree_paths(state),
                                    sr.tree_paths(ospecs)):
        assert spec == (("dp",) if path.endswith("/b") else ()), path


# --------------------------------------------------------- byte model
def test_bytes_per_slot_and_summary():
    params = {"table": np.zeros((100, 8), np.float32),
              "bias": np.zeros((8,), np.float32)}
    specs = {"table": sr.to_pspec("dp"), "bias": sr.to_pspec(None)}
    jspecs = {"table": P("dp"), "bias": P()}
    sizes = {"dp": 4}
    assert sr.replicated_bytes(params) == 3232
    assert sr.bytes_per_slot(params, specs, sizes) == 800 + 32
    opt = {"table": np.zeros((100, 8)), "bias": np.zeros((8,))}
    got = sr.sharding_summary(params, opt, specs, specs, sizes)
    assert got == jsr.sharding_summary(params, opt, jspecs, jspecs, sizes)
    assert got["state_savings_ratio"] == pytest.approx(
        (832 + 1600 + 64) / (3232 + 6464), abs=1e-4)


def test_bytes_per_slot_multi_axis_and_ceil():
    t = {"x": np.zeros((10, 3), np.float32)}
    assert sr.bytes_per_slot(t, {"x": sr.to_pspec((("dp", "mp"),))},
                             {"dp": 2, "mp": 4}) == 15
    assert sr.bytes_per_slot(t, {"x": sr.to_pspec("dp")}, {"dp": 7}) == 18
    assert sr.zero3_bytes_per_slot(t, 7) == jsr.zero3_bytes_per_slot(t, 7)
    tree = {"a": np.zeros((13, 3), np.float32), "b": np.zeros(5, np.int8)}
    for n in (1, 2, 4, 8):
        assert sr.zero3_bytes_per_slot(tree, n) == \
            jsr.zero3_bytes_per_slot(tree, n)


def test_emit_state_gauges_roundtrip():
    s = {"params_mib_per_slot_replicated": 4.0,
         "params_mib_per_slot_sharded": 1.0,
         "opt_state_mib_per_slot_replicated": 8.0,
         "opt_state_mib_per_slot_sharded": 2.0,
         "state_savings_ratio": 0.25}
    sr.emit_state_gauges(s, role="test")
    snap = get_obs().metrics.snapshot()
    by = {(x["labels"]["role"], x["labels"]["kind"],
           x["labels"]["mode"]): x["value"]
          for x in snap["train_state_mib_per_slot"]["samples"]}
    assert by[("test", "opt_state", "sharded")] == 2.0
    assert by[("test", "params", "replicated")] == 4.0
    ratios = {x["labels"]["role"]: x["value"]
              for x in snap["train_state_savings_ratio"]["samples"]}
    assert ratios["test"] == 0.25


def test_pad_and_unpad_roundtrip():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(5, 3)).astype(np.float32)
    for x in (a, torch.from_numpy(a)):
        flat = sr.pad_flat(x, 4)
        assert tuple(flat.shape) == (16,)
        np.testing.assert_array_equal(np.asarray(flat),
                                      jsr.pad_flat(a, 4))
        dims = sr.pad_dims(x, (1, 2))
        np.testing.assert_array_equal(np.asarray(dims),
                                      jsr.pad_dims(a, (1, 2)))
        for padded in (flat, dims):
            back = sr.unpad_leaf(padded, (5, 3))
            np.testing.assert_array_equal(np.asarray(back), a)
    with pytest.raises(ValueError, match="cannot unpad"):
        sr.unpad_leaf(np.zeros(4), (5, 3))


def test_place_by_specs_over_slots_and_ranks():
    mesh = make_mesh_2d(2, 2)
    tree = {"w": np.arange(24.).reshape(4, 6), "b": np.arange(4.)}
    specs = {"w": sr.to_pspec((DP_AXIS, MP_AXIS)), "b": sr.to_pspec(None)}
    placed = sr.place_by_specs(mesh, tree, specs)
    assert sorted(placed) == [0, 1, 2, 3]
    np.testing.assert_array_equal(placed[3]["w"], tree["w"][2:, 3:])
    np.testing.assert_array_equal(placed[1]["b"], tree["b"])
    mine = sr.place_by_specs(mesh, tree, specs, rank=1, world=2)
    assert sorted(mine) == [2, 3]
    np.testing.assert_array_equal(mine[2]["w"], tree["w"][2:, :3])


# ------------------------------------------------ the sharded step
class Toy(torch.nn.Module):
    """The JAX test's ``tanh(x @ w) @ v + b`` model."""

    def __init__(self):
        super().__init__()
        rng = np.random.default_rng(0)
        for name, shape in (("w", (7, 5)), ("v", (5, 3)), ("b", (3,))):
            setattr(self, name, torch.nn.Parameter(torch.from_numpy(
                rng.normal(size=shape).astype(np.float32))))

    def loss(self, x, y):
        pred = torch.tanh(x @ self.w) @ self.v + self.b
        return ((pred - y) ** 2).mean()


def _opt(name):
    if name == "adam":
        return lambda ts: torch.optim.Adam(ts, lr=1e-2)
    return lambda ts: torch.optim.Adagrad(ts, lr=1e-2)


def _run(mesh, optname, steps=4, plan_kw=None, roundtrip_at=None):
    """A trajectory over ``mesh``'s dp slots, replicated (``plan_kw``
    None) or through a :class:`ShardPlan`; ``roundtrip_at=i`` stops after
    step ``i`` and goes on from the plan's logical state on a fresh
    model and plan."""
    n = mesh.shape[DP_AXIS]
    model = Toy()
    plan = opt = None
    if plan_kw is None:
        opt = _opt(optname)(list(model.parameters()))
    else:
        plan = ShardPlan(model, mesh, _opt(optname), **plan_kw)
    losses = []
    for i in range(steps):
        r = np.random.default_rng(100 + i)
        x = torch.from_numpy(r.normal(size=(n, 8, 7)).astype(np.float32))
        y = torch.from_numpy(r.normal(size=(n, 8, 3)).astype(np.float32))
        loss, _ = slot_mean_step(opt, lambda s: model.loss(x[s], y[s]), n,
                                 plan=plan)
        losses.append(loss.item())
        if roundtrip_at == i:
            state = plan.train_state()
            model = Toy()
            plan = ShardPlan(model, mesh, _opt(optname), **plan_kw)
            plan.load_train_state(state)
    if plan is not None:
        plan.materialize()
    return losses, {k: v.detach().clone() for k, v in
                    model.state_dict().items()}, plan or opt


def _equal(ref, got):
    assert ref[0] == got[0]
    for k in ref[1]:
        assert torch.equal(ref[1][k], got[1][k]), k


@pytest.mark.parametrize("ndp", [2, 4, 8])
@pytest.mark.parametrize("optname", ["adam", "adagrad"])
def test_wus_bit_identical_grid(ndp, optname):
    mesh = make_mesh(ndp)
    ref = _run(mesh, optname)
    _equal(ref, _run(mesh, optname, plan_kw=dict(shard_update=True)))
    _equal(ref, _run(mesh, optname, plan_kw=dict(
        shard_rules=(("^w$", DP_AXIS), (".*", None)))))


def _opt_bytes(opt, tensors):
    return sum(v.numel() * v.element_size() for t in tensors
               for k, v in opt.state[t].items() if k != "step")


def test_wus_measured_opt_bytes_quarter_on_4_slots():
    """On 4 slots a slot's measured moment bytes under weight-update
    sharding are at most 0.30 of the replicated ones, and equal to the
    byte model's (Adam's count, a step counter per tensor in torch,
    aside)."""
    mesh = make_mesh(4)
    _, _, opt = _run(mesh, "adam", steps=1)
    _, _, plan = _run(mesh, "adam", steps=1, plan_kw=dict(shard_update=True))
    repl = _opt_bytes(opt, [p for g in opt.param_groups
                            for p in g["params"]])
    slot0 = [lf.parts[0] for lf in plan.leaves]
    wus = _opt_bytes(plan.optimizer, slot0)
    assert wus <= 0.30 * repl, (wus, repl)
    params, specs = plan.storage_specs()
    flat = sr.tree_map_with_path(
        lambda p, x: sr.ShapeLeaf((4 * -(-int(np.prod(x.shape)) // 4),)),
        params)
    analytic = sr.bytes_per_slot(
        {"mu": flat, "nu": flat},
        sr.opt_state_specs({"mu": flat, "nu": flat}, flat,
                           sr.match_partition_rules(((".*", DP_AXIS),),
                                                    params)), {DP_AXIS: 4})
    assert analytic == wus


def test_rules_partial_selection_placement():
    _, _, plan = _run(make_mesh(4), "adam", steps=1, plan_kw=dict(
        shard_rules=(("^w$", DP_AXIS), (".*", None))))
    kinds = {lf.path: lf.kind for lf in plan.leaves}
    assert kinds == {"w": "flat", "v": "repl", "b": "repl"}
    for lf in plan.leaves:
        for t in lf.parts:
            m = plan.optimizer.state[t]["exp_avg"]
            assert m.shape == ((9,) if lf.path == "w" else lf.param.shape)


def test_dp_rules_reject_non_dp_axis_and_both_knobs():
    mesh = make_mesh(4)
    for rules, stage in ((((".*", "mp"),), 1), (((".*", "xx"),), 3)):
        msg = _error(ShardPlan, Toy(), mesh, _opt("adam"), False, rules,
                     stage)
        jmesh = type("M", (), {"axis_names": ("dp",)})()
        assert msg == _error(j_validate, rules, jmesh, stage)
    with pytest.raises(ValueError, match="not both"):
        ShardPlan(Toy(), mesh, _opt("adam"), shard_update=True,
                  shard_rules=((".*", "dp"),))


TP_RULES = (("^w$", (None, MP_AXIS)), ("^v$", DP_AXIS), (".*", None))


@pytest.mark.parametrize("ndp", [2, 4, 8])
@pytest.mark.parametrize("optname", ["adam", "adagrad"])
def test_zero3_bit_identical_grid(ndp, optname):
    mesh = make_mesh(ndp)
    _equal(_run(mesh, optname), _run(mesh, optname,
                                     plan_kw=dict(zero_stage=3)))


def test_zero3_tp_rules_bit_identical_on_2d_mesh():
    mesh = make_mesh_2d(2, 4)
    ref = _run(mesh, "adam")
    got = _run(mesh, "adam", plan_kw=dict(zero_stage=3,
                                          shard_rules=TP_RULES))
    _equal(ref, got)
    plan = got[2]
    kinds = {lf.path: (lf.kind, tuple(lf.spec)) for lf in plan.leaves}
    assert kinds == {"w": ("dim", (None, MP_AXIS)), "v": ("flat", (DP_AXIS,)),
                     "b": ("repl", ())}
    w = plan.leaves[0]
    assert [tuple(t.shape) for t in w.parts] == [(7, 2)] * 4


@pytest.mark.parametrize("gather_depth", [1, 4])
def test_zero3_gather_depth_is_numerics_neutral(gather_depth):
    mesh = make_mesh(4)
    _equal(_run(mesh, "adam"), _run(mesh, "adam", plan_kw=dict(
        zero_stage=3, gather_depth=gather_depth)))


def test_zero3_kill_resume_bit_exact():
    mesh = make_mesh(4)
    kw = dict(zero_stage=3)
    ref = _run(mesh, "adam", plan_kw=kw)
    got = _run(mesh, "adam", plan_kw=kw, roundtrip_at=1)
    _equal(ref, got)
    for a, b in zip(ref[2].logical_opt_state(), got[2].logical_opt_state()):
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]),
                               torch.as_tensor(b[k])), k


def test_zero3_checkpoint_mesh_shape_invariant():
    """A logical state written on a 2x2 grid loads bit for bit under 1x8
    and 8x1 grids (other flat and block padding) and back."""
    _, _, plan_a = _run(make_mesh_2d(2, 2), "adagrad", steps=2,
                        plan_kw=dict(zero_stage=3, shard_rules=TP_RULES))
    saved = plan_a.train_state()
    for num_dp, num_mp in ((1, 8), (8, 1)):
        plan_b = ShardPlan(Toy(), make_mesh_2d(num_dp, num_mp),
                           _opt("adagrad"), zero_stage=3,
                           shard_rules=TP_RULES)
        plan_b.load_train_state(saved)
        back = plan_b.train_state()
        for k in saved["params"]:
            assert torch.equal(saved["params"][k], back["params"][k])
        for i in saved["opt"]:
            for k in saved["opt"][i]:
                assert torch.equal(torch.as_tensor(saved["opt"][i][k]),
                                   torch.as_tensor(back["opt"][i][k]))


def test_zero3_measured_param_bytes_on_8_parts():
    """On 8 slots a slot's resident parameter bytes under ZeRO-3 are at
    most 0.30 of the replicated ones, and the byte model over the
    storage specs bills exactly what is measured."""
    _, _, plan = _run(make_mesh(8), "adam", steps=1,
                      plan_kw=dict(zero_stage=3))
    measured = plan.slot_bytes()[0]["params"]
    repl = sum(p.numel() * 4 for p in Toy().parameters())
    assert measured <= 0.30 * repl, (measured, repl)
    params, specs = plan.storage_specs()
    assert sr.bytes_per_slot(params, specs, {DP_AXIS: 8}) == measured
    assert sr.zero3_bytes_per_slot(sr.param_tree(
        sr.param_leaves(Toy())), 8) == measured


def test_zero3_tp_rule_scalar_leaf_falls_back_replicated():
    tree = {"scale": np.zeros(()), "w": np.zeros((4, 6))}
    specs = sr.match_partition_rules(((r".*", (None, MP_AXIS)),), tree)
    assert specs["scale"] == () and specs["w"] == (None, MP_AXIS)


def test_match_rules_unmatched_error_names_nearest_patterns():
    rules = ((r"dense/kernal", "dp"), (r"embed/table", "dp"))
    msg = _error(sr.match_partition_rules, rules, _params())
    assert "nearest rule patterns" in msg and "dense/kernal" in msg
    assert msg == _error(jsr.match_partition_rules, rules, _jparams())


def test_summary_of_a_plan_is_the_jax_models():
    """The byte model's summary of a ZeRO-3 plan with dim blocks equals
    the JAX functions' on the same storage shapes and specs."""
    mesh = SlotMesh({DP_AXIS: 2, MP_AXIS: 4})
    plan = ShardPlan(Toy(), mesh, _opt("adam"), zero_stage=3,
                     shard_rules=TP_RULES)
    params, specs = plan.storage_specs()
    jparams = {p: jnp.zeros(x.shape) for p, x in sr.tree_paths(params)}
    jspecs = {p: P(*s) for p, s in sr.tree_paths(specs)}
    jopt = optax.adam(1e-2).init(jparams)
    want = jsr.sharding_summary(
        jparams, jopt, jspecs, jsr.opt_state_specs(jopt, jparams, jspecs),
        {DP_AXIS: 2, MP_AXIS: 4})
    assert plan.summary() == want
