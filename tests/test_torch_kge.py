"""The port's KGE slice on one device against the JAX package's, on the CPU.

The same numpy inputs go through both packages:

- the KG datasets and the triple-directory reader give identical
  triples; the relation partitions, ``ChunkedEdgeSampler`` batches (with
  and without ``exclude_positive``), the bidirectional iterator,
  ``TrainDataset`` and ``EvalSampler`` give identical streams (they are
  numpy code copied, so equality is exact); ``partition_kg`` books are
  read by the other package;
- the nine scorers, positive and ``neg_score`` in both corruption modes,
  within 1e-5 (float32, different summation order); the loss with and
  without ``-adv`` within 1e-5 and its row gradients within 1e-5 of
  their largest entry;
- row-sparse Adagrad (``ops/adagrad.py``, through
  ``parallel/embedding.py::dense_push_adagrad``) against
  ``_sparse_adagrad_update`` and the float64 ``dense_push_adagrad``
  within 1e-5, duplicate and null ids included; untouched rows keep
  their bits;
- ``KGETrainer`` from the JAX trainer's tables
  (``kge_state_from_numpy``), 6 steps (3 tail, 3 head): every step's
  loss within rtol 1e-5, final tables within 1e-4 of their largest
  entry (Adagrad carries float32 rounding forward);
- ``full_ranking_eval``, raw and filtered, on the same tables: equal MR
  and Hits (ranks are integer counts), MRR within 1e-12.

The unported configuration fields raise, and the entry point parses the
flags the KGE launcher passes.
"""

import gzip
import json
import os
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph import kge_sampler as jax_sampler
from dgl_operator_tpu.launcher import tpukerun
from dgl_operator_tpu.models import kge as jax_models
from dgl_operator_tpu.nn import kge as jax_nn
from dgl_operator_tpu.parallel import embedding as jax_embedding
from dgl_operator_tpu.runtime import kge as jax_runtime
from dgl_operator_tpu_torch.examples import partition_kg as port_partition
from dgl_operator_tpu_torch.examples import train_kge
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph import kge_sampler as sampler
from dgl_operator_tpu_torch.models.kge import (KGEConfig, KGEModel,
                                               kge_state_from_numpy,
                                               neg_log_sigmoid_loss)
from dgl_operator_tpu_torch.nn import kge as nn_kge
from dgl_operator_tpu_torch.ops.adagrad import accumulate, push_plan
from dgl_operator_tpu_torch.ops.scatter import CHUNK
from dgl_operator_tpu_torch.parallel.embedding import (dense_lookup,
                                                       dense_push_adagrad)
from dgl_operator_tpu_torch.runtime.kge import (KGETrainConfig, KGETrainer,
                                                build_filter,
                                                full_ranking_eval)

SCORERS = sorted(nn_kge.KGE_SCORERS)
OP_TOL = dict(rtol=1e-5, atol=1e-5)


def _triples(n=2000, ne=300, nr=12, seed=0):
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, nr + 1)
    probs /= probs.sum()
    r = rng.choice(nr, size=n, p=probs)
    return (rng.integers(0, ne, size=n), r.astype(np.int64),
            rng.integers(0, ne, size=n))


def _same(a, b):
    """Two nested structures of arrays, lists and scalars are equal."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------- datasets
@pytest.mark.parametrize("name,scale", [("fb15k", 0.01), ("FB15k-237", 0.0),
                                        ("wn18rr", 0.01),
                                        ("wikidata5m", 0.0)])
def test_kg_dataset_triples_identical(name, scale):
    got = datasets.kg_dataset(name, seed=3, scale=scale)
    want = jax_datasets.kg_dataset(name, seed=3, scale=scale)
    assert (got.n_entities, got.n_relations, got.name) == (
        want.n_entities, want.n_relations, want.name)
    for split in ("train", "valid", "test"):
        _same(getattr(got, split), getattr(want, split))


def test_fb15k_and_wikidata5m_shapes():
    got = datasets.fb15k(scale=0.01)
    assert (got.n_entities, got.n_relations) == (149, 13)
    _same(got.train, jax_datasets.fb15k(scale=0.01).train)
    assert datasets.wikidata5m(scale=0.0).n_entities == 200


def test_triple_directory_reads_like_jax(tmp_path):
    root = tmp_path / "FB15k"
    root.mkdir()
    (root / "entities.dict").write_text("0\ta\n1\tb\n")
    (root / "relations.dict").write_text("0\tlikes\n")
    (root / "train.txt").write_text("a\tlikes\tb\nc\thates\ta\nbad line\n")
    with gzip.open(root / "test.txt.gz", "wt") as f:
        f.write("b\tlikes\tc\n")
    got = datasets.kg_dataset("fb15k", root=str(tmp_path))
    want = jax_datasets.kg_dataset("fb15k", root=str(tmp_path))
    assert (got.n_entities, got.n_relations) == (3, 2) == (
        want.n_entities, want.n_relations)
    for split in ("train", "valid", "test"):
        _same(getattr(got, split), getattr(want, split))
    assert datasets._load_triples_dir(str(tmp_path / "none")) is None


# ------------------------------------------------------------ partitions
@pytest.mark.parametrize("fn,args", [
    ("soft_relation_partition", (4,)), ("soft_relation_partition", (3,)),
    ("balanced_relation_partition", (4,)), ("random_partition", (3, 5))])
def test_partitions_identical(fn, args):
    tr = _triples()
    _same(getattr(sampler, fn)(tr, *args),
          getattr(jax_sampler, fn)(tr, *args))


def test_long_tail_partition_identical():
    _same(sampler.get_long_tail_partition(23, 4),
          jax_sampler.get_long_tail_partition(23, 4))


def _stream(batches):
    return [(b.h, b.r, b.t, b.neg_ids, b.neg_mode) for b in batches]


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("mode", ["head", "tail"])
@pytest.mark.parametrize("n_edges", [530, 40])
def test_chunked_sampler_batches_identical(exclude, mode, n_edges):
    tr = _triples(n=600, ne=20 if exclude else 100, seed=3)
    kw = dict(batch_size=64, neg_sample_size=8, neg_chunk_size=16,
              mode=mode, exclude_positive=exclude, seed=7)
    ids = np.arange(n_edges)
    n = 20 if exclude else 100
    _same(_stream(sampler.ChunkedEdgeSampler(tr, ids, n, **kw)),
          _stream(jax_sampler.ChunkedEdgeSampler(tr, ids, n, **kw)))


@pytest.mark.parametrize("ranks,rel_part", [(1, True), (4, True),
                                            (4, False)])
def test_train_dataset_and_iterator_streams_identical(ranks, rel_part):
    tr = _triples(n=1200)
    sides = []
    for mod in (sampler, jax_sampler):
        ds = mod.TrainDataset(tr, 300, 12, ranks=ranks, rel_part=rel_part)
        its = [mod.BidirectionalOneShotIterator(
            ds.create_sampler(32, 8, 8, mode="head", rank=k, seed=k),
            ds.create_sampler(32, 8, 8, mode="tail", rank=k, seed=k + ranks))
            for k in range(ranks)]
        sides.append((ds.edge_parts, ds.rel_parts, ds.cross_part,
                      ds.cross_rels,
                      [_stream([next(it) for _ in range(7)]) for it in its]))
    _same(*sides)
    assert [m for *_, m in sides[0][4][0]] == ["tail", "head"] * 3 + ["tail"]


def test_eval_sampler_identical():
    tr = _triples(n=100)
    _same(list(sampler.EvalSampler(tr, 32)),
          list(jax_sampler.EvalSampler(tr, 32)))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_partition_kg_books_read_across_packages(tmp_path, writer):
    tr = _triples(n=400, ne=80, nr=6)
    write = (sampler if writer == "port" else jax_sampler).partition_kg
    read = (jax_sampler if writer == "port" else sampler).load_kg_partition
    cfg = write(tr, 80, 6, 2, str(tmp_path / "ds"), graph_name="toy")
    want_parts = sampler.soft_relation_partition(tr, 2)
    for p in range(2):
        (h, r, t), meta, rel_part = read(cfg, p)
        eids = want_parts[0][p]
        _same((h, r, t, rel_part),
              (tr[0][eids], tr[1][eids], tr[2][eids], want_parts[1][p]))
        assert meta["num_parts"] == 2 and meta["n_entities"] == 80


def test_partition_entry_point_writes_the_jax_book(tmp_path):
    cfg = port_partition.main(["--workspace", str(tmp_path / "p"),
                               "--num_parts", "2", "--dataset_scale", "0.01",
                               "--graph_name", "fb"])
    ds = jax_datasets.kg_dataset("FB15k", scale=0.01)
    want = jax_sampler.partition_kg(ds.train, ds.n_entities, ds.n_relations,
                                    2, str(tmp_path / "j"), graph_name="fb")
    for p in range(2):
        _same(sampler.load_kg_partition(cfg, p)[0],
              jax_sampler.load_kg_partition(want, p)[0])


# -------------------------------------------------------------- scorers
def _blocks(model, d=8, b=12, c=3, n=5, seed=0):
    rng = np.random.default_rng(seed)
    dr = nn_kge.relation_dim(model, d)
    scale = 0.3 if model in ("RESCAL", "TransR") else 1.0
    return (rng.normal(size=(b, d)).astype(np.float32),
            (scale * rng.normal(size=(b, dr))).astype(np.float32),
            rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(c, n, d)).astype(np.float32))


def _kw(model):
    return {"emb_init": 0.7} if model == "RotatE" else {}


@pytest.mark.parametrize("model", SCORERS)
def test_positive_score_matches_jax(model):
    h, r, t, _ = _blocks(model)
    got = nn_kge.KGE_SCORERS[model](torch.from_numpy(h), torch.from_numpy(r),
                                    torch.from_numpy(t), gamma=5.0,
                                    **_kw(model))
    want = jax_nn.KGE_SCORERS[model](h, r, t, gamma=5.0, **_kw(model))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    assert nn_kge.relation_dim(model, 8) == jax_nn.relation_dim(model, 8)


@pytest.mark.parametrize("mode", ["head", "tail"])
@pytest.mark.parametrize("model", SCORERS)
def test_neg_score_matches_jax(model, mode):
    h, r, t, neg = _blocks(model)
    fixed = h if mode == "tail" else t
    got = nn_kge.neg_score(nn_kge.KGE_SCORERS[model], torch.from_numpy(fixed),
                           torch.from_numpy(r), torch.from_numpy(neg), 4,
                           neg_mode=mode, gamma=5.0, **_kw(model))
    want = jax_nn.neg_score(jax_nn.KGE_SCORERS[model], fixed, r, neg, 4,
                            neg_mode=mode, gamma=5.0, **_kw(model))
    assert got.shape == (12, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("adv", [False, True])
def test_neg_log_sigmoid_loss_matches_jax(adv):
    s = np.random.default_rng(1).normal(size=(6, 9)).astype(np.float32) * 3
    kw = dict(neg_adversarial_sampling=adv, adversarial_temperature=0.5)
    x = torch.from_numpy(s).requires_grad_()
    got = neg_log_sigmoid_loss(x, KGEConfig(**kw))
    want = jax_models.neg_log_sigmoid_loss(s, jax_models.KGEConfig(**kw))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OP_TOL)
    (g,) = torch.autograd.grad(got.sum(), x)
    want_g = jax.grad(lambda v: jax_models.neg_log_sigmoid_loss(
        v, jax_models.KGEConfig(**kw)).sum())(jnp.asarray(s))
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **OP_TOL)


@pytest.mark.parametrize("mode", ["head", "tail"])
@pytest.mark.parametrize("model", SCORERS)
def test_model_loss_and_row_gradients_match_jax(model, mode):
    """``KGEModel.loss`` (its lookups through ``gather_rows``) and the
    table gradients against ``jax.grad`` of the JAX model's loss."""
    rng = np.random.default_rng(2)
    kw = dict(model_name=model, n_entities=40, n_relations=7, hidden_dim=8,
              gamma=6.0, neg_adversarial_sampling=model == "ComplEx")
    cfg, jcfg = KGEConfig(**kw), jax_models.KGEConfig(**kw)
    dr = nn_kge.relation_dim(model, 8)
    params = {"entity": rng.normal(size=(40, 8)).astype(np.float32) * 0.5,
              "relation": rng.normal(size=(7, dr)).astype(np.float32) * 0.3}
    h, r, t = (rng.integers(0, n, 12).astype(np.int32)
               for n in (40, 7, 40))
    neg = rng.integers(0, 40, (3, 5)).astype(np.int32)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    got = KGEModel(cfg).loss(tp, tuple(map(torch.from_numpy, (h, r, t))),
                             torch.from_numpy(neg), neg_mode=mode)
    grads = torch.autograd.grad(got, [tp["entity"], tp["relation"]])
    jm = jax_models.KGEModel(jcfg)
    want, jg = jax.value_and_grad(
        lambda p: jm.loss(p, (h, r, t), neg, neg_mode=mode))(params)
    np.testing.assert_allclose(got.item(), float(want), **OP_TOL)
    for g, name in zip(grads, ("entity", "relation")):
        w = np.asarray(jg[name])
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(np.abs(w).max(), 1)


# -------------------------------------------------------------- adagrad
@pytest.mark.parametrize("with_null", [False, True])
def test_sparse_adagrad_matches_jax(with_null):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(20, 8)).astype(np.float32)
    state = np.abs(rng.normal(size=20)).astype(np.float32)
    ids = np.array([3, 7, 3, 11, 3] + ([-1, 7, -1] if with_null else []),
                   np.int64)
    grads = rng.normal(size=(len(ids), 8)).astype(np.float32)
    got_t, got_s = dense_push_adagrad(
        torch.from_numpy(table), torch.from_numpy(state), ids,
        torch.from_numpy(grads), lr=0.1)
    ref_t, ref_s = jax_embedding.dense_push_adagrad(table, state, ids, grads,
                                                    lr=0.1)
    np.testing.assert_allclose(got_t.numpy(), ref_t, **OP_TOL)
    np.testing.assert_allclose(got_s.numpy(), ref_s, **OP_TOL)
    if not with_null:
        jt, js = jax_runtime._sparse_adagrad_update(
            table, state, ids.astype(np.int32), grads, 0.1)
        np.testing.assert_allclose(got_t.numpy(), np.asarray(jt), **OP_TOL)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(js), **OP_TOL)
    untouched = np.setdiff1d(np.arange(20), ids)
    np.testing.assert_array_equal(got_t.numpy()[untouched], table[untouched])
    np.testing.assert_array_equal(got_s.numpy()[untouched], state[untouched])


def test_dense_lookup_null_rows_match_jax():
    table = np.random.default_rng(0).normal(size=(10, 4)).astype(np.float32)
    ids = np.array([3, -1, 0, 9, -1])
    got = dense_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_embedding.dense_lookup(table, ids)))


def test_push_plan_sums_long_targets_like_index_add():
    """A push with a target named more than ``CHUNK`` times (a hot
    negative, a frequent relation) has long rows in its plan, which the
    card's scatter sums in a second launch; the plain sum over the plan's
    index equals ``index_add_``."""
    rng = np.random.default_rng(4)
    ids = np.concatenate([np.full(3 * CHUNK + 5, 2), rng.integers(0, 50, 90)])
    plan = push_plan(ids)
    assert plan.scatter.long_rows.size >= 1
    assert plan.scatter.num_chunks >= 4
    np.testing.assert_array_equal(plan.rows[plan.inverse[:, 0]], ids)
    g = torch.from_numpy(rng.normal(size=(len(ids), 6)).astype(np.float32))
    acc = accumulate(g, plan.to("cpu"))
    want = torch.zeros(50, 6).index_add_(0, torch.from_numpy(ids), g)
    torch.testing.assert_close(acc, want[torch.from_numpy(plan.rows)],
                               rtol=0, atol=0)


# ------------------------------------------------------------- training
def _kg(scale=0.02):
    return jax_datasets.kg_dataset("fb15k", seed=1, scale=scale)


def _jax_step_losses(jt, ds, tk, steps):
    """The JAX ``KGETrainer``'s per-step losses over its own stream."""
    td = jax_sampler.TrainDataset(ds.train, ds.n_entities, ds.n_relations)
    chunk = tk["neg_chunk_size"]
    it = jax_sampler.BidirectionalOneShotIterator(
        td.create_sampler(tk["batch_size"], tk["neg_sample_size"], chunk,
                          mode="head", seed=tk["seed"]),
        td.create_sampler(tk["batch_size"], tk["neg_sample_size"], chunk,
                          mode="tail", seed=tk["seed"] + 1))
    losses = []
    for _ in range(steps):
        b = next(it)
        jt.params, jt.opt_state, loss = jt._step(
            jt.params, jt.opt_state, jnp.asarray(b.h), jnp.asarray(b.r),
            jnp.asarray(b.t), jnp.asarray(b.neg_ids), neg_mode=b.neg_mode)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("model,adv", [("ComplEx", True), ("ComplEx", False),
                                       ("TransE_l2", False),
                                       ("RotatE", True), ("SimplE", False),
                                       ("RESCAL", False), ("TransR", True),
                                       ("DistMult", True)])
def test_kge_trainer_matches_jax(model, adv):
    ds = _kg()
    kw = dict(model_name=model, n_entities=ds.n_entities,
              n_relations=ds.n_relations, hidden_dim=16, gamma=12.0,
              neg_adversarial_sampling=adv)
    tk = dict(lr=0.1, max_step=6, batch_size=64, neg_sample_size=16,
              neg_chunk_size=16, log_interval=3, seed=0)
    jt = jax_runtime.KGETrainer(jax_models.KGEConfig(**kw),
                                jax_runtime.KGETrainConfig(**tk))
    tr = KGETrainer(KGEConfig(**kw), KGETrainConfig(**tk), device="cpu")
    tr.load_state_dict(kge_state_from_numpy(jax.device_get(jt.params),
                                            jax.device_get(jt.opt_state)))
    want = _jax_step_losses(jt, ds, tk, 6)
    out = tr.train(sampler.TrainDataset(ds.train, ds.n_entities,
                                        ds.n_relations))
    assert out["steps"] == 6 and len(out["losses"]) == 6
    np.testing.assert_allclose(out["losses"], want, rtol=1e-5)
    for name, got in [*tr.params.items(),
                      *[(k + "_state", v) for k, v in tr.opt_state.items()]]:
        w = np.asarray(jt.params[name] if "state" not in name
                       else jt.opt_state[name[:-6]])
        assert np.abs(got.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


def test_kge_trainer_logs_like_the_reference(capsys):
    ds = _kg()
    tr = KGETrainer(KGEConfig(n_entities=ds.n_entities,
                              n_relations=ds.n_relations, hidden_dim=8),
                    KGETrainConfig(max_step=4, batch_size=32,
                                   neg_sample_size=4, log_interval=2),
                    device="cpu")
    out = tr.train(sampler.TrainDataset(ds.train, ds.n_entities,
                                        ds.n_relations))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "[Train]" in ln]
    assert [ln.split(" average")[0] for ln in lines] == [
        "[0][Train](2/4)", "[0][Train](4/4)"]
    assert float(lines[-1].split()[-1]) == pytest.approx(
        np.mean(out["losses"][2:]), rel=1e-5)
    assert out["loss"] == pytest.approx(np.mean(out["losses"]))


@pytest.mark.parametrize("filtered", [False, True])
def test_full_ranking_eval_matches_jax(filtered):
    ds = _kg()
    kw = dict(model_name="ComplEx", n_entities=ds.n_entities,
              n_relations=ds.n_relations, hidden_dim=16, gamma=12.0)
    rng = np.random.default_rng(5)
    params = {"entity": rng.normal(size=(ds.n_entities, 16)).astype(
        np.float32), "relation": rng.normal(size=(ds.n_relations, 16))
        .astype(np.float32)}
    ev = tuple(a[:150] for a in ds.test)
    everything = tuple(np.concatenate(x) for x in zip(ds.train, ds.test))
    got = full_ranking_eval(
        KGEModel(KGEConfig(**kw)),
        {k: torch.from_numpy(v) for k, v in params.items()}, ev,
        batch_size=64,
        filters=build_filter(everything, ds.n_entities) if filtered
        else None)
    want = jax_runtime.full_ranking_eval(
        jax_models.KGEModel(jax_models.KGEConfig(**kw)),
        {k: jnp.asarray(v) for k, v in params.items()}, ev, batch_size=64,
        filters=jax_runtime.build_filter(everything, ds.n_entities)
        if filtered else None)
    for k in ("MR", "HITS@1", "HITS@3", "HITS@10"):
        assert got[k] == want[k], k
    assert got["MRR"] == pytest.approx(want["MRR"], rel=1e-12)
    assert build_filter(everything, 0) == jax_runtime.build_filter(
        everything, 0)


# --------------------------------------------------------- configuration
@pytest.mark.parametrize("field,value,error", [
    # device negatives and clients are ported: an invalid value is
    # refused by the knob registry (the cases keep their earlier ids)
    pytest.param("neg_sampler", "Device", ValueError,
                 id="neg_sampler-device-NotImplementedError"),
    pytest.param("num_client", 0, ValueError,
                 id="num_client-2-NotImplementedError"),
    # relation shard_rules are ported: a rule whose spec is no spec is
    # refused (the case keeps its earlier id)
    pytest.param("shard_rules", (("relation", 7),), TypeError,
                 id="shard_rules-value2-NotImplementedError"),
    # the sentry fields are ported: an invalid value is refused by the
    # knob registry (the cases keep their earlier ids)
    pytest.param("sentry", "on", ValueError, id="sentry-True-TypeError"),
    pytest.param("quality_action", "explode", ValueError,
                 id="quality_action-halt-TypeError"),
    ("resume", "sometimes", ValueError)])
def test_unported_fields_raise(field, value, error):
    with pytest.raises(error):
        KGETrainConfig(**{field: value})


def test_entry_point_parses_the_launchers_flags():
    ap = tpukerun.build_parser()
    largs = ap.parse_args(["--train-entry-point", "train_kge.py",
                           "--hidden-dim", "64", "--max-step", "7"])
    argv = (["--graph_name", "kg", "--ip_config", "hosts", "--part_config",
             "ws/kg.json"] + shlex.split(tpukerun._train_flags(largs))
            + ["--num_dp", "2", "--test"])
    args = train_kge.parse_args(argv)
    assert (args.graph_name, args.ip_config, args.part_config) == (
        "kg", "hosts", "ws/kg.json")
    assert (args.model_name, args.hidden_dim, args.gamma, args.lr,
            args.batch_size, args.neg_sample_size, args.max_step,
            args.log_interval, args.save_path) == (
        "ComplEx", 64, 143.0, 0.25, 1024, 256, 7, 100, "ckpts")
    assert args.neg_adversarial_sampling and args.adversarial_temperature == 1
    assert args.eval and args.num_dp == 2 and args.num_mp == 1


@pytest.mark.parametrize("flags", [["--num_mp", "2"],
                                   ["--neg_sampler", "device"]])
def test_entry_point_refuses_unported_flags(flags):
    """Both flags are ported: with ``--num_dp`` they pass to the data
    (here a missing book); ``--neg_sampler device`` without ``--num_dp``
    is refused as the JAX entry point refuses it."""
    base = ["--part_config", "no-such.json", "--device", "cpu"]
    with pytest.raises(FileNotFoundError):
        train_kge.main(base + ["--num_dp", "2"] + flags)
    if "--neg_sampler" in flags:
        with pytest.raises(SystemExit):
            train_kge.main(base + flags)


def test_entry_point_trains_and_saves_like_jax(tmp_path):
    cfg = port_partition.main(["--workspace", str(tmp_path), "--num_parts",
                               "2", "--dataset_scale", "0.02"])
    save = tmp_path / "save"
    out = train_kge.main([
        "--part_config", cfg, "--hidden_dim", "8", "--batch_size", "32",
        "--neg_sample_size", "4", "--max_step", "4", "--log_interval", "2",
        "--save_path", str(save), "--device", "cpu", "--eval"])
    meta = json.load(open(cfg))
    with np.load(save / "kg_ComplEx_rank0.npz") as z:
        assert sorted(z.files) == ["entity", "relation"]
        assert z["entity"].shape == (meta["n_entities"], 8)
    assert len(out["losses"]) == 4 and 0 < out["eval"]["MRR"] <= 1
    assert os.path.exists(save)
