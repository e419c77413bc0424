"""The port's ``DistTrainer`` with ``DistGAT`` and ``DistGATv2`` vs the
JAX package's, and the entry point's ``--model`` arms.

One 4-part book of ``synthetic_node_clf(800, 4000, 16, 4, seed=3)``
written by the JAX partitioner (as ``tests/test_torch_dist.py`` builds
it). The JAX ``DistTrainer`` runs each stack in each feature layout on
a 4-slot virtual CPU mesh, once per module; the port's trainer starts
from its initial params and draws the same shuffles and sampling
streams, so its losses match within 1e-4 and its ``evaluate`` (the
local edge softmax of every slot, exact for core rows under the halo
invariant) gives the JAX accuracies and those of the single-graph
``gat_inference`` of the same weights. With the device sampler the port
is held against itself: the owner layout equals the replicated one,
and K = 2 equals K = 1, bit for bit. A ``ServeEngine`` of each stack,
loaded from the JAX trainer's final params as the JAX package exports
them, answers requests as the JAX engine does. Two gloo ranks through
the entry point (two parts each) train what one process trains,
within 1e-6 of each array's largest entry (their gradient sums add the
slots in another order).
"""

import jax
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph.partition import partition_graph
from dgl_operator_tpu.models import gat as jax_gat
from dgl_operator_tpu.parallel import make_mesh
from dgl_operator_tpu.runtime import DistTrainer as JaxDistTrainer
from dgl_operator_tpu.runtime import TrainConfig as JaxTrainConfig
from dgl_operator_tpu.runtime.checkpoint import export_for_serving
from dgl_operator_tpu.serve.engine import ServeConfig as JaxServeConfig
from dgl_operator_tpu.serve.engine import ServeEngine as JaxServeEngine
from dgl_operator_tpu_torch.examples import train_dist
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models import flax_params
from dgl_operator_tpu_torch.models.gat import (DistGAT, DistGATv2,
                                               gat_inference)
from dgl_operator_tpu_torch.parallel.bootstrap import RANK_ENV
from dgl_operator_tpu_torch.runtime.dist import DistTrainer
from dgl_operator_tpu_torch.runtime.loop import TrainConfig
from dgl_operator_tpu_torch.serve.engine import ServeConfig, ServeEngine
from test_torch_multiprocess import THREADS, _run_two_ranks
from test_torch_multiprocess import _hostfile as two_rank_hostfile
from test_torch_native import use_jax_graphcore
import torch_mp_worker as worker

FEAT, HIDDEN, HEADS, CLASSES = 16, 8, 2, 4
LAYOUTS = ("replicated", "owner")
STACKS = {"gat": (jax_gat.DistGAT, DistGAT),
          "gatv2": (jax_gat.DistGATv2, DistGATv2)}
TOL = dict(rtol=1e-4, atol=1e-4)


def _graph_args():
    return dict(num_nodes=800, num_edges=4000, feat_dim=FEAT,
                num_classes=CLASSES, seed=3)


def _cfg_kw(layout, **kw):
    return dict(dict(num_epochs=1, batch_size=32, lr=0.01, fanouts=(4, 4),
                     log_every=1000, eval_every=1, feats_layout=layout),
                **kw)


@pytest.fixture(autouse=True)
def jax_library(monkeypatch, tmp_path_factory):
    use_jax_graphcore(monkeypatch, tmp_path_factory)
    monkeypatch.delenv("TPU_OPERATOR_TUNED_MANIFEST", raising=False)


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        use_jax_graphcore(mp, tmp_path_factory)
        ds = jax_datasets.synthetic_node_clf(**_graph_args())
        out = tmp_path_factory.mktemp("torch_gat_dist")
        return partition_graph(ds.graph, "synth", 4, str(out))


@pytest.fixture(scope="module")
def jax_runs(book, tmp_path_factory):
    """Per (stack, layout): the JAX trainer's initial params, its run
    and its ``evaluate`` of the final params."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        use_jax_graphcore(mp, tmp_path_factory)
        mp.delenv("TPU_OPERATOR_TUNED_MANIFEST", raising=False)
        for kind, (jcls, _) in STACKS.items():
            for layout in LAYOUTS:
                tr = JaxDistTrainer(
                    jcls(hidden_feats=HIDDEN, out_feats=CLASSES,
                         num_heads=HEADS, dropout=0.0),
                    book, make_mesh(num_dp=4),
                    JaxTrainConfig(**_cfg_kw(layout), sentry=False))
                init = jax.device_get(tr._init_params())
                out = tr.train()
                runs[kind, layout] = (init, out)
    return runs


def _port(book, kind, layout, **kw):
    model = STACKS[kind][1](FEAT, HIDDEN, CLASSES, num_heads=HEADS,
                            dropout=0.0, device="cpu",
                            generator=torch.Generator().manual_seed(4))
    cfg = TrainConfig(**_cfg_kw(layout, dropout=0.0, **kw))
    return DistTrainer(model, book, cfg, device="cpu")


@pytest.fixture(scope="module")
def port_runs(book, jax_runs):
    return {key: (tr, tr.train(init_params=jax_runs[key][0]))
            for key in jax_runs
            for tr in [_port(book, *key)]}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", list(STACKS))
def test_dist_gat_matches_jax(jax_runs, port_runs, kind, layout):
    """Per-step losses within 1e-4 (the JAX record keeps each epoch's
    last), the final params within 1e-3, and ``evaluate``'s
    accuracies."""
    _, want = jax_runs[kind, layout]
    tr, got = port_runs[kind, layout]
    assert got["step"] == want["step"] == tr.steps_per_epoch
    for g_rec, w_rec in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g_rec["loss"], w_rec["loss"], **TOL)
        for key in ("val_acc", "test_acc"):
            assert g_rec[key] == pytest.approx(w_rec[key], abs=1e-4), key
    final = flax_params(tr.model)["params"]
    ref = jax.device_get(want["params"])["params"]
    for layer, subs in final.items():
        for sub, leaf in subs.items():
            leaves = leaf if isinstance(leaf, dict) else {"": leaf}
            for name, value in leaves.items():
                w = ref[layer][sub][name] if name else ref[layer][sub]
                np.testing.assert_allclose(value, np.asarray(w),
                                           rtol=1e-3, atol=1e-3,
                                           err_msg=f"{layer}/{sub}/{name}")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", list(STACKS))
def test_dist_evaluate_equals_single_graph_inference(port_runs, kind,
                                                     layout):
    """The slots' local edge softmax gives the whole graph's attention
    for every core row: ``evaluate`` has the accuracies of the
    single-graph inference of the same weights."""
    g = datasets.synthetic_node_clf(**_graph_args()).graph
    tr, _ = port_runs[kind, layout]
    with torch.no_grad():
        pred = gat_inference(tr.model, g, torch.from_numpy(
            g.ndata["feat"])).argmax(-1).numpy()
    accs = tr.evaluate()
    for mask in ("val_mask", "test_mask"):
        m = g.ndata[mask].astype(bool)
        single = float((pred[m] == g.ndata["label"][m]).mean())
        assert accs[mask] == pytest.approx(single, abs=1e-6), mask


@pytest.mark.parametrize("kind", list(STACKS))
def test_dist_gat_device_sampler_owner_equals_replicated(book, kind):
    """The device sampler with a GAT stack: the owner layout trains what
    the replicated one trains, and K = 2 what K = 1 trains, bit for
    bit."""
    outs = {}
    for layout in LAYOUTS:
        for k in (1, 2):
            outs[layout, k] = _port(book, kind, layout, sampler="device",
                                    steps_per_call=k, num_epochs=2,
                                    eval_every=2).train()
    want = outs["replicated", 1]
    losses = [x for r in want["history"] for x in r["losses"]]
    assert np.isfinite(losses).all()
    for key, got in outs.items():
        assert [x for r in got["history"] for x in r["losses"]] == losses, \
            key
        for name, v in want["params"].items():
            assert torch.equal(got["params"][name], v), (key, name)
    assert want["history"][-1]["val_acc"] >= 0


def _hostfile(tmp):
    path = f"{tmp}/hosts"
    with open(path, "w") as f:
        f.write("127.0.0.1 29500 w0 slots=1\n")
    return path


@pytest.mark.parametrize("sampler", ["host", "device"])
@pytest.mark.parametrize("model", ["gat", "gatv2"])
def test_entry_point_trains_attention_models(book, tmp_path, monkeypatch,
                                             model, sampler):
    """``--model gat|gatv2`` builds the stack the JAX entry point builds
    (2 heads of ``--num_hidden``) and trains it, and with ``--bf16``
    and ``--remat`` as well (bfloat16 layers, recomputed in the
    backward; the parameters stay float32 under their names)."""
    monkeypatch.delenv("TPU_OPERATOR_DIST", raising=False)
    monkeypatch.delenv(RANK_ENV, raising=False)
    argv = ["--graph_name", "synth", "--ip_config", _hostfile(tmp_path),
            "--part_config", book, "--num_epochs", "1", "--batch_size",
            "32", "--fan_out", "4,4", "--num_hidden", str(HIDDEN),
            "--eval_every", "1", "--device", "cpu", "--model", model,
            "--sampler", sampler]
    out = train_dist.main(argv)
    assert out["step"] > 0
    assert np.isfinite([x for r in out["history"]
                        for x in r["losses"]]).all()
    assert 0 <= out["history"][-1]["val_acc"] <= 1
    layers = {k.split(".")[1] for k in out["params"]}
    assert layers == {"0", "1"}
    key = "layers.0.attn_l" if model == "gat" else "layers.0.attn"
    assert tuple(out["params"][key].shape) == (1, 2, HIDDEN)
    for flag in ("--bf16", "--remat"):
        knob = train_dist.main(argv + [flag])
        assert knob["step"] == out["step"]
        assert np.isfinite([x for r in knob["history"]
                            for x in r["losses"]]).all()
        assert {k: (v.dtype, tuple(v.shape))
                for k, v in knob["params"].items()} == \
            {k: (v.dtype, tuple(v.shape)) for k, v in out["params"].items()}


@pytest.mark.parametrize("kind", list(STACKS))
def test_serve_engine_matches_jax(book, jax_runs, tmp_path, kind):
    """The JAX trainer's final params, exported by the JAX package, in
    both engines: logits within 1e-4 and the same predictions."""
    jcls, pcls = STACKS[kind]
    params = jax.device_get(jax_runs[kind, "replicated"][1]["params"])
    path = export_for_serving(str(tmp_path / "export") + "/", params)
    kw = dict(fanouts=(4, 4), batch_size=16, cap_policy="worst",
              halo_cache_frac=0.25)
    want_eng = JaxServeEngine(jcls(hidden_feats=HIDDEN, out_feats=CLASSES,
                                   num_heads=HEADS, dropout=0.0),
                              book, params_path=path,
                              cfg=JaxServeConfig(**kw))
    got_eng = ServeEngine(pcls(FEAT, HIDDEN, CLASSES, num_heads=HEADS,
                               device="cpu"),
                          book, params_path=path, cfg=ServeConfig(**kw),
                          device="cpu")
    ids = np.random.default_rng(1).choice(800, 40, replace=False)
    for seed in (0, 5):
        want = want_eng.predict_logits(ids, sample_seed=seed)
        got = got_eng.predict_logits(ids, sample_seed=seed)
        assert got.shape == want.shape == (len(ids), CLASSES)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got_eng.predict(ids, sample_seed=seed),
                                      want_eng.predict(ids, sample_seed=seed))


def test_two_gloo_ranks_train_gat_as_one_process(book, tmp_path,
                                                 monkeypatch):
    argv = ["--graph_name", "synth", "--ip_config",
            two_rank_hostfile(str(tmp_path)), "--part_config", book,
            "--num_epochs", "1", "--batch_size", "32", "--fan_out", "4,4",
            "--num_hidden", str(HIDDEN), "--eval_every", "1", "--device",
            "cpu", "--model", "gat", "--feats_layout", "owner"]
    _, ranks = _run_two_ranks({"mode": "entry", "argv": argv},
                              str(tmp_path))
    monkeypatch.delenv("TPU_OPERATOR_DIST", raising=False)
    monkeypatch.delenv(RANK_ENV, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        want = worker.result_arrays("entry", train_dist.main(argv))
    finally:
        torch.set_num_threads(threads)
    for got in ranks:
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(
                got[k], v, rtol=0, atol=1e-6 * max(np.abs(v).max(), 1e-30),
                err_msg=k)
