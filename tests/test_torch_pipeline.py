"""The owner layout's exchange pipeline, ``donate`` and the overlap
bookkeeping, on the CPU.

``DistTrainer`` with the host sampler in the owner layout enqueues each
batch's exchange ahead of its step: ``staged``, and ``fused`` at K = 1,
2 and 3, each with ``donate`` on and off, train bit-equal to the
synchronous exchange in the step (losses and parameters). With
``donate=False`` the tensors a caller took before training keep their
values. ``merge_intervals``, ``overlap_seconds`` and ``OverlapTracker``
give the JAX package's numbers, and the pipeline's knobs are validated
by the registry with the JAX messages.
"""

import numpy as np
import pytest
import torch

from dgl_operator_tpu.autotune import knobs as JK
from dgl_operator_tpu.runtime import timers as JT
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.partition import partition_graph
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.obs.live import get_feed, reset_feed
from dgl_operator_tpu_torch.runtime import timers as T
from dgl_operator_tpu_torch.runtime.dist import DistTrainer
from dgl_operator_tpu_torch.runtime.loop import TrainConfig

FEAT, HIDDEN, CLASSES = 16, 32, 4


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ("TPU_OPERATOR_CHAOS", "TPU_OPERATOR_TUNED_MANIFEST",
                 "TPU_OPERATOR_LIVE_PORT"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    g = datasets.synthetic_node_clf(800, 4000, FEAT, CLASSES, seed=3).graph
    return partition_graph(g, "pipe", 4, str(tmp_path_factory.mktemp("p")))


def _trainer(book, sync=False, **kw):
    model = DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.0, device="cpu",
                     generator=torch.Generator().manual_seed(4))
    cfg = TrainConfig(**dict(dict(num_epochs=1, batch_size=32, lr=0.01,
                                  fanouts=(4, 4), log_every=1000,
                                  eval_every=0, feats_layout="owner",
                                  dropout=0.0), **kw))
    tr = DistTrainer(model, book, cfg, device="cpu")
    if sync:
        # the exchange in the step, as train_step takes a host batch
        tr._pipelined = False
    return tr


def _run(tr):
    out = tr.train()
    return [x for r in out["history"] for x in r["losses"]], out


@pytest.fixture(scope="module")
def synchronous(book):
    tr = _trainer(book, sync=True)
    losses, out = _run(tr)
    assert "overlap_ratio" not in out["history"][0]
    return losses, out


@pytest.mark.parametrize("donate", [True, False])
@pytest.mark.parametrize("mode,depth", [("staged", 1), ("fused", 1),
                                        ("fused", 2), ("fused", 3)])
def test_pipelined_runs_equal_the_synchronous_run(book, synchronous, mode,
                                                  depth, donate):
    want_losses, want = synchronous
    reset_feed()
    tr = _trainer(book, pipeline_mode=mode, pipeline_depth=depth,
                  donate=donate)
    assert tr._pipelined
    losses, out = _run(tr)
    assert losses == want_losses
    assert all(torch.equal(v, want["params"][k])
               for k, v in out["params"].items())
    for rec, ref in zip(out["history"], want["history"]):
        assert rec["halo_rows_per_step"] == ref["halo_rows_per_step"]
        # on the CPU the exchange runs at its enqueue: nothing hidden
        assert rec["overlap_ratio"] == 0.0
    # the heartbeat carried the running ratio into the live feed
    assert get_feed().snapshot()["overlap_ratio"] == 0.0


def test_donate_false_keeps_what_a_caller_took(book):
    for donate in (True, False):
        tr = _trainer(book, donate=donate)
        taken = tr.model.state_dict()
        before = {k: v.clone() for k, v in taken.items()}
        _run(tr)
        kept = all(torch.equal(taken[k], before[k]) for k in taken)
        assert kept == (not donate)


def test_device_sampler_keeps_its_exchange_in_the_step(book):
    runs = []
    for mode in ("staged", "fused"):
        tr = _trainer(book, sampler="device", steps_per_call=2,
                      pipeline_mode=mode)
        assert not tr._pipelined
        runs.append(_run(tr)[0])
    assert runs[0] == runs[1] and np.isfinite(runs[0]).all()


def _spans(rng, n, zero=False):
    t0 = rng.uniform(0, 10, n)
    w = 0.0 if zero else rng.uniform(-0.5, 2.0, n)
    return [(float(a), float(a + b)) for a, b in zip(t0, np.broadcast_to(
        w, (n,)))]


@pytest.mark.parametrize("seed", range(6))
def test_overlap_math_equals_jax(seed):
    rng = np.random.default_rng(seed)
    ex, co = _spans(rng, 12, zero=seed == 5), _spans(rng, 9)
    assert T.merge_intervals(ex) == JT.merge_intervals(ex)
    assert T.overlap_seconds(ex, co) == JT.overlap_seconds(ex, co)
    mine, theirs = T.OverlapTracker(), JT.OverlapTracker()
    for tr in (mine, theirs):
        assert tr.ratio() is None
        for a, b in ex:
            tr.add_exchange(a, b)
        for a, b in co:
            tr.add_compute(a, b)
    assert mine.ratio() == theirs.ratio()
    mine.reset()
    assert mine.ratio() is None


@pytest.mark.parametrize("field,value", [
    ("pipeline_mode", "staged"), ("pipeline_mode", "async"),
    ("pipeline_depth", 4), ("pipeline_depth", 0), ("donate", False),
    ("donate", 1.5), ("gather_depth", 1), ("gather_depth", -2)])
def test_pipeline_knobs_are_validated_as_jax(field, value):
    try:
        want = JK.validate(field, value)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            TrainConfig(**{field: value})
        assert str(got.value) == str(exc)
        return
    assert getattr(TrainConfig(**{field: value}), field) == want
