"""Probe: is a K = 4 CUDA-graph capture invalidated when a dead trainer
(cyclic garbage owning its captured graph, CUDA events and pinned
buffers) is collected mid-capture?

    python3 capture_gc_probe.py unfixed|fixed plain|nan

On the card: three rounds of a full-width device-sampler
``SampledTrainer`` (K = 4) that trains (``plain``) or faults under
``numerics:nan:4`` (``nan``), then a second trainer that captures with
the cycle collector forced to run at every allocation. ``unfixed``
stubs out ``runtime/graphs.py``'s collector guard (collect before the
capture, none inside); ``fixed`` runs it. Prints one JSON line: each
round's ``ok`` or the capture's error."""
import gc
import json
import os
import sys
import tempfile
import types

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch  # noqa: E402

from dgl_operator_tpu_torch.graph import datasets  # noqa: E402
from dgl_operator_tpu_torch.launcher.chaos import CHAOS_ENV  # noqa: E402
from dgl_operator_tpu_torch.models.sage import DistSAGE  # noqa: E402
from dgl_operator_tpu_torch.obs import quality as Q  # noqa: E402
from dgl_operator_tpu_torch.runtime import graphs  # noqa: E402
from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,  # noqa
                                                 TrainConfig)

mode, variant = sys.argv[1], sys.argv[2]
if mode == "unfixed":
    graphs.gc = types.SimpleNamespace(collect=lambda: 0,
                                      disable=lambda: None,
                                      enable=lambda: None,
                                      isenabled=lambda: False)
ds = datasets.synthetic_node_clf(20000, 200000, 100, 47, seed=0)
ids = torch.arange(8000).numpy()


def trainer(**kw):
    cfg = TrainConfig(batch_size=1000, fanouts=(10, 25), num_epochs=1,
                      eval_every=0, dropout=0.0, sampler="device",
                      steps_per_call=4, **kw)
    return SampledTrainer(DistSAGE(100, 256, 47, dropout=0.0,
                                   device="cuda"), ds.graph, cfg,
                          train_ids=ids, device="cuda")


results = []
for _ in range(3):
    if variant == "nan":
        with tempfile.TemporaryDirectory() as ws:
            os.environ[CHAOS_ENV] = "numerics:nan:4"
            os.environ[Q.WORKSPACE_ENV] = ws
            try:
                trainer(quality_action="halt").train()
            except Q.NumericsFault:
                pass
            os.environ.pop(CHAOS_ENV)
            os.environ.pop(Q.WORKSPACE_ENV)
    else:
        trainer().train()
    gc.set_threshold(1, 1, 1)
    try:
        trainer().train()
        results.append("ok")
    except Exception as exc:  # noqa: BLE001
        results.append(f"{type(exc).__name__}: {str(exc)[:160]}")
        break
    finally:
        gc.set_threshold(700, 10, 10)
print(json.dumps({"mode": mode, "variant": variant, "results": results}),
      flush=True)
