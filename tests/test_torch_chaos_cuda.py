"""The chaos ``numerics:nan`` drill inside a captured CUDA graph, on a
card (skips without one; imports nothing of the JAX package, so the
card's machine collects it: ``python -m pytest -m cuda
tests/test_torch_chaos_cuda.py``).

The device sampler at K = 4 replays one CUDA graph a call: the in-place
poison after call 1 (step 4) reaches the graph's storage, so the next
call (steps 5 to 8) faults at its end step, as the CPU run under the
same plan does.
"""

import pytest
import torch

from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.launcher import chaos
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.obs import quality as Q
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig

NAN_AT, K = 4, 4


@pytest.mark.cuda
def test_numerics_nan_poisons_the_captured_graph_on_the_card(
        tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured graph has no CPU mode")
    monkeypatch.setenv(chaos.CHAOS_ENV, f"numerics:nan:{NAN_AT}")
    monkeypatch.delenv("TPU_OPERATOR_RANK", raising=False)
    g = datasets.synthetic_node_clf(num_nodes=400, num_edges=2000,
                                    feat_dim=8, num_classes=4, seed=3).graph
    faults, graphs = {}, {}
    for dev in ("cuda", "cpu"):
        ws = tmp_path / dev
        ws.mkdir()
        monkeypatch.setenv(Q.WORKSPACE_ENV, str(ws))
        # 15 steps an epoch: calls of 4 steps to step 12, then single ones
        cfg = TrainConfig(num_epochs=1, batch_size=16, fanouts=(3, 3),
                          eval_every=0, dropout=0.0, sampler="device",
                          steps_per_call=K, quality_action="halt")
        tr = SampledTrainer(DistSAGE(8, 8, 4, dropout=0.0, device=dev), g,
                            cfg, device=dev)
        with pytest.raises(Q.NumericsFault) as got:
            tr.train()
        faults[dev] = got.value
        assert (ws / Q.NUMERICS_FIRED_MARKER).exists()
    got = {d: (f.step, f.partition, f.kind) for d, f in faults.items()}
    assert got["cuda"] == got["cpu"] == (NAN_AT + K, 0, "nonfinite_loss")
