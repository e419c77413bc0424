"""The data plane's card-only checks (skip without a card; import
nothing of the JAX package, so the card's machine collects them:
``python -m pytest -m cuda tests/test_torch_dataplane_cuda.py``): the
gather kernel on 1-byte rows of int8 and uint8 codes, and a remat stack
inside a captured K-step CUDA graph.
"""

import pytest
import torch

from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.ops import gather
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig

IN = 12


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 602, 37, 1024])
@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8])
def test_gather_kernel_of_codes_on_card(dtype, d):
    """``csrc/gather_rows.cu`` on 1-byte rows, bit for bit against the
    plain gather with int32 and int64 ids: 100-byte rows (4-byte
    moves), 602 (2-byte), 37 (single bytes) and 1,024 (the bulk
    path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(3)
    table = torch.randint(-127 if dtype == torch.int8 else 0, 127,
                          (5000, d), device="cuda", generator=g).to(dtype)
    idx = torch.randint(0, 5000, (2305,), device="cuda", generator=g)
    for idx_dtype in (torch.int32, torch.int64):
        before = gather.gather_rows.launches
        got = gather.gather_rows(table, idx.to(idx_dtype))
        torch.cuda.synchronize()
        assert gather.gather_rows.launches == before + 1
        assert torch.equal(got, gather.gather_rows_plain(table, idx))


@pytest.mark.cuda
def test_remat_in_captured_graph_on_card():
    """Device sampler, K = 4 (one CUDA graph replay a call): a remat
    stack's run equals the plain stack's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the capture has no CPU mode")
    g = datasets.synthetic_node_clf(2000, 10000, IN, 4, seed=6).graph
    outs = []
    for remat in (False, True):
        model = DistSAGE(IN, 16, 4, device="cuda", remat=remat,
                         generator=torch.Generator().manual_seed(0))
        cfg = TrainConfig(num_epochs=1, batch_size=64, fanouts=(3, 4),
                          eval_every=0, sampler="device", steps_per_call=4,
                          seed=1)
        outs.append(SampledTrainer(model, g, cfg, device="cuda").train())
    assert outs[0]["history"][0]["losses"] == outs[1]["history"][0]["losses"]
    for key, v in outs[0]["params"].items():
        assert torch.equal(outs[1]["params"][key], v), key
