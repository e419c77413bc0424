"""The control on the card: at the cells' widths and batch over a
smaller graph, the program's checked steps pass the cell's limits, while
the reference in TF32 put in the program's place fails one of them, and
so does the reference with half of every batch left out of the loss.
Needs a CUDA card (``python -m pytest portbench/tests -m cuda``)."""

import pytest
import torch

from portbench import check, control, data
from portbench.tests.tiny import CELLS, tiny_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name, card, tmp_path,
                                                monkeypatch):
    monkeypatch.setattr(data, "CACHE", str(tmp_path))
    cell = tiny_cell(name, num_nodes=100_000, num_edges=1_200_000,
                     hidden=256, batch=1000)
    arrays = data.load_graph(cell.config["graph"])
    for seed in (2**31 + 21, 2**31 + 22):
        row = control.readings(cell, seed, arrays, card, controls=True)
        assert check.passes(check.judge(row["sound"], cell.limits)), row
        for fault in ("tf32", "half_batch"):
            assert not check.passes(check.judge(row[fault], cell.limits)), \
                (fault, row)
