"""The comparison with the timed path broken underneath: a run that
skips the look for a card, on the CPU at a tiny size, comes out not
correct for each fault a training cell on one chip can have (a step
that leaves the state unchanged; half of the batch left out of the
loss, the mean over the rest; a later step of the first call that draws
another sample). The exchange between chips does not exist on one chip,
and a training cell serves no answer to alter."""

import pytest
import torch

from portbench import data
from portbench.drivers import closed_train
from portbench.tests.tiny import CELLS, tiny_cell


def _run(name, tmp_path, monkeypatch):
    monkeypatch.setattr(data, "CACHE", str(tmp_path))
    return closed_train.run(tiny_cell(name), 2**31 + 55, 0.3, False,
                            torch.device("cpu"), 0.0)


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged(name, tmp_path, monkeypatch):
    from dgl_operator_tpu_torch.runtime import loop

    make_adam = loop.make_adam

    def frozen(params, cfg, device):
        opt = make_adam(params, cfg, device)
        opt.step = lambda closure=None: None
        return opt

    monkeypatch.setattr(loop, "make_adam", frozen)
    rec = _run(name, tmp_path, monkeypatch)
    assert not rec["correct"]
    c = rec["compared"]
    # no moment and no change: a leaf at least the median's reads 1, a
    # smaller one its share of the median
    assert c.get("delta_gap", c.get("delta_median_gap"))["value"] > 0.5
    assert c.get("grad_gap", c.get("grad_median_gap"))["value"] > 0.5


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out(name, tmp_path, monkeypatch):
    from dgl_operator_tpu_torch.runtime import loop

    masked_loss = loop.masked_loss

    def half(logits, labels, seeds):
        seeds = seeds.clone()
        seeds[seeds.shape[0] // 2:] = -1
        return masked_loss(logits, labels, seeds)

    monkeypatch.setattr(loop, "masked_loss", half)
    rec = _run(name, tmp_path, monkeypatch)
    assert not rec["correct"]
    c = rec["compared"]
    assert c["loss_gap"]["value"] > c["loss_gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_a_later_steps_draw_altered(name, tmp_path, monkeypatch):
    """The third step of the first K-step call draws with the fourth's
    key: its gathered rows are compared as exactly as the first step's
    (the blocks' validity does not depend on the draw)."""
    from dgl_operator_tpu_torch.runtime import loop

    draw_key = loop.draw_key

    def shifted(seed, gstep=None):
        if gstep is None:
            return draw_key(seed)
        return draw_key(seed, gstep + (gstep == 2).long())

    monkeypatch.setattr(loop, "draw_key", shifted)
    rec = _run(name, tmp_path, monkeypatch)
    assert not rec["correct"]
    assert rec["compared"]["rows_gap"]["value"] > 0
