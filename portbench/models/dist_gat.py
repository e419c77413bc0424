"""Model kind ``dist_gat``: the port's ``DistGAT``, its initial weights,
and the arithmetic of one training step's work."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from portbench.arith import bounds, flops
from portbench.models._tree import positions


def layers(model: Dict) -> List[Tuple[int, int, int]]:
    """``(in, heads, width)`` of each layer: ``heads`` concatenated heads
    of ``hidden`` but the last, which has one head of ``out_feats``."""
    num = int(model["num_layers"])
    heads, hidden = int(model["heads"]), int(model["hidden"])
    out = []
    for i in range(num):
        din = int(model["in_feats"]) if i == 0 else heads * hidden
        last = i == num - 1
        out.append((din, 1 if last else heads,
                    int(model["out_feats"]) if last else hidden))
    return out


def build(model: Dict, device) -> torch.nn.Module:
    """The program's model, on ``device``."""
    from dgl_operator_tpu_torch.models.gat import DistGAT
    return DistGAT(int(model["in_feats"]), int(model["hidden"]),
                   int(model["out_feats"]), num_heads=int(model["heads"]),
                   num_layers=int(model["num_layers"]),
                   dropout=float(model["dropout"]),
                   negative_slope=float(model["negative_slope"]),
                   device=device)


def param_spec(model: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """``(name, shape, init, bound)`` of every leaf: the projection
    uniform with the variance 1 / fan_in, the attention vectors
    ``[1, H, D]`` uniform in glorot's bound."""
    out = []
    for i, (din, h, w) in enumerate(layers(model)):
        glorot = math.sqrt(6.0 / (h + w))
        out += [(f"layers.{i}.attn_l", (1, h, w), "uniform", glorot),
                (f"layers.{i}.attn_r", (1, h, w), "uniform", glorot),
                (f"layers.{i}.fc.weight", (h * w, din), "uniform",
                 math.sqrt(3.0 / din))]
    return out


def step_flops(model: Dict, masks: Sequence[torch.Tensor],
               valid_seeds: int) -> float:
    counts = flops.tree_counts(masks, valid_seeds)
    return sum(flops.gat_layer(c, din, h, w, input_grad=i > 0)
               for i, (c, (din, h, w)) in enumerate(zip(counts,
                                                        layers(model))))


def kernel_work(model: Dict, masks: Sequence[torch.Tensor],
                ids: torch.Tensor) -> List[Tuple[str, bounds.Work]]:
    """The port's launches in one step and the work each needs: the
    input rows' gather; per block the gathers of the source logits and
    of the source rows at every slot, and the backward scatter of each
    gathered table that needs a gradient (the logits always, the rows
    in every block but the first)."""
    work = [("gather_rows", bounds.gather_work(ids, layers(model)[0][0], 4))]
    scatters = []
    for i, (mask, (din, h, _)) in enumerate(zip(masks, layers(model))):
        idx = positions(mask).reshape(-1)
        n = mask.shape[0] * (mask.shape[1] + 1)
        work += [("gather_rows", bounds.gather_work(idx, h, 4)),
                 ("gather_rows", bounds.gather_work(idx, din, 4))]
        scatters.append(("scatter_add_rows", bounds.scatter_work(
            idx.view(-1, 1), None, n, h, 4)))
        if i > 0:
            scatters.append(("scatter_add_rows", bounds.scatter_work(
                idx.view(-1, 1), None, n, din, 4)))
    return work + scatters
