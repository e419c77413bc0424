"""Model kind ``dist_sage``: the port's ``DistSAGE`` (mean aggregator),
its initial weights, and the arithmetic of one training step's work."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from portbench.arith import bounds, flops
from portbench.models._tree import positions


def dims(model: Dict) -> List[int]:
    return ([int(model["in_feats"])]
            + [int(model["hidden"])] * (int(model["num_layers"]) - 1)
            + [int(model["out_feats"])])


def build(model: Dict, device) -> torch.nn.Module:
    """The program's model, on ``device``."""
    from dgl_operator_tpu_torch.models.sage import DistSAGE
    if model["aggregator"] != "mean":
        raise ValueError("dist_sage runs the mean aggregator only")
    return DistSAGE(int(model["in_feats"]), int(model["hidden"]),
                    int(model["out_feats"]), int(model["num_layers"]),
                    "mean", float(model["dropout"]), device=device)


def param_spec(model: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """``(name, shape, init, bound)`` of every leaf: weights uniform with
    the variance 1 / fan_in, biases zero."""
    d = dims(model)
    out = []
    for i in range(len(d) - 1):
        bound = math.sqrt(3.0 / d[i])
        out += [(f"layers.{i}.self.weight", (d[i + 1], d[i]), "uniform",
                 bound),
                (f"layers.{i}.self.bias", (d[i + 1],), "zeros", 0.0),
                (f"layers.{i}.neigh.weight", (d[i + 1], d[i]), "uniform",
                 bound)]
    return out


def step_flops(model: Dict, masks: Sequence[torch.Tensor],
               valid_seeds: int) -> float:
    d = dims(model)
    counts = flops.tree_counts(masks, valid_seeds)
    return sum(flops.sage_mean_layer(c, d[i], d[i + 1], input_grad=i > 0)
               for i, c in enumerate(counts))


def kernel_work(model: Dict, masks: Sequence[torch.Tensor],
                ids: torch.Tensor) -> List[Tuple[str, bounds.Work]]:
    """The port's launches in one step and the work each needs: the
    input rows' gather, each block's ``fanout_agg`` and, for every block
    whose sources need a gradient (all but the first), its backward
    ``scatter_add_rows``."""
    d = dims(model)
    work = [("gather_rows", bounds.gather_work(ids, d[0], 4))]
    for i, mask in enumerate(masks):
        work.append(("fanout_agg",
                     bounds.fanout_work(positions(mask), mask, d[i], 4)))
    for i, mask in enumerate(masks):
        if i > 0:
            n = mask.shape[0] * (mask.shape[1] + 1)
            work.append(("scatter_add_rows", bounds.scatter_work(
                positions(mask), mask, n, d[i], 4)))
    return work
