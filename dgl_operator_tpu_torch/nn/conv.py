"""Graph convolution layers (``torch.nn``).

``FanoutSAGEConv`` is the sampled path's GraphSAGE layer: it consumes a
``FanoutBlock`` and aggregates with the dense masked reductions of
``ops/fanout.py``. Submodule names follow the flax layer's parameter
names (``self``, ``neigh``, ``pool``), so weights map one to one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.graph.blocks import FanoutBlock
from dgl_operator_tpu_torch.ops import fanout

AGGREGATORS = ("mean", "sum", "pool")


def init_linear_(layer: nn.Linear, generator: torch.Generator) -> None:
    """Variance-1/fan_in uniform weights (the variance of flax's
    ``lecun_normal`` default) and zero bias, drawn from ``generator``."""
    bound = math.sqrt(3.0 / layer.in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if layer.bias is not None:
            layer.bias.zero_()


class FanoutSAGEConv(nn.Module):
    """GraphSAGE layer on a sampled ``FanoutBlock``:
    ``self(h_dst) + neigh(agg)`` with ``h_dst = h_src[:num_dst]`` (the
    dst nodes are a prefix of the src nodes).

    Parameters are drawn on the CPU from ``generator`` (a fresh
    generator seeded 0 when none is given), so a seed gives the same
    weights on every device, then moved to ``device``.
    """

    def __init__(self, in_feats: int, out_feats: int,
                 aggregator: str = "mean", device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if aggregator not in AGGREGATORS:
            raise ValueError(f"aggregator must be one of {AGGREGATORS}, "
                             f"got {aggregator!r}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.aggregator = aggregator
        meta = torch.device("meta")
        if aggregator == "pool":
            self.pool = nn.Linear(in_feats, in_feats, device=meta)
        self.self = nn.Linear(in_feats, out_feats, device=meta)
        self.neigh = nn.Linear(in_feats, out_feats, bias=False, device=meta)
        self.to_empty(device="cpu")
        for layer in self.children():
            init_linear_(layer, generator)
        self.to(device)

    def forward(self, block: FanoutBlock, h_src: torch.Tensor
                ) -> torch.Tensor:
        h_dst = h_src[: block.num_dst]
        if self.aggregator == "mean":
            agg = fanout.fanout_mean(block, h_src)
        elif self.aggregator == "sum":
            agg = fanout.fanout_sum(block, h_src)
        else:
            agg = fanout.fanout_max(block, torch.relu(self.pool(h_src)))
        return self.self(h_dst) + self.neigh(agg)
