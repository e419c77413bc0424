"""Edge-score predictors for link prediction.

The counterparts of ``dgl_operator_tpu/nn/predictors.py`` (the
reference's ``DotPredictor`` and ``MLPPredictor``): scores of the edges
of a ``DeviceGraph`` from node representations ``h``, both ends
gathered with ``gather_rows`` over the graph's transpose plans. Each
carries its flax module name (``flax_name``) for the weight carrier
(``models/flax_layout.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.graph.graph import DeviceGraph
from dgl_operator_tpu_torch.nn.conv import init_linear_
from dgl_operator_tpu_torch.ops.sddmm import gather_dst, gather_src, u_dot_v


class DotPredictor(nn.Module):
    """``score(u, v) = h_u . h_v``; no parameters."""

    flax_name = "DotPredictor_0"

    def forward(self, g: DeviceGraph, h: torch.Tensor) -> torch.Tensor:
        return u_dot_v(g, h, h)[:, 0]


class MLPPredictor(nn.Module):
    """``score(u, v) = Dense_1(relu(Dense_0([h_u || h_v])))``: ``layers``
    ``2 * in -> hidden -> 1``, drawn on the CPU from ``generator`` (a
    fresh generator seeded 0 when None) and moved to ``device``."""

    flax_name = "MLPPredictor_0"
    flax_prefix = "Dense"

    def __init__(self, in_feats: int, hidden: int, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.layers = nn.ModuleList([nn.Linear(2 * in_feats, hidden),
                                     nn.Linear(hidden, 1)])
        for layer in self.layers:
            init_linear_(layer, generator)
        self.to(resolve_device(device))

    def forward(self, g: DeviceGraph, h: torch.Tensor) -> torch.Tensor:
        cat = torch.cat([gather_src(g, h), gather_dst(g, h)], -1)
        return self.layers[1](torch.relu(self.layers[0](cat)))[:, 0]
