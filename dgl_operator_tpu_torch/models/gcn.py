"""Two-layer GCN for node classification (the JAX package's
``models/gcn.py``: the reference's Cora example, ``GraphConv(in,
hidden)`` -> ReLU -> ``GraphConv(hidden, classes)``), over a
``DeviceGraph``; parameter subtrees ``GraphConv_<i>``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.graph.graph import DeviceGraph
from dgl_operator_tpu_torch.nn.conv import GraphConv


class GCN(nn.Module):
    flax_prefix = "GraphConv"

    def __init__(self, in_feats: int, hidden_feats: int, num_classes: int,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.layers = nn.ModuleList([
            GraphConv(in_feats, hidden_feats, device="cpu",
                      generator=generator),
            GraphConv(hidden_feats, num_classes, device="cpu",
                      generator=generator)])
        self.to(device)

    def forward(self, g: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.layers[0](g, x))
        return self.layers[1](g, h)
