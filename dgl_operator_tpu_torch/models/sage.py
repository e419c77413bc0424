"""DistSAGE — the sampled GraphSAGE stack, and its full-graph inference.

An L-layer stack of ``FanoutSAGEConv`` with ReLU and, in ``train()``
mode, dropout between layers, consuming sampled blocks
outermost-first. :func:`sage_inference` applies the same weights layer
by layer over the whole graph with full neighborhoods (evaluation).

Weights cross between the packages in the flax layout
(``{"params": {"FanoutSAGEConv_i": {"self": {"kernel", "bias"},
"neigh": {"kernel"}, "pool": {"kernel", "bias"}}}}``):
:func:`state_dict_from_flax` and :func:`state_dict_to_flax` convert.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.graph.blocks import FanoutBlock
from dgl_operator_tpu_torch.graph.graph import Graph
from dgl_operator_tpu_torch.nn.conv import FanoutSAGEConv
from dgl_operator_tpu_torch.ops.spmm import gspmm

_LAYER_RE = re.compile(r"FanoutSAGEConv_(\d+)")


def dropout(h: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Zero each element with probability ``p`` and scale the kept ones
    by ``1 / (1 - p)`` (flax's ``nn.Dropout``); the keep mask is drawn
    with ``bernoulli_`` from ``generator`` (the device's default
    generator when None)."""
    keep = torch.empty_like(h).bernoulli_(1.0 - p, generator=generator)
    return h * keep / (1.0 - p)


class DistSAGE(nn.Module):
    """Sampled-path SAGE stack; ``forward`` returns float32 logits for
    the seed rows of the innermost block. ``dropout`` is the rate
    applied after each inner ReLU in ``train()`` mode."""

    def __init__(self, in_feats: int, hidden_feats: int, out_feats: int,
                 num_layers: int = 2, aggregator: str = "mean",
                 dropout: float = 0.5, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.aggregator = aggregator
        self.dropout = float(dropout)
        dims = [in_feats] + [hidden_feats] * (num_layers - 1) + [out_feats]
        self.layers = nn.ModuleList(
            FanoutSAGEConv(dims[i], dims[i + 1], aggregator, device="cpu",
                           generator=generator)
            for i in range(num_layers))
        self.to(device)

    def forward(self, blocks: Sequence[FanoutBlock], x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` draws the dropout masks (on ``x``'s device); it
        is read only in ``train()`` mode with a nonzero rate."""
        if len(blocks) != len(self.layers):
            raise ValueError(f"{len(self.layers)} layers need as many "
                             f"blocks, got {len(blocks)}")
        h = x
        for i, (layer, blk) in enumerate(zip(self.layers, blocks)):
            h = layer(blk, h)
            if i < len(self.layers) - 1:
                h = torch.relu(h)
                if self.training and self.dropout > 0:
                    h = dropout(h, self.dropout, generator)
        return h.float()


def sage_inference(model: DistSAGE, g: Graph, x: torch.Tensor
                   ) -> torch.Tensor:
    """Layer-wise full-graph inference with the sampled model's weights
    (the JAX package's ``sage_inference``): each layer aggregates over
    every in-neighbor of every node (``gspmm``) instead of a sampled
    fanout, then applies ``self(h) + neigh(agg)``, ReLU between
    layers, no dropout. ``x`` is ``[num_nodes, in_feats]`` on the
    model's device; returns float32 logits for every node. The mean
    and sum aggregators are ported; pool raises."""
    if model.aggregator not in ("mean", "sum"):
        raise NotImplementedError(
            f"sage_inference with the {model.aggregator!r} aggregator is "
            "not ported (it needs gspmm's max reduce)")
    h = x.float()
    for i, layer in enumerate(model.layers):
        agg = gspmm(g, "copy_u", model.aggregator, h)
        h = layer.self(h) + layer.neigh(agg)
        if i < len(model.layers) - 1:
            h = torch.relu(h)
    return h


def state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The ``DistSAGE`` state dict for a flax params tree (numpy leaves,
    with or without the top-level ``"params"`` key). A flax kernel is
    ``[in, out]``; a ``Linear`` weight is its transpose."""
    params = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}
    for name, layer in params.items():
        m = _LAYER_RE.fullmatch(name)
        if m is None:
            raise ValueError(f"unexpected params entry {name!r}; expected "
                             "FanoutSAGEConv_<i>")
        for sub, leaves in layer.items():
            key = f"layers.{m.group(1)}.{sub}"
            sd[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(
                np.asarray(leaves["kernel"], np.float32).T))
            if "bias" in leaves:
                sd[f"{key}.bias"] = torch.from_numpy(
                    np.array(leaves["bias"], np.float32))
    return sd


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The flax params tree (numpy leaves, under ``"params"``) of a
    ``DistSAGE`` state dict — the inverse of
    :func:`state_dict_from_flax`."""
    params: dict = {}
    for key, value in state_dict.items():
        _, i, sub, leaf = key.split(".")
        arr = value.detach().cpu().float().numpy()
        node = params.setdefault(f"FanoutSAGEConv_{i}", {}).setdefault(
            sub, {})
        if leaf == "weight":
            node["kernel"] = np.ascontiguousarray(arr.T)
        else:
            node["bias"] = arr.copy()
    return {"params": params}
