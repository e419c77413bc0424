"""DistSAGE — the sampled GraphSAGE stack, inference mode.

An L-layer stack of ``FanoutSAGEConv`` with ReLU between layers,
consuming sampled blocks outermost-first. Serving runs it without
dropout; training (dropout, backward kernels) comes with the trainer.

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
from dgl_operator_tpu_torch.nn.conv import FanoutSAGEConv

_LAYER_RE = re.compile(r"FanoutSAGEConv_(\d+)")


class DistSAGE(nn.Module):
    """Sampled-path SAGE stack; ``forward`` returns float32 logits for
    the seed rows of the innermost block."""

    def __init__(self, in_feats: int, hidden_feats: int, out_feats: int,
                 num_layers: int = 2, aggregator: str = "mean",
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dims = [in_feats] + [hidden_feats] * (num_layers - 1) + [out_feats]
        self.layers = nn.ModuleList(
            FanoutSAGEConv(dims[i], dims[i + 1], aggregator, device="cpu",
                           generator=generator)
            for i in range(num_layers))
        self.to(device)

    def forward(self, blocks: Sequence[FanoutBlock], x: torch.Tensor
                ) -> torch.Tensor:
        if len(blocks) != len(self.layers):
            raise ValueError(f"{len(self.layers)} layers need as many "
                             f"blocks, got {len(blocks)}")
        h = x
        for i, (layer, blk) in enumerate(zip(self.layers, blocks)):
            h = layer(blk, h)
            if i < len(self.layers) - 1:
                h = torch.relu(h)
        return h.float()


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
