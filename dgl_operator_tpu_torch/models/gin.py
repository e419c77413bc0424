"""GIN graph classification with a mean-nodes readout.

The counterpart of ``dgl_operator_tpu/models/gin.py``: a batch of small
graphs is packed into one padded disjoint union (:func:`batch_graphs`),
``GINConv`` layers run over it, and the readout is the mean of each
graph's node rows (``segment_mean`` over the node-to-graph ids, over the
batch's plan, so its backward is the port's ``gather_rows``), then a
Dense classifier.

Weights cross between the packages in the flax layout: GIN's MLPs are
adopted by the model, so layer ``i``'s two Dense layers are
``Dense_{2i}`` and ``Dense_{2i+1}`` at the top level, ``Dense_{2L}`` is
the classifier and ``GINConv_i`` holds only the 0-d ``eps``
(:func:`state_dict_from_flax`, :func:`state_dict_to_flax`: the model's
``flax_prefix``).
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.graph.graph import DeviceGraph, Graph
from dgl_operator_tpu_torch.models import flax_layout
from dgl_operator_tpu_torch.nn.conv import GINConv, init_linear_
from dgl_operator_tpu_torch.ops.scatter import (ScatterPlan,
                                                ship_ids_and_plans)
from dgl_operator_tpu_torch.ops.segment import segment_mean

_ENTRY = re.compile(r"(Dense|GINConv)_(\d+)")


class GraphBatch(NamedTuple):
    """A packed batch: the JAX package's ``(graph, feat, graph_id,
    mask)`` as tensors on one device, and the readout's plan
    (``scatter_plan`` of ``graph_id`` into ``num_graphs + 1`` segments)."""

    graph: DeviceGraph
    feat: torch.Tensor
    graph_id: torch.Tensor
    mask: torch.Tensor
    readout_plan: ScatterPlan


def batch_graphs(graphs: List[Graph], feat_key: str, pad_nodes: int,
                 pad_edges: int, device: DeviceLike = None) -> GraphBatch:
    """Pack ``graphs`` into one disjoint union of ``pad_nodes`` nodes and
    ``pad_edges`` edges on ``device`` (the card unless the CPU is asked
    for). The padded edges run from node 0 to the spare segment
    ``pad_nodes`` with ``edge_mask`` 0, as the JAX package re-pads them;
    here the graph is built at the padded node count, so its plans and
    ``dst`` agree. ``feat`` ``[pad_nodes, D]`` is zero past the real
    nodes, ``graph_id`` ``[pad_nodes]`` is ``len(graphs)`` there and
    ``mask`` ``[pad_nodes]`` is 1.0 on the real nodes."""
    device = resolve_device(device)
    srcs, dsts, feats, gids = [], [], [], []
    off = 0
    for i, g in enumerate(graphs):
        srcs.append(g.src + off)
        dsts.append(g.dst + off)
        feats.append(g.ndata[feat_key])
        gids.append(np.full(g.num_nodes, i, np.int32))
        off += g.num_nodes
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    if off > pad_nodes or len(src) > pad_edges:
        raise ValueError(f"batch needs nodes={off} edges={len(src)}, "
                         f"caps are {pad_nodes}/{pad_edges}")
    dg = Graph(src, dst, pad_nodes).to_device(device, pad_to=pad_edges)
    feat = np.concatenate(feats).astype(np.float32)
    feat = np.pad(feat, ((0, pad_nodes - off), (0, 0)))
    gid = np.concatenate(gids)
    gid = np.pad(gid, (0, pad_nodes - off), constant_values=len(graphs))
    (gid_t,), (plan,) = ship_ids_and_plans([gid], [len(graphs) + 1],
                                           device)
    mask = (torch.arange(pad_nodes, device=device) < off).float()
    return GraphBatch(dg, torch.from_numpy(feat).to(device), gid_t, mask,
                      plan)


def _linear_keys(num_layers: int) -> List[str]:
    """The state-dict prefixes of ``Dense_0 .. Dense_{2L}``."""
    return [f"layers.{i}.mlp.{j}" for i in range(num_layers)
            for j in (0, 2)] + ["classify"]


def state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The ``GIN`` state dict of its flax params tree (numpy leaves, with
    or without the top-level ``"params"`` key)."""
    params = tree.get("params", tree)
    dense = _linear_keys(sum(1 for n in params if n.startswith("GINConv_")))
    sd: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        m = _ENTRY.fullmatch(name)
        if m is None or (m.group(1) == "Dense" and int(m.group(2))
                         >= len(dense)):
            raise ValueError(f"unexpected GIN params entry {name!r}")
        i = int(m.group(2))
        if m.group(1) == "GINConv":
            sd[f"layers.{i}.eps"] = torch.tensor(
                float(np.asarray(node["eps"])), dtype=torch.float32)
            continue
        sd[f"{dense[i]}.weight"] = torch.from_numpy(np.array(
            np.asarray(node["kernel"], np.float32).T, order="C"))
        sd[f"{dense[i]}.bias"] = torch.from_numpy(
            np.array(node["bias"], np.float32))
    return sd


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The flax params tree (numpy leaves, under ``"params"``) of a
    ``GIN`` state dict — the inverse of :func:`state_dict_from_flax`."""
    L = sum(1 for k in state_dict if k.endswith(".eps"))

    def arr(key):
        return state_dict[key].detach().cpu().float().numpy()

    params = {f"GINConv_{i}": {"eps": np.asarray(arr(f"layers.{i}.eps"))}
              for i in range(L)}
    for j, key in enumerate(_linear_keys(L)):
        params[f"Dense_{j}"] = {
            "kernel": np.ascontiguousarray(arr(f"{key}.weight").T),
            "bias": arr(f"{key}.bias").copy()}
    return {"params": params}


class GIN(nn.Module):
    """``num_layers`` ``GINConv`` layers, each with the MLP ``Linear(in,
    hidden) -> ReLU -> Linear(hidden, hidden)`` (no activation between
    layers, as in the JAX model), the masked mean-nodes readout and the
    classifier ``Linear(hidden, num_classes)``. Flax infers the input
    width at ``init``; here it is ``in_feats``. Drawn on the CPU from
    ``generator`` (a fresh generator seeded 0 when None) and moved to
    ``device``."""

    flax_prefix = flax_layout.Converter(state_dict_from_flax,
                                        state_dict_to_flax)

    def __init__(self, in_feats: int, hidden_feats: int, num_classes: int,
                 num_layers: int = 2, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dims = [in_feats] + [hidden_feats] * num_layers
        self.layers = nn.ModuleList(
            GINConv(nn.Sequential(nn.Linear(dims[i], hidden_feats),
                                  nn.ReLU(),
                                  nn.Linear(hidden_feats, hidden_feats)))
            for i in range(num_layers))
        self.classify = nn.Linear(hidden_feats, num_classes)
        for lin in self.linears():
            init_linear_(lin, generator)
        self.to(device)

    def linears(self) -> List[nn.Linear]:
        """The Dense layers in the flax tree's order: each layer's MLP,
        then the classifier."""
        return [m for layer in self.layers for m in layer.mlp
                if isinstance(m, nn.Linear)] + [self.classify]

    def forward(self, g: DeviceGraph, x: torch.Tensor,
                graph_id: torch.Tensor, node_mask: torch.Tensor,
                num_graphs: int, readout_plan: Optional[ScatterPlan] = None
                ) -> torch.Tensor:
        """``[num_graphs, num_classes]`` logits; a padded node lands in
        segment ``num_graphs``, which is dropped. ``readout_plan``
        (``GraphBatch.readout_plan``) is what the readout sums over on
        the card, which raises without it."""
        h = x
        for layer in self.layers:
            h = layer(g, h)
        h = h * node_mask.unsqueeze(1)
        readout = segment_mean(h, graph_id, num_graphs + 1,
                               readout_plan)[:num_graphs]
        return self.classify(readout)
