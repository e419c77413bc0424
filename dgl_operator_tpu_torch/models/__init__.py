"""The port's models, and the converter that carries any of their
flax params trees into a state dict: the family is read from the
tree's layer prefix (``FanoutSAGEConv_``, ``FanoutGATConv_``,
``FanoutGATv2Conv_``, ``GATConv_``, ``GraphConv_``)."""

from typing import Dict

import torch

from dgl_operator_tpu_torch.models import flax_layout
from dgl_operator_tpu_torch.graph.graph import Graph
from dgl_operator_tpu_torch.models.gat import (  # noqa: F401
    GAT, DistGAT, DistGATv2, gat_inference, gat_layer, gatv2_inference)
from dgl_operator_tpu_torch.models.gcn import GCN
from dgl_operator_tpu_torch.models.sage import (  # noqa: F401
    DistSAGE, sage_inference, sage_layer)

FAMILIES = {cls.flax_prefix: cls
            for cls in (DistSAGE, DistGAT, DistGATv2, GAT, GCN)}


def state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The state dict of a flax params tree of any of the port's model
    families (:data:`FAMILIES`, picked by the tree's layer prefix)."""
    prefix = flax_layout.layer_prefix(tree)
    if prefix not in FAMILIES:
        raise ValueError(f"no model of the port has layers {prefix}_<i> "
                         f"(known: {sorted(FAMILIES)})")
    return flax_layout.state_dict_from_flax(tree, prefix)


def flax_params(model: torch.nn.Module) -> dict:
    """The flax params tree of ``model``'s weights, its layers named by
    the model's family."""
    return flax_layout.state_dict_to_flax(model.state_dict(),
                                          model.flax_prefix)


def inference_layer(model: torch.nn.Module, i: int, g: Graph,
                    h: torch.Tensor) -> torch.Tensor:
    """Layer ``i`` of a sampled stack's layer-wise full-graph inference
    over every in-edge of ``g`` (``sage_layer`` or ``gat_layer``, by the
    model's family), its activation included."""
    if isinstance(model, DistGAT):
        return gat_layer(model, i, g, h)
    if isinstance(model, DistSAGE):
        return sage_layer(model, i, g, h)
    raise TypeError(f"no layer-wise inference for {type(model).__name__}")


def full_graph_inference(model: torch.nn.Module, g: Graph,
                         x: torch.Tensor) -> torch.Tensor:
    """A sampled stack's float32 logits for every node of ``g`` by
    layer-wise inference (:func:`inference_layer`), no dropout."""
    h = x.float()
    for i in range(len(model.layers)):
        h = inference_layer(model, i, g, h)
    return h
