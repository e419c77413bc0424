"""The port's models, and the converter that carries any of their
flax params trees into a state dict: the family is read from the
tree's top-level prefixes (a flat stack's ``FanoutSAGEConv_``,
``FanoutGATConv_``, ``FanoutGATv2Conv_``, ``GATConv_``, ``GraphConv_``,
``SAGEConv_``, ``WeightedSAGEConv_``; ``LinkPredModel``'s nested
``GraphSAGE_0`` with or without ``MLPPredictor_0``; ``RGCNLinkPredict``'s
``embed``, ``rgcn_<i>`` and ``w_rel``; ``GIN``'s ``Dense_<j>`` and
``GINConv_<i>``)."""

from typing import Dict

import torch

from dgl_operator_tpu_torch.models import flax_layout
from dgl_operator_tpu_torch.graph.graph import Graph
from dgl_operator_tpu_torch.models.gat import (  # noqa: F401
    GAT, DistGAT, DistGATv2, gat_inference, gat_layer, gatv2_inference)
from dgl_operator_tpu_torch.models.gcn import GCN
from dgl_operator_tpu_torch.models.gin import GIN, batch_graphs  # noqa: F401
from dgl_operator_tpu_torch.models.link_predict import (  # noqa: F401
    PREDICTORS, LinkPredModel, auc_score, bce_link_loss, split_edges)
from dgl_operator_tpu_torch.models.rgcn import (  # noqa: F401
    RGCNLinkPredict, Triples)
from dgl_operator_tpu_torch.models.sage import (  # noqa: F401
    DistSAGE, GraphSAGE, WeightedSAGE, sage_inference, sage_layer)

FAMILIES = {cls.flax_prefix: cls
            for cls in (DistSAGE, DistGAT, DistGATv2, GAT, GCN, GraphSAGE,
                        WeightedSAGE)}
# a nested tree's top-level prefixes, and its layout
NESTED = {frozenset(name.rsplit("_", 1)[0]
                    for name, _ in LinkPredModel.layout(p).values()):
          LinkPredModel.layout(p) for p in PREDICTORS}
# a tree of more than stacks of layers: an entry only it has, and its
# model's own converters
MARKED = {"w_rel": RGCNLinkPredict.flax_prefix,
          "GINConv_0": GIN.flax_prefix}


def flax_layout_of(tree) -> flax_layout.Layout:
    """The layout of a flax params tree of any of the port's model
    families: a model's own converters (:data:`MARKED`), a flat stack's
    layer prefix (:data:`FAMILIES`) or a nested model's layout
    (:data:`NESTED`)."""
    names = tree.get("params", tree)
    for mark, layout in MARKED.items():
        if mark in names:
            return layout
    found = frozenset(flax_layout.prefixes(tree))
    if found in NESTED:
        return NESTED[found]
    prefix = flax_layout.layer_prefix(tree)
    if prefix not in FAMILIES:
        raise ValueError(f"no model of the port has layers {prefix}_<i> "
                         f"(known: {sorted(FAMILIES)})")
    return prefix


def state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The state dict of a flax params tree of any of the port's model
    families (:func:`flax_layout_of`)."""
    return flax_layout.state_dict_from_flax(tree, flax_layout_of(tree))


def flax_params(model: torch.nn.Module) -> dict:
    """The flax params tree of ``model``'s weights, laid out by the
    model's ``flax_prefix``."""
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
