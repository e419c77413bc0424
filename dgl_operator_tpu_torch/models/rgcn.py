"""RGCN link prediction on knowledge graphs.

The counterpart of ``dgl_operator_tpu/models/rgcn.py``: a learned
entity embedding read by a stack of ``RelGraphConv`` layers (basis
decomposition, ReLU between layers) over the train triples' graph,
then DistMult, ``<h[head], w_rel[rel], h[tail]>``, for each triple.
The three DistMult lookups are ``gather_rows`` over the plans of a
:class:`Triples` (built once on the host for a fixed set, the tails
alone for a set of corrupted negatives), so the backward is the port's
deterministic ``scatter_add_rows``; a set without plans serves a
forward with no gradient (evaluation).

Weights cross between the packages in the flax layout ``{"embed": [N,
H], "rgcn_<i>": {"basis": [B, I, O], "coef": [R, B], "loop":
{"kernel": [I, O]}}, "w_rel": [R, H]}``: :func:`state_dict_from_flax`
and :func:`state_dict_to_flax` convert (``basis`` is not transposed,
``loop`` is, as a Dense kernel); they are the model's ``flax_prefix``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.graph.graph import DeviceGraph, EdgeTypes
from dgl_operator_tpu_torch.models import flax_layout
from dgl_operator_tpu_torch.nn.conv import RelGraphConv, glorot_
from dgl_operator_tpu_torch.ops.gather import gather_rows
from dgl_operator_tpu_torch.ops.scatter import (ScatterPlan,
                                                ship_ids_and_plans,
                                                ship_int32)

LAYER_PREFIX = "rgcn"
TABLES = ("embed", "w_rel")


@dataclasses.dataclass
class Triples:
    """``(head, rel, tail)`` int32 ``[T]`` tensors on one device and, for
    a set that trains, the plans of each into the entity or relation
    table (``scatter_plan(ids[:, None], None, rows)``), or None."""

    head: torch.Tensor
    rel: torch.Tensor
    tail: torch.Tensor
    head_plan: Optional[ScatterPlan] = None
    rel_plan: Optional[ScatterPlan] = None
    tail_plan: Optional[ScatterPlan] = None
    n_entities: int = 0

    @classmethod
    def build(cls, head, rel, tail, n_entities: int, num_rels: int,
              device, plans: bool = True) -> "Triples":
        """Host arrays on ``device``, with their plans when ``plans``
        (all shipped in one copy)."""
        arrays = [np.asarray(a) for a in (head, rel, tail)]
        if plans:
            ids, plan_of = ship_ids_and_plans(
                arrays, [n_entities, num_rels, n_entities], device)
        else:
            ids, plan_of = ship_int32(arrays, device), [None] * 3
        return cls(*ids, *plan_of, n_entities=int(n_entities))

    def with_tails(self, tail: np.ndarray) -> "Triples":
        """The same heads and relations (and their plans) with other
        tails: a set of tail-corrupted negatives, its tail plan built
        when this set has plans."""
        tail = np.asarray(tail)
        dev = self.head.device
        if self.tail_plan is None:
            (t,) = ship_int32([tail], dev)
            return dataclasses.replace(self, tail=t)
        (t,), (plan,) = ship_ids_and_plans([tail], [self.n_entities], dev)
        return dataclasses.replace(self, tail=t, tail_plan=plan)


def state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The ``RGCNLinkPredict`` state dict of its flax params tree (numpy
    leaves, with or without the top-level ``"params"`` key)."""
    params = dict(tree.get("params", tree))
    sd = {k: torch.from_numpy(np.array(params.pop(k), np.float32))
          for k in TABLES}
    sd.update(flax_layout.state_dict_from_flax(params, LAYER_PREFIX))
    return sd


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The flax params tree (numpy leaves, under ``"params"``) of an
    ``RGCNLinkPredict`` state dict — the inverse of
    :func:`state_dict_from_flax`."""
    layers = {k: v for k, v in state_dict.items() if k not in TABLES}
    out = flax_layout.state_dict_to_flax(layers, LAYER_PREFIX)
    out["params"].update({k: state_dict[k].detach().cpu().float().numpy()
                          for k in TABLES})
    return out


class RGCNLinkPredict(nn.Module):
    """Entity embedding ``embed`` ``[N, H]`` read by ``num_layers``
    ``RelGraphConv(H, H, num_rels, num_bases)`` layers, then DistMult
    with ``w_rel`` ``[R, H]``. Drawn on the CPU from ``generator`` (a
    fresh generator seeded 0 when None) in the flax model's order
    (``embed``, each layer, ``w_rel``; flax's ``glorot_uniform``), then
    moved to ``device``."""

    flax_prefix = flax_layout.Converter(state_dict_from_flax,
                                        state_dict_to_flax)

    def __init__(self, n_entities: int, hidden_feats: int, num_rels: int,
                 num_bases: int = 8, num_layers: int = 2,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.embed = nn.Parameter(torch.empty(n_entities, hidden_feats))
        glorot_(self.embed, generator)
        self.layers = nn.ModuleList(
            RelGraphConv(hidden_feats, hidden_feats, num_rels,
                         num_bases=num_bases, device="cpu",
                         generator=generator)
            for _ in range(num_layers))
        self.w_rel = nn.Parameter(torch.empty(num_rels, hidden_feats))
        glorot_(self.w_rel, generator)
        self.to(device)

    def encode(self, g: DeviceGraph, etypes: EdgeTypes) -> torch.Tensor:
        """``[N, H]`` entity representations over the message graph."""
        h = self.embed
        for i, layer in enumerate(self.layers):
            h = layer(g, h, etypes)
            if i < len(self.layers) - 1:
                h = torch.relu(h)
        return h

    def score(self, h: torch.Tensor, t: Triples) -> torch.Tensor:
        """DistMult ``sum(h[head] * w_rel[rel] * h[tail])`` ``[T]``."""
        return (gather_rows(h, t.head, t.head_plan)
                * gather_rows(self.w_rel, t.rel, t.rel_plan)
                * gather_rows(h, t.tail, t.tail_plan)).sum(-1)

    def forward(self, g: DeviceGraph, etypes: EdgeTypes, pos: Triples,
                neg: Triples) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.encode(g, etypes)
        return self.score(h, pos), self.score(h, neg)
