"""The reference's models, written from the layers' published equations
in plain float32 torch, over tree-form blocks (``sampler.py``): a block
of ``n`` destination rows and fanout ``F`` reads ``n * (F + 1)`` source
rows, its destinations first, then slot ``(i, k)`` at ``n + i * F + k``.

- GraphSAGE, mean aggregator (Hamilton et al. 2017, DGL's ``SAGEConv``):
  ``W_self h_v + b + W_neigh mean_{u in N(v)} h_u``; ReLU and dropout
  between layers.
- GAT (Velickovic et al. 2018, DGL's ``GATConv``): per head ``z = W h``,
  ``e_vu = LeakyReLU(a_l . z_u + a_r . z_v)``, ``alpha`` the softmax of
  ``e`` over ``v``'s valid neighbour slots, ``out_v = sum_u alpha_vu
  z_u``; heads concatenated, one averaged head in the last layer; ELU and
  dropout between layers. Every source row is projected and then
  aggregated (the textbook order). A row with no valid slot gets 0.

Parameters are a dict of tensors under the names of the configuration's
model kind (``layers.<i>.<leaf>``). Dropout keeps each element with
probability ``1 - p`` and scales it by ``1 / (1 - p)``; the keep mask is
a ``bernoulli_`` draw from a generator the caller seeds, one draw of the
layer output's shape per dropout.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def dropout(h: torch.Tensor, p: float, gen: Optional[torch.Generator]
            ) -> torch.Tensor:
    keep = torch.empty_like(h).bernoulli_(1.0 - p, generator=gen)
    return h * keep / (1.0 - p)


def _neighbours(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n, f = mask.shape
    return h[n:n + n * f].view(n, f, *h.shape[1:])


def sage_layer(params: Params, i: int, h: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    n = mask.shape[0]
    m = mask.unsqueeze(-1).to(h.dtype)
    agg = (_neighbours(h, mask) * m).sum(1) / m.sum(1).clamp_min(1.0)
    p = f"layers.{i}."
    return (h[:n] @ params[p + "self.weight"].t() + params[p + "self.bias"]
            + agg @ params[p + "neigh.weight"].t())


def gat_layer(params: Params, i: int, h: torch.Tensor, mask: torch.Tensor,
              negative_slope: float, concat: bool) -> torch.Tensor:
    n, f = mask.shape
    p = f"layers.{i}."
    al, ar = params[p + "attn_l"][0], params[p + "attn_r"][0]   # [H, D]
    heads, width = al.shape
    z = (h[:n + n * f] @ params[p + "fc.weight"].t()).view(-1, heads, width)
    z_dst, z_src = z[:n], _neighbours(z, mask)            # [n, F, H, D]
    e = F.leaky_relu((z_src * al).sum(-1) + (z_dst * ar).sum(-1)
                     .unsqueeze(1), negative_slope)        # [n, F, H]
    valid = mask.unsqueeze(-1)
    # a row without a valid slot takes finite logits, so that neither
    # its softmax nor its gradient is NaN; its weights are zeroed below
    e = e.masked_fill(~valid & valid.any(1, keepdim=True), float("-inf"))
    alpha = torch.softmax(e, dim=1)
    alpha = torch.where(valid, alpha, torch.zeros((), device=h.device))
    out = (alpha.unsqueeze(-1) * z_src).sum(1)             # [n, H, D]
    return out.reshape(n, -1) if concat else out.mean(1)


def forward(kind: str, params: Params, masks: List[torch.Tensor],
            x: torch.Tensor, model: Dict,
            drop: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Logits of the seeds (the innermost block's destinations) for the
    model kind ``kind`` (``"dist_sage"`` or ``"dist_gat"``), its settings
    ``model`` (a configuration's ``model`` entry), the blocks' ``masks``
    outermost first, the outermost sources' rows ``x`` and ``drop``
    applied between layers."""
    h = x
    last = len(masks) - 1
    for i, mask in enumerate(masks):
        if kind == "dist_sage":
            h = sage_layer(params, i, h, mask)
            if i < last:
                h = drop(torch.relu(h))
        elif kind == "dist_gat":
            h = gat_layer(params, i, h, mask,
                          float(model["negative_slope"]), i < last)
            if i < last:
                h = drop(F.elu(h))
        else:
            raise ValueError(f"no reference for model kind {kind!r}")
    return h


def loss_of(logits: torch.Tensor, labels: torch.Tensor,
            seeds: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the valid seeds (``seeds >= 0``)."""
    valid = seeds >= 0
    return F.cross_entropy(logits[valid], labels[seeds[valid].long()].long())
