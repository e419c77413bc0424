"""GraphSAGE link prediction with negative sampling and AUC.

The counterpart of ``dgl_operator_tpu/models/link_predict.py`` (the
reference's ``4_link_predict.py``): a two-layer ``GraphSAGE`` encoder,
a dot or MLP predictor over the positive and negative edge sets (each a
``DeviceGraph`` over the same nodes), the BCE loss and the ROC-AUC.
:func:`split_edges` is numpy and draws the JAX package's split bit for
bit from the same seed.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.graph.graph import DeviceGraph, Graph
from dgl_operator_tpu_torch.models.sage import GraphSAGE
from dgl_operator_tpu_torch.nn.predictors import DotPredictor, MLPPredictor

PREDICTORS = ("dot", "mlp")


class LinkPredModel(nn.Module):
    """``encoder``: ``GraphSAGE(in, hidden, hidden)`` over the message
    graph; ``predictor``: ``DotPredictor`` or ``MLPPredictor(hidden,
    hidden)``; drawn on the CPU from ``generator`` (a fresh generator
    seeded 0 when None) in that order, then moved to ``device``. Its
    flax tree is nested (``GraphSAGE_0/SAGEConv_<i>``,
    ``MLPPredictor_0/Dense_<j>``): ``flax_prefix`` is that layout."""

    def __init__(self, in_feats: int, hidden_feats: int,
                 predictor: str = "dot", device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if predictor not in PREDICTORS:
            raise ValueError(f"predictor must be one of {PREDICTORS}, got "
                             f"{predictor!r}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.encoder = GraphSAGE(in_feats, hidden_feats, hidden_feats,
                                 device="cpu", generator=generator)
        self.predictor = (DotPredictor() if predictor == "dot" else
                          MLPPredictor(hidden_feats, hidden_feats,
                                       device="cpu", generator=generator))
        self.flax_prefix = self.layout(predictor)
        self.to(device)

    @staticmethod
    def layout(predictor: str) -> Dict[str, Tuple[str, str]]:
        """The nested flax layout (``models/flax_layout.py``) of the model
        with ``predictor``: a dot predictor has no parameters."""
        out = {"encoder": (GraphSAGE.flax_name, GraphSAGE.flax_prefix)}
        if predictor == "mlp":
            out["predictor"] = (MLPPredictor.flax_name,
                                MLPPredictor.flax_prefix)
        return out

    def forward(self, g: DeviceGraph, x: torch.Tensor, pos_g: DeviceGraph,
                neg_g: DeviceGraph) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.encoder(g, x)
        return self.predictor(pos_g, h), self.predictor(neg_g, h)


def bce_link_loss(pos_score: torch.Tensor, neg_score: torch.Tensor,
                  pos_mask: Optional[torch.Tensor] = None,
                  neg_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross-entropy of pos = 1 / neg = 0 scores, the stable
    sigmoid form, averaged over the entries whose mask is set (pass the
    pos and neg graphs' ``edge_mask`` when they are padded)."""
    scores = torch.cat([pos_score, neg_score])
    labels = torch.cat([torch.ones_like(pos_score),
                        torch.zeros_like(neg_score)])
    w = torch.cat([torch.ones_like(pos_score) if pos_mask is None
                   else pos_mask,
                   torch.ones_like(neg_score) if neg_mask is None
                   else neg_mask])
    per_edge = (scores.clamp_min(0) - scores * labels
                + torch.log1p(torch.exp(-scores.abs())))
    return (per_edge * w).sum() / w.sum().clamp_min(1.0)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def auc_score(pos_score, neg_score) -> float:
    """ROC-AUC by the rank statistic (the JAX package's, ties ranked by
    numpy's ``argsort``)."""
    pos, neg = _numpy(pos_score), _numpy(neg_score)
    all_s = np.concatenate([pos, neg])
    ranks = np.argsort(np.argsort(all_s)) + 1
    pos_ranks = ranks[: len(pos)]
    auc = (pos_ranks.sum() - len(pos) * (len(pos) + 1) / 2) / (
        len(pos) * max(len(neg), 1))
    return float(auc)


def split_edges(g: Graph, test_frac: float = 0.1,
                seed: int = 0) -> Dict[str, Graph]:
    """Train / test positive and negative edge sets (the reference's
    ``4_link_predict.py:55-77``): the test positives are taken out of
    the message-passing graph ``train_g``, and as many negatives as
    edges are drawn from non-edges (random pairs, self-pairs and edges
    filtered out in draw order)."""
    rng = np.random.default_rng(seed)
    ne = g.num_edges
    perm = rng.permutation(ne)
    n_test = int(ne * test_frac)
    test_pos, train_pos = perm[:n_test], perm[n_test:]
    edge_set = set(zip(g.src.tolist(), g.dst.tolist()))
    neg_src, neg_dst = [], []
    while len(neg_src) < ne:
        s = rng.integers(0, g.num_nodes, size=ne)
        d = rng.integers(0, g.num_nodes, size=ne)
        for u, v in zip(s, d):
            if u != v and (u, v) not in edge_set:
                neg_src.append(u)
                neg_dst.append(v)
                if len(neg_src) >= ne:
                    break
    neg_src = np.array(neg_src[:ne], np.int32)
    neg_dst = np.array(neg_dst[:ne], np.int32)

    def eg(src, dst):
        return Graph(src, dst, g.num_nodes)

    return {
        "train_g": g.edge_subgraph(train_pos),
        "train_pos": eg(g.src[train_pos], g.dst[train_pos]),
        "train_neg": eg(neg_src[n_test:], neg_dst[n_test:]),
        "test_pos": eg(g.src[test_pos], g.dst[test_pos]),
        "test_neg": eg(neg_src[:n_test], neg_dst[:n_test]),
    }
