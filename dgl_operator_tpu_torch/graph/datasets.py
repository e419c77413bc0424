"""Synthetic node-classification datasets.

The generators draw from numpy in the same order as the JAX package's
``graph/datasets.py``, so the same seed gives the same graph, features,
labels and splits in both packages. Reading staged on-disk copies of
the real datasets is left to a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from dgl_operator_tpu_torch.graph.graph import Graph


@dataclasses.dataclass
class NodeClfDataset:
    graph: Graph
    num_classes: int
    name: str = "synthetic"


def _power_law_edges(rng: np.random.Generator, num_nodes: int,
                     num_edges: int, alpha: float = 1.2
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Preferential-attachment-ish edge generator: dst drawn ~ rank^-alpha."""
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    dst = rng.choice(num_nodes, size=num_edges, p=probs).astype(np.int32)
    src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int32)
    keep = src != dst
    return src[keep], dst[keep]


def _make_splits(g: Graph, rng: np.random.Generator,
                 train_frac=0.6, val_frac=0.2) -> None:
    n = g.num_nodes
    perm = rng.permutation(n)
    n_tr, n_va = int(n * train_frac), int(n * val_frac)
    for k in ("train_mask", "val_mask", "test_mask"):
        g.ndata[k] = np.zeros(n, dtype=bool)
    g.ndata["train_mask"][perm[:n_tr]] = True
    g.ndata["val_mask"][perm[n_tr:n_tr + n_va]] = True
    g.ndata["test_mask"][perm[n_tr + n_va:]] = True


def _clustered_node_clf(name: str, num_nodes: int, num_edges: int,
                        feat_dim: int, num_classes: int, seed: int
                        ) -> NodeClfDataset:
    """Node-classification graph with label-correlated structure and
    class-dependent gaussian features (homophily like citation
    networks)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_nodes)
    src, dst = _power_law_edges(rng, num_nodes, num_edges)
    # rewire ~60% of edges to connect same-label nodes (homophily)
    same = rng.random(len(src)) < 0.6
    by_label = [np.nonzero(labels == c)[0] for c in range(num_classes)]
    src_label = labels[src]
    for c in range(num_classes):
        sel = np.nonzero(same & (src_label == c))[0]
        if len(sel) and len(by_label[c]):
            dst[sel] = rng.choice(by_label[c], size=len(sel))
    g = Graph(src, dst, num_nodes).add_reverse_edges()
    centers = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    feat = centers[labels] + 0.8 * rng.normal(
        size=(num_nodes, feat_dim)).astype(np.float32)
    g.ndata["feat"] = feat.astype(np.float32)
    g.ndata["label"] = labels.astype(np.int32)
    _make_splits(g, rng)
    return NodeClfDataset(g, num_classes, name)


def synthetic_node_clf(num_nodes: int, num_edges: int, feat_dim: int,
                       num_classes: int, seed: int = 0) -> NodeClfDataset:
    """Arbitrary-size homophilous node-classification graph."""
    return _clustered_node_clf("synthetic", num_nodes, num_edges, feat_dim,
                               num_classes, seed)


def ogbn_products(seed: int = 0, scale: float = 1.0) -> NodeClfDataset:
    """Synthetic graph with the ogbn-products schema: 2.45M nodes,
    100-dim features, 47 classes; ``scale`` shrinks the node and edge
    counts (30M generated edges, doubled by reversal, at scale 1)."""
    n = max(1000, int(2_449_029 * scale))
    e = max(5000, int(30_000_000 * scale))
    return _clustered_node_clf("ogbn-products", n, e, 100, 47, seed)
