"""Custom message passing on Cora: two hand-built SAGE convolutions.

The counterpart of the JAX package's ``examples/message_passing/
train.py`` (the reference's ``3_message_passing.py``): ``SAGEConv(in,
hidden)`` -> ReLU -> ``SAGEConv(hidden, classes)``, or with
``--weighted`` the same shape of ``WeightedSAGEConv`` layers, each
message scaled by its edge's weight (uniform here, as there) before the
mean: ``gspmm``'s ``u_mul_e`` over the graph's plans. Trained full
graph with Adam through ``runtime/loop.py::train_full_graph``, with the
JAX example's flags. Run it as ``python -m
dgl_operator_tpu_torch.examples.message_passing``; it trains on the
card unless ``--device cpu`` is given. ``--dataset_scale`` below 1
shrinks the synthetic Cora (64-dim features). The weights are drawn
from ``--seed`` through an explicit generator; ``init_params`` (a flax
params tree) replaces them. :func:`main` returns the loop's result.
"""

from __future__ import annotations

import argparse

import torch

from dgl_operator_tpu_torch._device import resolve_device
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models import GraphSAGE, WeightedSAGE
from dgl_operator_tpu_torch.runtime.loop import TrainConfig, train_full_graph


def two_layer_sage(in_feats: int, hidden_feats: int, num_classes: int,
                   weighted: bool = False, device=None,
                   generator=None) -> torch.nn.Module:
    """The example's model (the JAX example's ``TwoLayerSAGE``):
    ``SAGEConv_0``, ``SAGEConv_1`` (mean), or with ``weighted``
    ``WeightedSAGEConv_0``, ``WeightedSAGEConv_1`` fed uniform edge
    weights."""
    cls = WeightedSAGE if weighted else GraphSAGE
    return cls(in_feats, hidden_feats, num_classes, device=device,
               generator=generator)


def main(argv=None, init_params=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num_epochs", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--weighted", action="store_true")
    ap.add_argument("--dataset_scale", type=float, default=1.0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the current CUDA card")
    ap.add_argument("--seed", type=int, default=0,
                    help="the seed of the model's weights")
    args, _ = ap.parse_known_args(argv)
    device = resolve_device(args.device)

    ds = datasets.cora() if args.dataset_scale >= 1.0 else \
        datasets.synthetic_node_clf(
            num_nodes=int(2708 * args.dataset_scale),
            num_edges=int(10556 * args.dataset_scale),
            feat_dim=64, num_classes=7, seed=0)
    g = ds.graph
    n_cls = int(g.ndata["label"].max()) + 1
    model = two_layer_sage(int(g.ndata["feat"].shape[1]), args.hidden, n_cls,
                           weighted=args.weighted, device=device,
                           generator=torch.Generator().manual_seed(args.seed))
    cfg = TrainConfig(num_epochs=args.num_epochs, lr=args.lr, eval_every=10)
    out = train_full_graph(model, g, cfg, init_params=init_params,
                           device=device)
    print(f"Final test accuracy: {out['test_acc']:.4f}")
    return out


if __name__ == "__main__":
    main()
