"""Node classification on Cora, full graph: a two-layer GCN, or GAT with
``--model gat``.

The counterpart of the JAX package's
``examples/node_classification/train.py`` (the reference's
``1_introduction.py``: a GraphConv stack, Adam at 1e-2, cross-entropy
on the train mask), with its flags, through
``runtime/loop.py::train_full_graph``. Run it as ``python -m
dgl_operator_tpu_torch.examples.node_classification``; it trains on the
card unless ``--device cpu`` is given. ``--dataset_scale`` below 1
shrinks the synthetic Cora (64-dim features) for a quick run. The
weights are drawn from ``--seed`` through an explicit generator.
:func:`main` returns the loop's result.
"""

from __future__ import annotations

import argparse

import torch

from dgl_operator_tpu_torch._device import resolve_device
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models import GAT, GCN
from dgl_operator_tpu_torch.runtime.loop import TrainConfig, train_full_graph


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num_epochs", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--model", choices=["gcn", "gat"], default="gcn")
    ap.add_argument("--num_heads", type=int, default=4)
    ap.add_argument("--dataset_scale", type=float, default=1.0,
                    help="shrink the synthetic Cora for smoke tests")
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
    feat_dim = int(g.ndata["feat"].shape[1])
    gen = torch.Generator().manual_seed(args.seed)
    if args.model == "gat":
        model = GAT(feat_dim, args.hidden, n_cls, num_heads=args.num_heads,
                    device=device, generator=gen)
    else:
        model = GCN(feat_dim, args.hidden, n_cls, device=device,
                    generator=gen)
    cfg = TrainConfig(num_epochs=args.num_epochs, lr=args.lr, eval_every=5)
    out = train_full_graph(model, g, cfg, device=device)
    print(f"Final test accuracy: {out['test_acc']:.4f}")
    return out


if __name__ == "__main__":
    main()
