"""Graph classification with GIN and a mean-nodes readout.

The counterpart of the JAX package's ``examples/graph_classification/
train.py``: the PROTEINS-shaped synthetic set (``datasets.gin_dataset``),
batches of whole graphs packed into one padded disjoint union at static
caps (the largest graph's node and edge counts times the batch size;
``models/gin.py::batch_graphs``), a two-layer ``GIN`` trained by Adam on
the cross-entropy over the first 80% of the graphs in the order of
``np.random.default_rng(0)``, then the accuracy over the full batches of
the rest. Run it as ``python -m
dgl_operator_tpu_torch.examples.graph_classification``; it trains on
the card unless ``--device cpu`` is given. The weights are drawn from
``--seed`` through an explicit generator; ``init_params`` (a flax
params tree) replaces them. :func:`main` returns ``{"test_acc",
"history", "params"}``: ``history`` holds each epoch's step losses.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from dgl_operator_tpu_torch._device import resolve_device
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models import (GIN, batch_graphs, flax_params,
                                           state_dict_from_flax)


def main(argv=None, init_params=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num_epochs", type=int, default=20)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--num_graphs", type=int, default=300)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the current CUDA card")
    ap.add_argument("--seed", type=int, default=0,
                    help="the seed of the model's weights")
    args, _ = ap.parse_known_args(argv)
    device = resolve_device(args.device)

    ds = datasets.gin_dataset(num_graphs=args.num_graphs)
    graphs, labels = ds.graphs, np.asarray(ds.labels)
    n_classes = int(labels.max()) + 1
    # static caps: the largest graph's sizes times the batch
    pad_nodes = max(g.num_nodes for g in graphs) * args.batch_size
    pad_edges = max(g.num_edges for g in graphs) * args.batch_size

    model = GIN(ds.dim_nfeats, args.hidden, n_classes, device=device,
                generator=torch.Generator().manual_seed(args.seed))
    if init_params is not None:
        model.load_state_dict(state_dict_from_flax(init_params))
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    B = args.batch_size

    def make_batch(idx):
        b = batch_graphs([graphs[i] for i in idx], "attr", pad_nodes,
                         pad_edges, device)
        lab = torch.from_numpy(labels[idx].astype(np.int64)).to(device)
        return b, lab

    def logits_of(b):
        return model(b.graph, b.feat, b.graph_id, b.mask, B,
                     b.readout_plan)

    rng = np.random.default_rng(0)
    n_train = int(0.8 * len(graphs))
    history = []
    for epoch in range(args.num_epochs):
        order = rng.permutation(n_train)
        losses = []
        for s in range(0, n_train - B + 1, B):
            b, lab = make_batch(order[s:s + B])
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(logits_of(b), lab)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        history.append(losses)
        if epoch % 5 == 0:
            print(f"epoch {epoch} loss {np.mean(losses):.4f}")

    # test accuracy over full batches
    correct = total = 0
    with torch.no_grad():
        for s in range(n_train, len(graphs) - B + 1, B):
            idx = np.arange(s, s + B)
            b, lab = make_batch(idx)
            correct += int((logits_of(b).argmax(-1) == lab).sum())
            total += B
    acc = correct / max(total, 1)
    print(f"Test accuracy: {acc:.4f}")
    return {"test_acc": acc, "history": history, "params": flax_params(model)}


if __name__ == "__main__":
    main()
