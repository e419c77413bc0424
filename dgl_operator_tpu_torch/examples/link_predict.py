"""GraphSAGE link prediction with a dot or MLP predictor, and its AUC.

The counterpart of the JAX package's ``examples/link_predict/
train.py`` (the reference's ``4_link_predict.py``): the latent-geometry
graph (``datasets.link_pred_graph``), its edges split into train and
test positives with as many sampled negatives (``split_edges``, seed
0), a two-layer ``GraphSAGE`` encoder over the train graph and a
``--predictor dot|mlp`` head, full-graph Adam on the BCE loss, then
the ROC-AUC of the test edges, printed. Run it as ``python -m
dgl_operator_tpu_torch.examples.link_predict``; it trains on the card
unless ``--device cpu`` is given. The weights are drawn from
``--seed`` through an explicit generator; ``init_params`` (a flax
params tree) replaces them. :func:`main` returns ``{"auc", "history",
"params"}``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dgl_operator_tpu_torch._device import resolve_device
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models import (PREDICTORS, LinkPredModel,
                                           auc_score, bce_link_loss,
                                           flax_params, split_edges,
                                           state_dict_from_flax)


def main(argv=None, init_params=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num_epochs", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--predictor", choices=PREDICTORS, default="dot")
    ap.add_argument("--dataset_scale", type=float, default=1.0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the current CUDA card")
    ap.add_argument("--seed", type=int, default=0,
                    help="the seed of the model's weights")
    args, _ = ap.parse_known_args(argv)
    device = resolve_device(args.device)

    ds = datasets.link_pred_graph(
        num_nodes=max(200, int(2708 * args.dataset_scale)),
        num_edges=max(400, int(5278 * args.dataset_scale)), seed=0)
    g = ds.graph
    split = split_edges(g, test_frac=0.1, seed=0)
    dg, pos_tr, neg_tr, pos_te, neg_te = (
        split[k].to_device(device)
        for k in ("train_g", "train_pos", "train_neg", "test_pos",
                  "test_neg"))
    x = torch.from_numpy(np.ascontiguousarray(g.ndata["feat"],
                                              np.float32)).to(device)
    model = LinkPredModel(x.shape[1], args.hidden, args.predictor,
                          device=device,
                          generator=torch.Generator().manual_seed(args.seed))
    if init_params is not None:
        model.load_state_dict(state_dict_from_flax(init_params))
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    history = []
    for epoch in range(args.num_epochs):
        opt.zero_grad(set_to_none=True)
        loss = bce_link_loss(*model(dg, x, pos_tr, neg_tr))
        loss.backward()
        opt.step()
        history.append(float(loss.detach()))
        if epoch % 20 == 0:
            print(f"In epoch {epoch}, loss: {history[-1]:.4f}")
    with torch.no_grad():
        pos, neg = model(dg, x, pos_te, neg_te)
    auc = auc_score(pos, neg)
    print(f"AUC {auc:.4f}")
    return {"auc": auc, "history": history, "params": flax_params(model)}


if __name__ == "__main__":
    main()
