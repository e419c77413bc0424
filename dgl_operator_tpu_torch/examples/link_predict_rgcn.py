"""RGCN link prediction on FB15k, with the held-out ROC-AUC.

The counterpart of the JAX package's ``examples/link_predict_rgcn/
train.py``: the message graph of the train triples only (head -> tail,
types the relations), an ``RGCNLinkPredict`` encoder (hidden 32, 8
bases, two layers) with DistMult, full-graph Adam on the BCE of the
train triples against as many tail-corrupted negatives each epoch (drawn
uniformly by ``np.random.default_rng(seed)``, in the JAX example's
order, so both packages draw the same negatives), then the AUC of the
test triples against their own corrupted tails. Run it as ``python -m
dgl_operator_tpu_torch.examples.link_predict_rgcn``; it trains on the
card unless ``--device cpu`` is given. The weights are drawn from
``--seed`` through an explicit generator; ``init_params`` (a flax
params tree) replaces them. :func:`run` takes any ``KGDataset`` (the
FB15k-237 configuration goes through it); :func:`main` returns
``{"auc", "loss", "history", "epoch_s", "params"}`` (``epoch_s``: each
epoch's host seconds, its negatives' plan and the loss's sync
included).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from dgl_operator_tpu_torch._device import resolve_device
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.graph import Graph
from dgl_operator_tpu_torch.models import (RGCNLinkPredict, Triples,
                                           auc_score, bce_link_loss,
                                           flax_params, state_dict_from_flax)


def run(ds: datasets.KGDataset, num_epochs: int = 60, hidden: int = 32,
        num_bases: int = 8, lr: float = 0.01, seed: int = 0, device=None,
        init_params=None, log=print):
    """Train and evaluate on ``ds`` (see the module docstring)."""
    device = resolve_device(device)
    h_tr, r_tr, t_tr = (np.asarray(a) for a in ds.train)
    h_te, r_te, t_te = (np.asarray(a) for a in ds.test)
    ne, nr = ds.n_entities, ds.n_relations

    # the message graph of the train triples only: no test leakage
    dg = Graph(h_tr.astype(np.int32), t_tr.astype(np.int32),
               ne).to_device(device)
    etypes = dg.edge_types(r_tr, nr)

    rng = np.random.default_rng(seed)
    model = RGCNLinkPredict(ne, hidden, nr, num_bases=num_bases,
                            device=device,
                            generator=torch.Generator().manual_seed(seed))
    if init_params is not None:
        model.load_state_dict(state_dict_from_flax(init_params))

    def corrupt(t_arr):
        return rng.integers(0, ne, size=len(t_arr)).astype(np.int64)

    pos_tr = Triples.build(h_tr, r_tr, t_tr, ne, nr, device)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    history, epoch_s = [], []
    for epoch in range(num_epochs):
        t0 = time.perf_counter()
        neg_tr = pos_tr.with_tails(corrupt(t_tr))
        opt.zero_grad(set_to_none=True)
        loss = bce_link_loss(*model(dg, etypes, pos_tr, neg_tr))
        loss.backward()
        opt.step()
        history.append(float(loss.detach()))
        epoch_s.append(time.perf_counter() - t0)
        if epoch % 20 == 0:
            log(f"In epoch {epoch}, loss: {history[-1]:.4f}")

    # held-out AUC: test positives against tail-corrupted negatives
    pos_te = Triples.build(h_te, r_te, t_te, ne, nr, device, plans=False)
    neg_te = pos_te.with_tails(corrupt(t_te))
    with torch.no_grad():
        pos_s, neg_s = model(dg, etypes, pos_te, neg_te)
    auc = auc_score(pos_s, neg_s)
    log(f"AUC {auc:.4f}")
    return {"auc": auc, "loss": history[-1] if history else float("nan"),
            "history": history, "epoch_s": epoch_s,
            "params": flax_params(model)}


def main(argv=None, init_params=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num_epochs", type=int, default=60)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--num_bases", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--dataset_scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the current CUDA card")
    args, _ = ap.parse_known_args(argv)
    device = resolve_device(args.device)
    ds = datasets.fb15k(seed=args.seed, scale=args.dataset_scale)
    return run(ds, args.num_epochs, args.hidden, args.num_bases, args.lr,
               args.seed, device, init_params)


if __name__ == "__main__":
    main()
