"""Standalone neighbour-sampled GraphSAGE (the job with ``partitionMode:
Skip``): one process, no partition book.

The counterpart of the JAX package's ``examples/GraphSAGE/train.py``:
minibatch training of ``DistSAGE`` (or, with ``--model gat|gatv2``,
``DistGAT`` / ``DistGATv2`` with 2 heads of ``--num_hidden``) on the
synthetic ogbn-products graph cut to ``--dataset_scale``, through
``SampledTrainer``, with the JAX example's flags; ``--remat`` recomputes
each layer in the backward. Run it as ``python -m
dgl_operator_tpu_torch.examples.graphsage``; it trains on the card
unless ``--device cpu`` is given. The weights, the shuffles and the
sampling streams are drawn from ``--seed``; ``init_params`` (a flax
params tree) replaces the weights. :func:`main` returns the trainer's
result.
"""

from __future__ import annotations

import argparse

import torch

from dgl_operator_tpu_torch._device import resolve_device
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models import DistGAT, DistGATv2, DistSAGE
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig


def main(argv=None, init_params=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num_epochs", type=int, default=10)
    ap.add_argument("--batch_size", type=int, default=1000)
    ap.add_argument("--fan_out", type=str, default="10,25")
    ap.add_argument("--lr", type=float, default=0.003)
    ap.add_argument("--num_hidden", type=int, default=16)
    ap.add_argument("--dataset_scale", type=float, default=1.0)
    ap.add_argument("--model", choices=["sage", "gat", "gatv2"],
                    default="sage")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer in the backward")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches sampled ahead of the step (0 = inline)")
    ap.add_argument("--sampler", choices=["host", "device"], default="host")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the current CUDA card")
    ap.add_argument("--seed", type=int, default=0,
                    help="TrainConfig.seed: the weights, the shuffles and "
                         "the sampling streams")
    args, _ = ap.parse_known_args(argv)
    device = resolve_device(args.device)

    ds = datasets.ogbn_products(scale=args.dataset_scale)
    n_cls = int(ds.graph.ndata["label"].max()) + 1
    feat_dim = int(ds.graph.ndata["feat"].shape[1])
    cfg = TrainConfig(
        num_epochs=args.num_epochs, batch_size=args.batch_size, lr=args.lr,
        fanouts=tuple(int(f) for f in args.fan_out.split(",")),
        log_every=20, prefetch=args.prefetch, sampler=args.sampler,
        seed=args.seed)
    gen = torch.Generator().manual_seed(cfg.seed)
    if args.model in ("gat", "gatv2"):
        cls = DistGATv2 if args.model == "gatv2" else DistGAT
        model = cls(feat_dim, args.num_hidden, n_cls, num_heads=2,
                    dropout=0.5, device=device, generator=gen,
                    remat=args.remat)
    else:
        model = DistSAGE(feat_dim, args.num_hidden, n_cls, dropout=0.5,
                         device=device, generator=gen, remat=args.remat)
    out = SampledTrainer(model, ds.graph, cfg, device=device).train(
        init_params=init_params)
    print(f"final loss {out['history'][-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
