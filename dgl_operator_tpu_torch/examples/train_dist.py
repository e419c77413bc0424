"""Distributed GNN training: the worker entry point.

The counterpart of ``examples/GraphSAGE_dist/train_dist.py`` of the JAX
package, with its flags: the launcher's phase 5 starts it on every
worker with ``--graph_name --ip_config --part_config --num_epochs
--batch_size --num_workers``. Run it as ``python -m
dgl_operator_tpu_torch.examples.train_dist``.

Two execution shapes:

- one process per worker (``TPU_OPERATOR_DIST=1`` and a hostfile of more
  than one entry): the processes rendezvous over ``torch.distributed``
  from the hostfile (``parallel/bootstrap.py``), each loads only its
  parts and the partition-parallel ``DistTrainer`` averages the
  gradients with ``all_reduce``;
- one process: rank 0 drives every part; any other rank checks that its
  partition loads and exits 0 (the launcher fans the command out to
  every worker).

``--model sage|gat|gatv2`` builds ``DistSAGE``, or ``DistGAT`` or
``DistGATv2`` with 2 heads of ``--num_hidden`` each, as the JAX entry
point does. It trains on the card unless ``--device cpu`` is given.
``--bf16`` runs the layers in bfloat16 with float32 parameters
(``compute_dtype="bfloat16"``), ``--remat`` recomputes each layer in
the backward, and ``--feat_dtype`` sets the feature store's dtype
(``TrainConfig.feat_dtype``; a book of int8 or uint8 codes written by
``partition_graph(feat_dtype=...)`` is read as it is under that dtype).
``--shard_update`` shards the optimizer state over the slots
(weight-update sharding) and ``--shard_rules`` selects the parameters
by a JSON list of ``[regex, axes]`` pairs (``parallel/dp.py``);
``zero_stage``, ``tp_axis_size`` and ``gather_depth`` come through the
tuned manifest (``TPU_OPERATOR_TUNED_MANIFEST``, its ``shard`` layer),
as in the JAX entry point. The backend is ``--backend``, else NCCL on a
card and gloo on the CPU. The
``--ckpt_dir`` checkpoints there at every epoch's end and resumes
from the newest good checkpoint
(``TrainConfig.ckpt_dir``); a run preempted by SIGTERM flushes one and
exits 75 (EX_TEMPFAIL), the status the launcher's driver requeues. The
model's weights are drawn from ``--seed`` (``TrainConfig.seed``)
through an explicit generator, so every process and a single-process
run start from the same weights. :func:`main` returns the trainer's
result.
"""

from __future__ import annotations

# the repo root on sys.path, so the launcher can start this file by path
import os as _os, sys as _sys  # noqa: E401
_sys.path.insert(0, _os.path.abspath(_os.path.join(
    _os.path.dirname(__file__), "..", "..")))

import argparse
import json
import os

import numpy as np
import torch

from dgl_operator_tpu_torch._device import resolve_device
from dgl_operator_tpu_torch.graph.partition import GraphPartition
from dgl_operator_tpu_torch.models import DistGAT, DistGATv2, DistSAGE
from dgl_operator_tpu_torch.parallel import collectives
from dgl_operator_tpu_torch.parallel.bootstrap import (
    RANK_ENV, initialize_from_hostfile, parse_hostfile)
from dgl_operator_tpu_torch.runtime.dist import DistTrainer
from dgl_operator_tpu_torch.runtime.loop import (NUM_SAMPLERS_ENV, Preempted,
                                                 TrainConfig)

DIST_ENV = "TPU_OPERATOR_DIST"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graph_name", type=str, required=True)
    ap.add_argument("--ip_config", type=str, required=True)
    ap.add_argument("--part_config", type=str, required=True)
    ap.add_argument("--num_epochs", type=int, default=10)
    ap.add_argument("--batch_size", type=int, default=1000)
    ap.add_argument("--num_workers", type=int, default=0,
                    help="sampler threads (reference --num_samplers)")
    ap.add_argument("--fan_out", type=str, default="10,25")
    ap.add_argument("--lr", type=float, default=0.003)
    ap.add_argument("--num_hidden", type=int, default=16)
    ap.add_argument("--eval_every", type=int, default=5)
    ap.add_argument("--log_every", type=int, default=20)
    ap.add_argument("--num_classes", type=int, default=0,
                    help="0 = infer from partition labels")
    ap.add_argument("--model", choices=["sage", "gat", "gatv2"],
                    default="sage")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 layer compute with float32 parameters")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer in the backward")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches sampled ahead of the step (0 = inline)")
    ap.add_argument("--shard_update", action="store_true",
                    help="weight-update sharding: the optimizer state "
                         "1/n a dp slot (arXiv:2004.13336)")
    ap.add_argument("--shard_rules", type=str, default=None,
                    help="the rule-driven per-parameter form of "
                         "--shard_update: a JSON list of [regex, axes] "
                         "pairs, e.g. '[[\"kernel\", \"dp\"], "
                         "[\".*\", null]]'")
    ap.add_argument("--sampler", choices=["host", "device"], default="host")
    ap.add_argument("--feats_layout", choices=["replicated", "owner"],
                    default="replicated")
    ap.add_argument("--feat_dtype", choices=["float32", "bfloat16"],
                    default="float32")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the current CUDA card")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="torch.distributed backend; default nccl on a "
                         "card, gloo on the CPU")
    ap.add_argument("--seed", type=int, default=0,
                    help="TrainConfig.seed: the weights, the shuffles and "
                         "the sampling streams")
    ap.add_argument("--ckpt_dir", type=str, default=None,
                    help="checkpoint and resume here (TrainConfig.ckpt_dir)")
    args, _ = ap.parse_known_args(argv)
    return args


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    rank = int(os.environ.get(RANK_ENV, "0"))
    entries = parse_hostfile(args.ip_config)
    with open(args.part_config) as f:
        num_parts = int(json.load(f)["num_parts"])
    distributed = os.environ.get(DIST_ENV) == "1" and len(entries) > 1
    if distributed:
        rank = initialize_from_hostfile(args.ip_config, backend=args.backend,
                                        device=device)
    elif rank != 0:
        # one process drives every part; this rank proves that the part
        # the dispatch phase staged here loads, and exits cleanly
        part = GraphPartition(args.part_config, rank)
        print(f"rank {rank}: partition ok ({part.num_inner} inner nodes)")
        return None
    try:
        return _train(args, rank, num_parts, device)
    finally:
        if distributed:
            torch.distributed.destroy_process_group()


def _train(args: argparse.Namespace, rank: int, num_parts: int, device):
    if args.num_workers:
        os.environ.setdefault(NUM_SAMPLERS_ENV, str(args.num_workers))
    cfg = TrainConfig(
        num_epochs=args.num_epochs, batch_size=args.batch_size, lr=args.lr,
        fanouts=tuple(int(f) for f in args.fan_out.split(",")),
        eval_every=args.eval_every, log_every=args.log_every,
        prefetch=args.prefetch, shard_update=args.shard_update,
        shard_rules=(tuple((p, a) for p, a in json.loads(args.shard_rules))
                     if args.shard_rules else None),
        sampler=args.sampler, feats_layout=args.feats_layout,
        feat_dtype=args.feat_dtype, seed=args.seed, ckpt_dir=args.ckpt_dir)
    # this process's parts: all of them, or its block in a group
    r, world = collectives.world()
    per = num_parts // world
    parts = [GraphPartition(args.part_config, p)
             for p in range(r * per, (r + 1) * per)]
    if args.num_classes:
        n_cls = args.num_classes
    else:
        # each process reads only its parts: gather the class count
        n_cls = 1 + collectives.allreduce_host(
            max(int(p.graph.ndata["label"].max()) for p in parts), np.max)
    feat_dim = int(parts[0].graph.ndata["feat"].shape[1])
    gen = torch.Generator().manual_seed(cfg.seed)
    knobs = dict(compute_dtype="bfloat16" if args.bf16 else None,
                 remat=args.remat)
    if args.model in ("gat", "gatv2"):
        cls = DistGATv2 if args.model == "gatv2" else DistGAT
        model = cls(feat_dim, args.num_hidden, n_cls, num_heads=2,
                    dropout=0.5, device=device, generator=gen, **knobs)
    else:
        model = DistSAGE(feat_dim, args.num_hidden, n_cls, dropout=0.5,
                         device=device, generator=gen, **knobs)
    tr = DistTrainer(model, args.part_config, cfg, device=device)
    try:
        out = tr.train()
    except Preempted as exc:
        print(f"rank {rank}: preempted ({exc})", flush=True)
        raise SystemExit(75)
    print(f"rank {rank}: done, final loss "
          f"{out['history'][-1]['loss']:.4f}", flush=True)
    return out


if __name__ == "__main__":
    main()
