"""Distributed KGE training: the worker entry point.

The counterpart of ``examples/DGL-KE/train_kge.py`` of the JAX package,
with its flags: the KGE launcher's phase 5 starts it on every worker
with ``--graph_name --ip_config --part_config`` and the KGE
hyperparameters (``--model_name --hidden_dim --gamma --lr --batch_size
--neg_sample_size --max_step --log_interval``, ``-adv
--adversarial_temperature``, ``--save_path``). Run it as ``python -m
dgl_operator_tpu_torch.examples.train_kge``.

- Without ``--num_dp`` each process trains a ``KGETrainer`` on its own
  partition of the book ``--part_config`` (``partition_kg.py``).
- With ``--num_dp N`` a ``DistKGETrainer`` trains ``N`` slots with the
  entity table sharded over them, over the concatenation of every
  partition, re-partitioned into ``N`` ranks. Under
  ``TPU_OPERATOR_DIST=1`` with a hostfile of more than one entry the
  processes rendezvous over ``torch.distributed``
  (``parallel/bootstrap.py``) and each trains the slots of its rank;
  otherwise one process trains every slot.

It trains on the card unless ``--device cpu`` is given. The backend is
``--backend``, else NCCL on a card and gloo on the CPU. Tables are drawn
from ``--seed``. The final tables are saved to
``<save_path>/<graph_name>_<model_name>_rank<r>.npz`` (keys ``entity``
and ``relation``); ``--eval`` (or ``--test``) then ranks the first 500
training triples. :func:`main` returns the trainer's result.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from dgl_operator_tpu_torch._device import resolve_device
from dgl_operator_tpu_torch.graph.kge_sampler import (TrainDataset,
                                                      load_kg_partition)
from dgl_operator_tpu_torch.models.kge import KGEConfig
from dgl_operator_tpu_torch.parallel.bootstrap import (
    RANK_ENV, initialize_from_hostfile, parse_hostfile)
from dgl_operator_tpu_torch.runtime.kge import (DistKGETrainer,
                                                KGETrainConfig, KGETrainer,
                                                full_ranking_eval)

DIST_ENV = "TPU_OPERATOR_DIST"
EVAL_TRIPLES = 500


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graph_name", default="kg")
    ap.add_argument("--ip_config", default="")
    ap.add_argument("--part_config", required=True)
    ap.add_argument("--model_name", default="ComplEx")
    ap.add_argument("--hidden_dim", type=int, default=400)
    ap.add_argument("--gamma", type=float, default=143.0)
    ap.add_argument("--lr", type=float, default=0.25)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--neg_sample_size", type=int, default=256)
    ap.add_argument("-adv", "--neg_adversarial_sampling",
                    action="store_true",
                    help="self-adversarial negative weighting")
    ap.add_argument("--adversarial_temperature", type=float, default=1.0)
    ap.add_argument("--neg_chunk_size", type=int, default=0)
    ap.add_argument("--neg_sampler", choices=["host", "device"],
                    default="host")
    ap.add_argument("--max_step", type=int, default=1000)
    ap.add_argument("--log_interval", type=int, default=100)
    ap.add_argument("--save_path", default="ckpts")
    ap.add_argument("--eval", "--test", dest="eval", action="store_true",
                    help="rank the first 500 training triples after "
                         "training")
    ap.add_argument("--num_dp", type=int, default=0,
                    help="slots of a DistKGETrainer (the entity table "
                         "sharded over them); 0 = KGETrainer")
    ap.add_argument("--num_mp", type=int, default=1)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the current CUDA card")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="torch.distributed backend; default nccl on a "
                         "card, gloo on the CPU")
    ap.add_argument("--seed", type=int, default=0,
                    help="the tables' draw and the sampler streams")
    args, _ = ap.parse_known_args(argv)
    return args


def _check_ported(args: argparse.Namespace) -> None:
    if args.num_mp > 1:
        raise NotImplementedError(
            "--num_mp > 1: the 2-D mesh is not ported (ROADMAP.md Queue 1 "
            "item 8.1)")
    if args.neg_sampler != "host":
        raise NotImplementedError(
            "--neg_sampler device: not ported (ROADMAP.md Queue 1 item "
            "8.2)")


def main(argv=None):
    args = parse_args(argv)
    _check_ported(args)
    device = resolve_device(args.device)
    rank = int(os.environ.get(RANK_ENV, "0"))
    entries = parse_hostfile(args.ip_config) if args.ip_config else []
    distributed = os.environ.get(DIST_ENV) == "1" and len(entries) > 1
    if distributed:
        rank = initialize_from_hostfile(args.ip_config, backend=args.backend,
                                        device=device)
    try:
        return _train(args, rank, device)
    finally:
        if distributed:
            torch.distributed.destroy_process_group()


def _train(args: argparse.Namespace, rank: int, device):
    with open(args.part_config) as f:
        meta = json.load(f)
    ne, nr = int(meta["n_entities"]), int(meta["n_relations"])
    if args.num_dp:
        # every slot's stream is global: every process loads every part
        parts = [load_kg_partition(args.part_config, p)[0]
                 for p in range(int(meta["num_parts"]))]
        triples = tuple(np.concatenate([p[i] for p in parts])
                        for i in range(3))
    else:
        triples = load_kg_partition(args.part_config, rank)[0]
    cfg = KGEConfig(model_name=args.model_name, n_entities=ne,
                    n_relations=nr, hidden_dim=args.hidden_dim,
                    gamma=args.gamma, neg_sample_size=args.neg_sample_size,
                    neg_adversarial_sampling=args.neg_adversarial_sampling,
                    adversarial_temperature=args.adversarial_temperature)
    tcfg = KGETrainConfig(
        lr=args.lr, max_step=args.max_step,
        batch_size=min(args.batch_size, max(1, len(triples[0]))),
        neg_sample_size=args.neg_sample_size,
        neg_chunk_size=args.neg_chunk_size or None,
        log_interval=args.log_interval, seed=args.seed)
    if args.num_dp:
        trainer = DistKGETrainer(cfg, tcfg, num_slots=args.num_dp,
                                 device=device)
        out = trainer.train(TrainDataset(triples, ne, nr, ranks=args.num_dp))
        params = trainer.gathered_params()
    else:
        trainer = KGETrainer(cfg, tcfg, device=device)
        out = trainer.train(TrainDataset(triples, ne, nr, ranks=1))
        params = trainer.params
    print(f"rank {rank}: trained {out['steps']} steps, loss "
          f"{out['loss']:.6f} ({out['train_time_s']:.1f}s)", flush=True)
    os.makedirs(args.save_path, exist_ok=True)
    np.savez(os.path.join(
        args.save_path, f"{args.graph_name}_{args.model_name}_rank{rank}.npz"),
        entity=params["entity"].cpu().numpy(),
        relation=params["relation"].cpu().numpy())
    if args.eval:
        sub = tuple(a[:EVAL_TRIPLES] for a in triples)
        bs = min(128, len(sub[0]))
        m = (trainer.sharded_ranking_eval(sub, batch_size=bs) if args.num_dp
             else full_ranking_eval(trainer.model, params, sub,
                                    batch_size=bs))
        out["eval"] = m
        print(f"rank {rank}: MRR {m['MRR']:.4f} MR {m['MR']:.1f} "
              f"HITS@10 {m['HITS@10']:.4f}", flush=True)
    return out


if __name__ == "__main__":
    main()
