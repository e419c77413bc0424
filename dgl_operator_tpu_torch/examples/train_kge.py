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
  partition, re-partitioned into ``N`` ranks; with ``--num_mp M`` too,
  ``N x M`` slots on a ``make_mesh_2d(N, M)`` grid (the table sharded
  over ``M`` and replicated over ``N``), over ``N * M`` ranks.
  ``--neg_sampler device`` draws the negatives on the device (it needs
  ``--num_dp``). Under
  ``TPU_OPERATOR_DIST=1`` with a hostfile of more than one entry the
  processes rendezvous over ``torch.distributed``
  (``parallel/bootstrap.py``) and each trains the slots of its rank;
  otherwise one process trains every slot.

It trains on the card unless ``--device cpu`` is given. The backend is
``--backend``, else NCCL on a card and gloo on the CPU. Tables are drawn
from ``--seed``. The final tables are saved to
``<save_path>/<graph_name>_<model_name>_rank<r>.npz`` (keys ``entity``
and ``relation``); ``--eval`` (or ``--test``) then ranks the first 500
training triples. Where ``TPU_OPERATOR_KGE_SUMMARY`` names a directory,
each rank also writes ``rank<r>.json`` there: the device's name, steps,
updates, the last loss and each kernel wrapper's launches in this
process (a launcher's captured output is dropped on success, so a
check of the kernels a launched job ran reads it there). :func:`main`
returns the trainer's result.
"""

# the repo root on sys.path, so the launcher can start this file by path
import os as _os, sys as _sys  # noqa: E401
_sys.path.insert(0, _os.path.abspath(_os.path.join(
    _os.path.dirname(__file__), "..", "..")))

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dgl_operator_tpu_torch._device import resolve_device
from dgl_operator_tpu_torch.graph.kge_sampler import (TrainDataset,
                                                      load_kg_partition)
from dgl_operator_tpu_torch.models.kge import KGEConfig
from dgl_operator_tpu_torch.parallel.bootstrap import (
    RANK_ENV, initialize_from_hostfile, parse_hostfile)
from dgl_operator_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from dgl_operator_tpu_torch.runtime.kge import (DistKGETrainer,
                                                KGETrainConfig, KGETrainer,
                                                full_ranking_eval)

DIST_ENV = "TPU_OPERATOR_DIST"
SUMMARY_ENV = "TPU_OPERATOR_KGE_SUMMARY"
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
    ap.add_argument("--num_mp", type=int, default=1,
                    help="the grid's mp width: the entity table sharded "
                         "over mp and replicated over dp")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the current CUDA card")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="torch.distributed backend; default nccl on a "
                         "card, gloo on the CPU")
    ap.add_argument("--seed", type=int, default=0,
                    help="the tables' draw and the sampler streams")
    args, _ = ap.parse_known_args(argv)
    if args.neg_sampler == "device" and not args.num_dp:
        # before the rendezvous and the data
        ap.error("--neg_sampler device requires a mesh trainer "
                 "(--num_dp >= 1); the single-host KGETrainer draws "
                 "negatives on host")
    return args


def main(argv=None):
    args = parse_args(argv)
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
        log_interval=args.log_interval, seed=args.seed,
        neg_sampler=args.neg_sampler)
    if args.num_dp:
        mesh = (make_mesh_2d(args.num_dp, args.num_mp) if args.num_mp > 1
                else make_mesh(args.num_dp))
        trainer = DistKGETrainer(cfg, tcfg, device=device, mesh=mesh)
        out = trainer.train(TrainDataset(triples, ne, nr, ranks=mesh.size))
        params = trainer.gathered_params()
    else:
        trainer = KGETrainer(cfg, tcfg, device=device)
        out = trainer.train(TrainDataset(triples, ne, nr, ranks=1))
        params = trainer.params
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else str(device))
    print(f"rank {rank}: trained {out['steps']} steps, loss "
          f"{out['loss']:.6f} ({out['train_time_s']:.1f}s) on {where}",
          flush=True)
    os.makedirs(args.save_path, exist_ok=True)
    np.savez(os.path.join(
        args.save_path, f"{args.graph_name}_{args.model_name}_rank{rank}.npz"),
        entity=params["entity"].cpu().numpy(),
        relation=params["relation"].cpu().numpy())
    if os.environ.get(SUMMARY_ENV):
        _write_summary(os.environ[SUMMARY_ENV], rank, where, out)
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


def _write_summary(out_dir: str, rank: int, where: str, out: dict) -> None:
    """``<out_dir>/rank<rank>.json``: this rank's run and its kernel
    wrappers' launches."""
    from dgl_operator_tpu_torch.ops import fanout, gather, scatter

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"device": where, "steps": out["steps"],
                   "updates": out.get("updates", out["steps"]),
                   "loss": out["loss"],
                   "launches": {w.__name__: w.launches for w in (
                       fanout.fanout_agg, gather.gather_rows,
                       scatter.scatter_add_rows)}}, f)


if __name__ == "__main__":
    main()
