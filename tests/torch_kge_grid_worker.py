"""One rank of the port's multi-process KGE grid tests.

``tests/test_torch_kge_grid.py`` starts two of these with
``TPU_OPERATOR_RANK`` set and one JSON spec as the only argument. A rank
opens the gloo group from the spec's hostfile, runs every job of
:data:`JOBS` (a ``2 x 2`` grid, each rank holding one dp row, with host
and device negatives and two clients a slot; a 1-D mesh of 4 slots with
device negatives, each rank holding two blocks), closes the group and
writes what it got to ``<out>.rank<r>.npz``. The test process runs
:func:`run_job` itself, without a group, for the single-process
reference. This module imports nothing of JAX.
"""

import json
import os
import sys

import numpy as np
import torch

from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.kge_sampler import TrainDataset
from dgl_operator_tpu_torch.models.kge import KGEConfig
from dgl_operator_tpu_torch.parallel.bootstrap import (
    RANK_ENV, initialize_from_hostfile)
from dgl_operator_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from dgl_operator_tpu_torch.runtime.kge import DistKGETrainer, KGETrainConfig

# name -> (mesh shape (dp, mp) or (slots,), KGETrainConfig fields)
JOBS = {"grid_host": ((2, 2), {}),
        "grid_device": ((2, 2), {"neg_sampler": "device"}),
        "grid_clients": ((2, 2), {"num_client": 2}),
        "line_device": ((4,), {"neg_sampler": "device"})}


def dataset():
    return datasets.kg_dataset("fb15k", seed=1, scale=1e-4)


def configs(ds, **fields):
    cfg = KGEConfig(model_name="ComplEx", n_entities=ds.n_entities,
                    n_relations=ds.n_relations, hidden_dim=8, gamma=12.0,
                    neg_adversarial_sampling=True)
    tcfg = KGETrainConfig(**{**dict(lr=0.1, max_step=6, batch_size=32,
                                    neg_sample_size=8, neg_chunk_size=8,
                                    log_interval=3, seed=0), **fields})
    return cfg, tcfg


def mesh_of(shape):
    return make_mesh(*shape) if len(shape) == 1 else make_mesh_2d(*shape)


def run_job(name: str) -> dict:
    """Job ``name`` trained 6 steps: its losses, slots and state."""
    shape, fields = JOBS[name]
    ds = dataset()
    cfg, tcfg = configs(ds, **fields)
    mesh = mesh_of(shape)
    tr = DistKGETrainer(cfg, tcfg, device="cpu", mesh=mesh)
    out = tr.train(TrainDataset(ds.train, ds.n_entities, ds.n_relations,
                                ranks=mesh.size * tcfg.num_client))
    arrays = {f"{name}/losses": np.asarray(out["losses"]),
              f"{name}/my_slots": np.asarray(tr.my_slots),
              f"{name}/updates": np.asarray(out["updates"])}
    for k, v in tr.state_dict().items():
        arrays[f"{name}/state/{k}"] = v
    return arrays


def main(spec: dict) -> None:
    torch.set_num_threads(1)
    rank = int(os.environ[RANK_ENV])
    initialize_from_hostfile(spec["hostfile"], device="cpu", timeout_s=60)
    try:
        out = {}
        for name in JOBS:
            out.update(run_job(name))
    finally:
        torch.distributed.destroy_process_group()
    np.savez(f"{spec['out']}.rank{rank}.npz", **out)
    print(f"rank {rank}: done", flush=True)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
