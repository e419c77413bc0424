"""One rank of the port's multi-process KGE tests.

``tests/test_torch_kge_dist.py`` starts two of these with
``TPU_OPERATOR_RANK`` set and one JSON spec as the only argument. A rank
opens the gloo group from the spec's hostfile, runs the spec's
``DistKGETrainer`` jobs (training, ranking evaluation, a run cut short
and resumed from its checkpoints), closes the group, then trains through
the entry point ``examples/train_kge.py``, which opens its own group
from a second hostfile. It writes what it got to
``<out>.rank<r>.npz``. The test process runs :func:`run_job` and
:func:`run_cut_and_resumed` itself, without a group, for the
single-process reference. This module imports nothing of JAX.
"""

import functools
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
from dgl_operator_tpu_torch.runtime.kge import (DistKGETrainer,
                                                KGETrainConfig, build_filter)

EVAL_TRIPLES = 60


class Killed(RuntimeError):
    """The end of a run that a resume check cuts short."""


def dataset():
    return datasets.kg_dataset("fb15k", seed=1, scale=0.02)


def configs(ds, **fields):
    cfg = KGEConfig(model_name="ComplEx", n_entities=ds.n_entities,
                    n_relations=ds.n_relations, hidden_dim=16, gamma=12.0,
                    neg_adversarial_sampling=True)
    tcfg = KGETrainConfig(**{**dict(lr=0.1, max_step=6, batch_size=64,
                                    neg_sample_size=16, neg_chunk_size=16,
                                    log_interval=3, seed=0), **fields})
    return cfg, tcfg


def run_job(slots: int, name: str) -> dict:
    """``slots`` slots trained 6 steps, then ranked raw and filtered."""
    ds = dataset()
    tr = DistKGETrainer(*configs(ds), num_slots=slots, device="cpu")
    out = tr.train(TrainDataset(ds.train, ds.n_entities, ds.n_relations,
                                ranks=slots))
    ev = tuple(a[:EVAL_TRIPLES] for a in ds.test)
    filt = build_filter(tuple(np.concatenate(x)
                              for x in zip(ds.train, ds.test)),
                        ds.n_entities)
    arrays = {f"{name}/losses": np.asarray(out["losses"]),
              f"{name}/my_slots": np.asarray(tr.my_slots)}
    for k, v in tr.state_dict().items():
        arrays[f"{name}/state/{k}"] = v
    for label, f in (("raw", None), ("filtered", filt)):
        m = tr.sharded_ranking_eval(ev, batch_size=32, filters=f)
        arrays[f"{name}/eval_{label}"] = np.asarray(
            [m[k] for k in sorted(m)])
    return arrays


def run_cut_and_resumed(ckpt_dir: str, kill_at: int) -> dict:
    """A 2-slot run checkpointing every ``kill_at`` steps dies as it
    begins step ``kill_at + 1``; a fresh trainer resumes it."""
    ds = dataset()
    td = TrainDataset(ds.train, ds.n_entities, ds.n_relations, ranks=2)
    cfg, tcfg = configs(ds, ckpt_dir=ckpt_dir, ckpt_every=kill_at)
    first = DistKGETrainer(cfg, tcfg, num_slots=2, device="cpu")
    step, taken = first.device_step, []

    def dying_step(hs):
        if len(taken) == kill_at:
            raise Killed(f"killed after {kill_at} steps")
        taken.append(1)
        return step(hs)

    first.device_step = dying_step
    try:
        first.train(td)
        raise RuntimeError("the first run was not cut")
    except Killed:
        pass
    resumed = DistKGETrainer(cfg, tcfg, num_slots=2, device="cpu")
    out = resumed.train(td)
    arrays = {"resumed/losses": np.asarray(out["losses"]),
              "resumed/start_step": np.asarray(out["start_step"])}
    for k, v in resumed.state_dict().items():
        arrays[f"resumed/state/{k}"] = v
    return arrays


def entry_arrays(out: dict, save_path: str, rank: int) -> dict:
    with np.load(os.path.join(save_path,
                              f"kg_ComplEx_rank{rank}.npz")) as z:
        saved = {f"entry/saved/{k}": z[k] for k in z.files}
    return {"entry/losses": np.asarray(out["losses"]),
            "entry/mrr": np.asarray(out["eval"]["MRR"]), **saved}


def main(spec: dict) -> None:
    torch.set_num_threads(1)
    rank = int(os.environ[RANK_ENV])
    initialize_from_hostfile(spec["hostfile"], device="cpu", timeout_s=60)
    try:
        arrays = {}
        for slots in (2, 4):
            arrays.update(run_job(slots, f"s{slots}"))
        arrays.update(run_cut_and_resumed(spec["ckpt_dir"], spec["kill_at"]))
    finally:
        torch.distributed.destroy_process_group()
    from dgl_operator_tpu_torch.examples import train_kge
    train_kge.initialize_from_hostfile = functools.partial(
        initialize_from_hostfile, timeout_s=60)
    save = os.path.join(spec["save"], f"rank{rank}")
    out = train_kge.main(spec["argv"] + ["--ip_config", spec["hostfile2"],
                                         "--save_path", save])
    arrays.update(entry_arrays(out, save, rank))
    np.savez(f"{spec['out']}.rank{rank}.npz", **arrays)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
