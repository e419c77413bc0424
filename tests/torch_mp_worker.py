"""One rank of the port's multi-process tests.

``tests/test_torch_multiprocess.py`` starts two of these with
``TPU_OPERATOR_RANK`` set, one JSON spec as the only argument. A rank
opens the gloo group from the spec's hostfile (or, in ``entry`` mode,
lets the entry point ``examples/train_dist.py::main`` open it), runs
the spec's trainings, exchange and collective checks, and writes what it
got to ``<out>.rank<r>.npz``. The test process runs :func:`run_job`
itself, without a group, for the single-process reference. This module
imports nothing of JAX.
"""

import functools
import json
import os
import sys

import numpy as np
import torch

from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.parallel import collectives
from dgl_operator_tpu_torch.parallel.bootstrap import (
    RANK_ENV, initialize_from_hostfile)
from dgl_operator_tpu_torch.parallel.halo import (alltoall_request_rows,
                                                  alltoall_serve_rows)
from dgl_operator_tpu_torch.runtime.checkpoint import load_params
from dgl_operator_tpu_torch.runtime.dist import DistTrainer
from dgl_operator_tpu_torch.runtime.loop import TrainConfig


class Killed(RuntimeError):
    """The end of a run that a resume check cuts short."""


def result_arrays(name: str, out: dict, tr=None) -> dict:
    """A training result as flat arrays under ``name/``."""
    hist = out["history"]
    arrays = {
        f"{name}/losses": np.asarray([x for r in hist for x in r["losses"]]),
        f"{name}/epoch_loss": np.asarray([r["loss"] for r in hist]),
        f"{name}/step": np.asarray(out["step"]),
        f"{name}/acc": np.asarray([[r.get("val_acc") or -1.0,
                                    r.get("test_acc") or -1.0]
                                   for r in hist])}
    for k, v in out["params"].items():
        arrays[f"{name}/params/{k}"] = v.detach().cpu().numpy()
    if tr is not None:
        arrays[f"{name}/caps"] = np.asarray(tr.caps)
        arrays[f"{name}/steps_per_epoch"] = np.asarray(tr.steps_per_epoch)
        arrays[f"{name}/my_parts"] = np.asarray(tr.my_parts)
    return arrays


def make_trainer(job: dict, **fields) -> DistTrainer:
    cfg = TrainConfig(**{**job["cfg"], **fields})
    model = DistSAGE(*job["dims"], dropout=0.0, device="cpu")
    return DistTrainer(model, job["book"], cfg, device="cpu")


def run_job(job: dict, init) -> dict:
    """One uninterrupted training from the flax params ``init``."""
    tr = make_trainer(job)
    return result_arrays(job["name"], tr.train(init_params=init), tr)


def run_cut_and_resumed(job: dict, init, ckpt_dir: str,
                        kill_at: int) -> dict:
    """A run that checkpoints every ``kill_at`` steps dies as it begins
    the call after step ``kill_at``; a fresh trainer resumes it from
    ``ckpt_dir``."""
    first = make_trainer(job, ckpt_dir=ckpt_dir, ckpt_every=kill_at)
    call, taken = first.train_call, []

    def dying_call(batch):
        if len(taken) >= kill_at:
            raise Killed(f"killed after {len(taken)} steps")
        losses, acc = call(batch)
        taken.extend([1] * len(losses))
        return losses, acc

    first.train_call = dying_call
    try:
        first.train(init_params=init)
        raise RuntimeError("the first run was not cut")
    except Killed:
        pass
    resumed = make_trainer(job, ckpt_dir=ckpt_dir)
    return result_arrays(job["name"], resumed.train(), resumed)


def exchange_checks(slots_per_rank=(1, 2, 3), d: int = 5,
                    cap: int = 4, rows: int = 6) -> dict:
    """``alltoall_request_rows`` across the group against
    ``alltoall_serve_rows`` over every part's store in one process, for
    ``L`` slots a rank. Every store and request table is drawn from one
    seed, so each rank builds the whole single-process answer itself."""
    rank, world = collectives.world()
    out = {}
    for L in slots_per_rank:
        P = world * L
        gen = torch.Generator().manual_seed(100 + L)
        stores = torch.randn(P * rows, d, generator=gen)
        req = torch.randint(-1, rows, (P, P, cap), generator=gen,
                            dtype=torch.int32)
        full = torch.cat([stores, stores.new_zeros(1, d)])
        want = alltoall_serve_rows(full, req.transpose(0, 1).contiguous(),
                                   rows)
        mine = slice(rank * L, (rank + 1) * L)
        local = torch.cat([stores[rank * L * rows:(rank + 1) * L * rows],
                           stores.new_zeros(1, d)])
        got = alltoall_request_rows(local, req[mine].contiguous(), rows)
        out[f"a2a/L{L}/equal"] = np.asarray(torch.equal(got, want[mine]))
    return out


def collective_checks() -> dict:
    rank, world = collectives.world()
    return {
        "coll/sum": np.asarray(collectives.allreduce_host(rank + 1, np.sum)),
        "coll/max_min": np.asarray(collectives.allreduce_host(
            [rank, -rank], np.max)),
        "coll/rows": collectives.host_gather_rows(
            np.full((2, 3), rank, np.int32))}


def main(spec: dict) -> None:
    torch.set_num_threads(spec["threads"])
    rank = int(os.environ[RANK_ENV])
    arrays = {}
    if spec["mode"] == "entry":
        from dgl_operator_tpu_torch.examples import train_dist
        # the entry point's rendezvous with the tests' 60 s timeout
        train_dist.initialize_from_hostfile = functools.partial(
            initialize_from_hostfile, timeout_s=60)
        arrays.update(result_arrays("entry", train_dist.main(spec["argv"])))
    else:
        initialize_from_hostfile(spec["hostfile"], device="cpu",
                                 timeout_s=60)
        try:
            init = load_params(spec["init"])
            arrays.update(collective_checks())
            arrays.update(exchange_checks())
            for job in spec["jobs"]:
                arrays.update(run_job(job, init))
            cut = spec["resume"]
            arrays.update(run_cut_and_resumed(
                dict(cut["job"], name="resumed"), init, cut["ckpt_dir"],
                cut["kill_at"]))
        finally:
            torch.distributed.destroy_process_group()
    np.savez(f"{spec['out']}.rank{rank}.npz", **arrays)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
