"""``tpukerun`` — the KGE workflow driver (dglkerun equivalent).

Reference: ``python/dglrun/exec/dglkerun:119-343`` — same 5-phase shape
as dglrun but partitioning via ``dglke_partition`` and training via the
hotfixed ``dglke_dist_train``. Flag parity kept for the dglkerun
surface (dglkerun:7-117): ``--custom-dataset`` triple of
entities/relations/train files, ``--ignore-partition`` /
``--pvc-partitioned-dir`` to reuse a pre-partitioned dataset
(dglkerun:31-39,190-205), KGE hyperparameters forwarded to the train
entrypoint.

The training phase needs no server processes (dist_train.py writes a
bash script starting N dglke_server + 1 dglke_client per machine,
:133-185; our sharded-embedding step IS the server, runtime/kge.py) —
one process per host, fanned out over the exec fabric.

The port's copy of the JAX package's ``launcher/tpukerun.py``,
torch-free: every flag, ``_adv_enabled`` and ``_train_flags`` as there,
so the operator's pods start either driver unchanged, and phase 5
starts the port's ``examples/train_kge.py`` (by path, as given in
``--train-entry-point``). The phase ledger is new in the port: the
JAX ``tpukerun`` has none and retrains on every relaunch, while this
one keeps the ``tpurun`` ledger (:class:`~.tpurun.PhaseLedger`), so a
relaunch whose flags are all unchanged skips the phases a previous
driver completed (``TPU_OPERATOR_NO_RESUME=1`` re-runs them). The driver
runs under ``obs_run`` (``<workspace>/obs``) and collects the job view
after phase 5 (``tpurun.collect_obs``), as the JAX driver does.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shlex
import sys
from typing import List, Optional

from dgl_operator_tpu_torch.launcher import console
from dgl_operator_tpu_torch.launcher.dispatch import dispatch_partitions
from dgl_operator_tpu_torch.launcher.fabric import get_fabric
from dgl_operator_tpu_torch.launcher.launch import (launch_train,
                                                    run_copy_batch,
                                                    run_exec_batch)
from dgl_operator_tpu_torch.launcher.tpurun import (NO_RESUME_ENV,
                                                    OBS_SUBDIR, PhaseLedger,
                                                    _phase, _PhaseClock,
                                                    _run, collect_obs)
from dgl_operator_tpu_torch.obs import OBS_DIR_ENV, obs_run
from dgl_operator_tpu_torch.parallel.bootstrap import PHASE_ENV

DEFAULT_WORKSPACE = "/tpu_workspace"
DEFAULT_CONF_DIR = "/etc/tpugraph"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tpukerun",
        description="Phase-gated distributed KGE workflow driver "
                    "(dglkerun equivalent)")
    ap.add_argument("-g", "--graph-name", dest="graph_name", default="kg")
    ap.add_argument("--num-partitions", type=int, default=1)
    ap.add_argument("--partition-entry-point")
    ap.add_argument("--train-entry-point")
    ap.add_argument("--workspace", default=DEFAULT_WORKSPACE)
    ap.add_argument("--conf-dir", default=DEFAULT_CONF_DIR)
    ap.add_argument("--fabric", default=None)
    # dataset source (dglkerun:31-56)
    ap.add_argument("--dataset", default="FB15k")
    ap.add_argument("--custom-dataset-name", default="")
    ap.add_argument("--custom-entity-file", default="")
    ap.add_argument("--custom-relation-file", default="")
    ap.add_argument("--custom-train-file", default="")
    # partition reuse (dglkerun:31-39,190-205)
    ap.add_argument("--ignore-partition", action="store_true",
                    help="skip phases 1-2; dataset is already partitioned")
    ap.add_argument("--pvc-partitioned-dir", default="",
                    help="pre-partitioned dataset dir on a shared volume")
    # KGE hyperparameters (dglkerun:284-304 fixed flags)
    ap.add_argument("--model-name", default="ComplEx")
    ap.add_argument("--hidden-dim", type=int, default=400)
    ap.add_argument("--gamma", type=float, default=143.0)
    ap.add_argument("-adv", "--neg-adversarial-sampling",
                    dest="neg_adversarial_sampling",
                    action="store_true", default=None,
                    help="self-adversarial negatives (the reference's "
                         "generated command always passes -adv, "
                         "dglkerun:300). Default: on for the bundled "
                         "train_kge.py entry point, off for custom "
                         "entry points whose flag contract is unknown; "
                         "--no-adv forces off")
    ap.add_argument("--no-adv", dest="neg_adversarial_sampling",
                    action="store_false")
    ap.add_argument("--adversarial-temperature", type=float,
                    default=1.0)
    ap.add_argument("--lr", type=float, default=0.25)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--neg-sample-size", type=int, default=256)
    ap.add_argument("--max-step", type=int, default=1000)
    ap.add_argument("--log-interval", type=int, default=100)
    ap.add_argument("--save-path", default="ckpts")   # dglkerun:113,303
    ap.add_argument("--num-servers", type=int, default=1,
                    help="accepted for dglkerun parity; sharded "
                         "embeddings need no server processes")
    ap.add_argument("--train-args", default="")
    return ap


def _adv_enabled(args) -> bool:
    if args.neg_adversarial_sampling is not None:
        return args.neg_adversarial_sampling
    # unset: reference parity (-adv always) for the bundled entry
    # point; custom entry points keep their own flag contract
    return (args.train_entry_point or "").endswith("train_kge.py")


def _train_flags(args) -> str:
    return (f" --model_name {shlex.quote(args.model_name)}"
            f" --hidden_dim {args.hidden_dim}"
            f" --gamma {args.gamma}"
            f" --lr {args.lr}"
            f" --batch_size {args.batch_size}"
            f" --neg_sample_size {args.neg_sample_size}"
            f" --max_step {args.max_step}"
            f" --log_interval {args.log_interval}"
            + ((" -adv --adversarial_temperature "
                f"{args.adversarial_temperature}")
               if _adv_enabled(args) else "")
            + f" --save_path {shlex.quote(args.save_path)}")


def signature_of(args: argparse.Namespace, phase: Optional[str]) -> str:
    """The ledger's job signature: every flag and the mode, so a relaunch
    that changes any of them is another job."""
    ident = dict(vars(args), mode=phase or "Launcher", driver="tpukerun")
    return hashlib.sha1(json.dumps(ident, sort_keys=True).encode()
                        ).hexdigest()[:16]


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    ws = args.workspace
    obs_dir = os.environ.get(OBS_DIR_ENV) or os.path.join(ws, OBS_SUBDIR)
    with obs_run(obs_dir, role="tpukerun") as obs:
        obs.emit("tpukerun_start", phase_env=os.environ.get(PHASE_ENV),
                 graph=args.graph_name, dataset=args.dataset, workspace=ws)
        _workflow(args, ws)


def _workflow(args: argparse.Namespace, ws: str) -> None:
    hostfile = os.path.join(args.conf_dir, "hostfile")
    leadfile = os.path.join(args.conf_dir, "leadfile")
    part_src = args.pvc_partitioned_dir or os.path.join(ws, "dataset")
    part_cfg = os.path.join(part_src, f"{args.graph_name}.json")
    worker_part_cfg = os.path.join(ws, "workload",
                                   f"{args.graph_name}.json")
    fabric = get_fabric(args.fabric)
    phase = os.environ.get(PHASE_ENV)
    py = sys.executable
    ledger = PhaseLedger(ws, signature_of(args, phase),
                         enabled=not os.environ.get(NO_RESUME_ENV))
    clock = _PhaseClock(5)

    if phase == "Partitioner":
        if args.ignore_partition:
            console.log("partition ignored (--ignore-partition)",
                        event="partition_ignored")
            return

        # ---- Phase 1/5: partition the KG (dglkerun:119-160) ----------
        def partition():
            cmd = [py, args.partition_entry_point,
                   "--graph_name", args.graph_name,
                   "--workspace", ws,
                   "--num_parts", str(args.num_partitions),
                   "--dataset", args.dataset]
            if args.custom_dataset_name:
                cmd += ["--custom_name", args.custom_dataset_name,
                        "--entity_file", args.custom_entity_file,
                        "--relation_file", args.custom_relation_file,
                        "--train_file", args.custom_train_file]
            _run(cmd)

        _phase(clock, ledger, 1, "load and partition the knowledge graph",
               partition)
        # ---- Phase 2/5: deliver partitions (dglkerun:162-205) --------
        _phase(clock, ledger, 2, "deliver partitions",
               lambda: run_copy_batch(
                   leadfile, [os.path.join(ws, "dataset")], ws, fabric,
                   container="watcher-partitioner"))
        return

    # ---- Phase 3/5: dispatch partitions (dglkerun:227-233) -----------
    _phase(clock, ledger, 3, "dispatch partitions",
           lambda: dispatch_partitions(ws, "workload", part_cfg, hostfile,
                                       fabric))
    # ---- Phase 4/5: revise hostfile (dglkerun:255-260, KGE format) ---
    revise_cmd = (
        f"{shlex.quote(py)} -m dgl_operator_tpu_torch.launcher.revise "
        f"--workspace {shlex.quote(ws)} "
        f"--ip_config {shlex.quote(hostfile)} --framework DGLKE")
    _phase(clock, ledger, 4, "batch revise hostfile",
           lambda: run_exec_batch(hostfile, revise_cmd, fabric))
    # ---- Phase 5/5: distributed KGE training (dglkerun:284-304) ------
    train_cmd = (
        f"{shlex.quote(py)} {shlex.quote(args.train_entry_point)}"
        f" --graph_name {shlex.quote(args.graph_name)}"
        f" --ip_config {shlex.quote(os.path.join(ws, 'hostfile_revised'))}"
        f" --part_config {shlex.quote(worker_part_cfg)}"
        + _train_flags(args))
    if args.train_args:
        train_cmd += f" {args.train_args}"
    _phase(clock, ledger, 5, "launch the KGE training",
           lambda: launch_train(hostfile, train_cmd, args.num_partitions,
                                worker_part_cfg, ws, fabric=fabric))
    # the job's telemetry view (best-effort, as in tpurun)
    collect_obs(hostfile, fabric)


if __name__ == "__main__":
    main()
