"""Launch multiplexer — the ``tools/launch.py`` equivalent.

Reference behavior (tools/launch.py:157-231): one CLI fronting four
``--cmd_type`` verbs — ``exec_batch`` (run a command on every worker),
``copy_batch`` / ``copy_batch_container`` (ship files), and ``train``
(``submit_jobs`` :89-155 — spawn num_servers DGL server processes plus a
``torch.distributed.launch`` trainer tree per pod, then join daemon
threads).

The train launch here is smaller: there are no parameter-server
processes (the sharded embeddings are collectives of the trainers,
parallel/embedding.py) and no per-card process tree: one process per
host, rendezvoused by ``torch.distributed`` via the hostfile
(parallel/bootstrap.py). ``--num_servers`` is accepted for CLI parity
and ignored; ``--num_samplers`` becomes the host sampler-thread count
(TPU_OPERATOR_NUM_SAMPLERS); ``--num_trainers`` maps to per-host local
device count expectations.

The port's copy of the JAX package's ``launcher/launch.py``, torch-free,
with its names, flags, environment contract and exit codes.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

from dgl_operator_tpu_torch.launcher.fabric import Fabric, get_fabric
from dgl_operator_tpu_torch.obs import OBS_ROLE_ENV
from dgl_operator_tpu_torch.obs import tracectx
from dgl_operator_tpu_torch.obs.live import LIVE_PORT_ENV
from dgl_operator_tpu_torch.parallel.bootstrap import (FENCE_EPOCH_ENV,
                                                       HOSTFILE_ENV, RANK_ENV,
                                                       parse_hostfile)


def run_exec_batch(ip_config: str, cmd: str,
                   fabric: Optional[Fabric] = None,
                   container: Optional[str] = None) -> None:
    """Run ``cmd`` on every hostfile entry (tools/launch.py run_exec).
    Repeated entries (an elastic-shrunk hostfile lists a surviving
    host once per partition it carries) run the command ONCE per
    distinct host — the batch verbs here are per-host idempotent
    actions (revise, mkdir), and two concurrent twins racing the same
    output file would tear it."""
    fabric = fabric or get_fabric()
    hosts = list(dict.fromkeys(e.name
                               for e in parse_hostfile(ip_config)))
    fabric.exec_batch(hosts, cmd, container=container)


def run_copy_batch(ip_config: str, source_file_paths: List[str],
                   target_dir: str, fabric: Optional[Fabric] = None,
                   container: Optional[str] = None) -> None:
    """Ship files to every hostfile entry (run_cp / run_cp_container)."""
    fabric = fabric or get_fabric()
    hosts = [e.name for e in parse_hostfile(ip_config)]
    fabric.copy_batch(source_file_paths, hosts, target_dir,
                      container=container)


def launch_train(ip_config: str, udf_command: str, num_parts: int,
                 part_config: str, workspace: str,
                 num_trainers: int = 1, num_samplers: int = 0,
                 num_servers: int = 1,
                 fabric: Optional[Fabric] = None,
                 extra_env: Optional[Dict[str, str]] = None) -> None:
    """Start one training process per TPU host and block until all end.

    submit_jobs parity (tools/launch.py:89-155) minus the server
    processes: assert num_parts == num hosts, fan the user command out
    with per-host rank env, join. The trainer command is expected to
    call ``parallel.bootstrap.initialize_from_hostfile()`` (it reads the
    env set here) before touching the card.
    """
    fabric = fabric or get_fabric()
    entries = parse_hostfile(ip_config)
    if num_parts != len(entries):
        raise ValueError(
            "The number of graph partitions has to match the number of "
            f"hosts in the cluster ({num_parts} vs {len(entries)})")

    base_env = {
        HOSTFILE_ENV: ip_config,
        "TPU_OPERATOR_NUM_SAMPLERS": str(num_samplers),
        "TPU_OPERATOR_NUM_TRAINERS": str(num_trainers),
        "TPU_OPERATOR_PART_CONFIG": part_config,
        "TPU_OPERATOR_WORKSPACE": workspace,
    }
    # trace-context propagation (obs/tracectx.py, the OBS_ROLE
    # pattern): the driver's active span rides into every trainer so
    # their span trees hang under this launch in the merged job trace
    base_env.update(tracectx.env_of_current())
    # live plane: every trainer starts its /livez sidecar on an
    # ephemeral port (obs/live.py; registered under <obs_dir>/live/
    # for tpu-top and the controller's live health feed)
    base_env.setdefault(LIVE_PORT_ENV, os.environ.get(LIVE_PORT_ENV,
                                                      "0"))
    # elastic incarnation epoch (docs/elasticity.md): rides explicitly
    # so shell fabrics fence trainer checkpoints too, not only
    # env-inheriting local ones
    if os.environ.get(FENCE_EPOCH_ENV):
        base_env.setdefault(FENCE_EPOCH_ENV,
                            os.environ[FENCE_EPOCH_ENV])
    base_env.update(extra_env or {})
    # per-rank obs role: a trainer's telemetry is attributable to its
    # worker slot (host:pid:trainer-<rank>), and a relaunched trainer
    # keeps the role while getting a fresh pid — the job analytics
    # (obs/analyze.py) tell "killed worker" from "its successor" by it
    per_host = [{RANK_ENV: str(i), OBS_ROLE_ENV: f"trainer-{i}"}
                for i in range(len(entries))]
    hosts = [e.name for e in entries]
    fabric.exec_batch(hosts, udf_command, env=base_env,
                      per_host_env=per_host)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Launching tool for distributed graph training")
    ap.add_argument("--workspace", type=str, default="")
    ap.add_argument("--num_trainers", type=int, default=1)
    ap.add_argument("--num_samplers", type=int, default=0)
    ap.add_argument("--num_servers", type=int, default=1,
                    help="accepted for dglrun CLI parity; sharded "
                         "embeddings need no server processes")
    ap.add_argument("--num_server_threads", type=int, default=1)
    ap.add_argument("--num_parts", type=int, default=1)
    ap.add_argument("--part_config", type=str, default="")
    ap.add_argument("--ip_config", type=str, required=True)
    ap.add_argument("--cmd_type", type=str, required=True,
                    choices=["exec_batch", "copy_batch",
                             "copy_batch_container", "train"])
    ap.add_argument("--source_file_paths", type=str, default="")
    ap.add_argument("--target_dir", type=str, default="")
    ap.add_argument("--container", type=str, default=None)
    ap.add_argument("--fabric", type=str, default=None)
    ap.add_argument("udf_command", nargs="*")
    args = ap.parse_args(argv)

    fabric = get_fabric(args.fabric)
    udf = " ".join(args.udf_command)
    if args.cmd_type == "exec_batch":
        run_exec_batch(args.ip_config, udf, fabric,
                       container=args.container)
    elif args.cmd_type in ("copy_batch", "copy_batch_container"):
        run_copy_batch(args.ip_config, args.source_file_paths.split(),
                       args.target_dir, fabric, container=args.container)
    elif args.cmd_type == "train":
        launch_train(args.ip_config, udf, args.num_parts, args.part_config,
                     args.workspace, num_trainers=args.num_trainers,
                     num_samplers=args.num_samplers,
                     num_servers=args.num_servers, fabric=fabric)


if __name__ == "__main__":
    main()
