"""Partition dispatch — phase 3 of the workflow.

Capability parity with tools/dispatch.py:26-91: rewrite the partition
config JSON so every path is absolute under each worker's workspace,
write the revised JSON to ``<workspace>/<rel_workload_path>/``, then
ship partition *i*'s files (graph + node/edge feats) to worker *i*
only — the partition→worker affinity that makes training local.

Differences from the reference: files are our ``.npz`` partition format
(the port's ``graph/partition.py`` book, or the KG book of
``examples/partition_kg.py``), the transport is a :class:`~.fabric.Fabric`
(filesystem / wrapper shell / object store) instead of raw ``kubectl
cp`` through the API server, and extra metadata keys (num_inner_nodes,
node_map, …) are preserved verbatim.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import List, Optional

from dgl_operator_tpu_torch.launcher.fabric import Fabric, get_fabric
from dgl_operator_tpu_torch.parallel.bootstrap import parse_hostfile

_PART_FILE_KEYS = ("node_feats", "edge_feats", "part_graph")


def dispatch_partitions(workspace: str, rel_workload_path: str,
                        part_config: str, ip_config: str,
                        fabric: Optional[Fabric] = None) -> str:
    """Rewrite the part config for worker workspaces and ship each
    partition to its worker. Returns the revised JSON path.

    Source file locations come from ``part_config`` itself (its
    directory is the data root), so there is no separate data-path
    argument; the CLI still accepts ``--rel_data_path`` for dglrun
    flag parity."""
    fabric = fabric or get_fabric()
    hosts = [e.name for e in parse_hostfile(ip_config)]

    with open(part_config) as f:
        meta = json.load(f)
    num_parts = meta["num_parts"]
    graph_name = meta["graph_name"]
    if num_parts != len(hosts):
        raise ValueError(f"num_parts ({num_parts}) must equal the number of "
                         f"workers in the hostfile ({len(hosts)}) — "
                         "partition i trains on worker i")

    src_base = os.path.dirname(os.path.abspath(part_config))
    worker_meta = copy.deepcopy(meta)
    workload_dir = os.path.join(workspace, rel_workload_path)
    # worker view: absolute paths under each worker's workspace.
    # Graph partitions carry all of _PART_FILE_KEYS; KGE partitions only
    # part_graph (graph/kge_sampler.partition_kg) — rewrite what exists.
    for p in range(num_parts):
        for key in _PART_FILE_KEYS:
            if key in meta[f"part-{p}"]:
                worker_meta[f"part-{p}"][key] = os.path.join(
                    workload_dir, f"part{p}", os.path.basename(
                        meta[f"part-{p}"][key]))
    for key in ("node_map", "edge_map"):
        if key in meta:
            worker_meta[key] = os.path.join(
                workload_dir, os.path.basename(meta[key]))

    os.makedirs(workload_dir, exist_ok=True)
    worker_cfg = os.path.join(workload_dir, f"{graph_name}.json")
    with open(worker_cfg, "w") as f:
        json.dump(worker_meta, f, sort_keys=True, indent=4)

    shared: List[str] = [worker_cfg]
    for key in ("node_map", "edge_map"):
        if key in meta:
            shared.append(os.path.join(src_base, meta[key]))

    fabric.copy_batch(shared, hosts, workload_dir)
    for p, host in enumerate(hosts):
        part_files = [os.path.join(src_base, meta[f"part-{p}"][k])
                      for k in _PART_FILE_KEYS if k in meta[f"part-{p}"]]
        fabric.copy_batch(part_files, [host],
                          os.path.join(workload_dir, f"part{p}"))
    return worker_cfg


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Ship graph partitions to their workers "
                    "(tools/dispatch.py equivalent)")
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--rel_data_path", default="dataset",
                    help="accepted for dglrun CLI parity; sources resolve "
                         "against the part_config directory")
    ap.add_argument("--rel_workload_path", required=True)
    ap.add_argument("--part_config", required=True)
    ap.add_argument("--ip_config", required=True)
    ap.add_argument("--fabric", default=None,
                    choices=[None, "local", "shell", "object"])
    args = ap.parse_args(argv)
    dispatch_partitions(args.workspace, args.rel_workload_path,
                        args.part_config, args.ip_config,
                        get_fabric(args.fabric))


if __name__ == "__main__":
    main()
