"""Hostfile revision CLI — tools/revise_hostfile.py equivalent.

Runs on every worker during phase 4 (dglrun:188-207), rewriting the
operator hostfile (``ip port podname slots=N``) into the format the
training framework consumes, at ``<workspace>/hostfile_revised``:

- ``JAX``   → ``ip:port`` lines, coordinator first (what
  ``parallel.bootstrap.initialize_from_hostfile`` reads);
- ``DGL``   → ``ip port`` (revise_hostfile.py:27-36 parity);
- ``DGLKE`` → ``ip port num_servers`` (revise_hostfile.py:8-25 parity).

``--placement`` applies a skew-aware partition→host mapping
(``autotune/placement.py``) before the rewrite: hostfile line *i* is
the host assigned partition *i* (the launch_train rank / dispatch
affinity contract), so heaviest partitions land on the fastest
measured hosts. Idempotent — revising an already-placed hostfile
reproduces the same order. An elastic plan (``launcher/elastic.py``)
repeats the surviving hosts, one line a partition.

The port's copy of the JAX package's ``launcher/revise.py``.
"""

from __future__ import annotations

import argparse
import os

from dgl_operator_tpu_torch.parallel.bootstrap import (parse_hostfile,
                                                       revise_hostfile,
                                                       write_hostfile)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Revise hostfile")
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--ip_config", required=True)
    ap.add_argument("--num_servers", type=int, default=1)
    ap.add_argument("--framework", required=True,
                    choices=["JAX", "DGL", "DGLKE"])
    ap.add_argument("--placement", default=None,
                    help="placement.json (autotune/placement.py): "
                         "reorder hostfile entries so line i is the "
                         "host assigned partition i before the "
                         "framework rewrite")
    args, _ = ap.parse_known_args(argv)
    style = {"JAX": "jax", "DGL": "dgl", "DGLKE": "dglke"}[args.framework]
    os.makedirs(args.workspace, exist_ok=True)
    src = args.ip_config
    if args.placement:
        from dgl_operator_tpu_torch.autotune.placement import (
            apply_elastic_entries, apply_to_entries, load_placement)
        placed = load_placement(args.placement)
        if placed.get("elastic"):
            # elastic plan (launcher/elastic.py): line i = host of
            # partition i, survivors repeated — the one-line-per-host
            # bijection check would reject the shrunk mapping
            entries = apply_elastic_entries(parse_hostfile(src),
                                            placed["assignment"])
        else:
            entries = apply_to_entries(parse_hostfile(src),
                                       placed["assignment"])
        src = os.path.join(args.workspace, "hostfile_placed")
        write_hostfile(src, entries)
    revise_hostfile(src,
                    os.path.join(args.workspace, "hostfile_revised"),
                    style=style, num_servers=args.num_servers)


if __name__ == "__main__":
    main()
