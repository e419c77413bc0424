"""Hostfile revision CLI — tools/revise_hostfile.py equivalent.

Runs on every worker during phase 4 (dglrun:188-207), rewriting the
operator hostfile (``ip port podname slots=N``) into the format the
training framework consumes, at ``<workspace>/hostfile_revised``:

- ``JAX``   → ``ip:port`` lines, coordinator first (what
  ``parallel.bootstrap.initialize_from_hostfile`` reads);
- ``DGL``   → ``ip port`` (revise_hostfile.py:27-36 parity);
- ``DGLKE`` → ``ip port num_servers`` (revise_hostfile.py:8-25 parity).

The port's copy of the JAX package's ``launcher/revise.py``. Its
``--placement`` (a skew-aware partition→host mapping from
``autotune/placement.py``) is not ported and raises
(``ROADMAP.md`` Queue 1 item 7c).
"""

from __future__ import annotations

import argparse
import os

from dgl_operator_tpu_torch.parallel.bootstrap import revise_hostfile


def main(argv=None):
    ap = argparse.ArgumentParser(description="Revise hostfile")
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--ip_config", required=True)
    ap.add_argument("--num_servers", type=int, default=1)
    ap.add_argument("--framework", required=True,
                    choices=["JAX", "DGL", "DGLKE"])
    ap.add_argument("--placement", default=None,
                    help="not ported (ROADMAP.md Queue 1 item 7c)")
    args, _ = ap.parse_known_args(argv)
    style = {"JAX": "jax", "DGL": "dgl", "DGLKE": "dglke"}[args.framework]
    os.makedirs(args.workspace, exist_ok=True)
    if args.placement:
        raise NotImplementedError(
            "--placement: the partition placement is not ported "
            "(ROADMAP.md Queue 1 item 7c)")
    revise_hostfile(args.ip_config,
                    os.path.join(args.workspace, "hostfile_revised"),
                    style=style, num_servers=args.num_servers)


if __name__ == "__main__":
    main()
