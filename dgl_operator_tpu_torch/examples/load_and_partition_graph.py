"""The partitioner's entry point: load ogbn-products and partition it.

The counterpart of the JAX package's ``examples/GraphSAGE_dist/
load_and_partition_graph.py`` (the launcher's phase 1): the dataset from
``--dataset_url`` (a ``file://`` URL or a local path to a directory, or
a zip or tar archive, in the public OGB layout; read strictly, so a
staged dataset that does not parse fails the phase) or, without one,
the synthetic graph cut to ``--dataset_scale``; then the port's
``graph/partition.py::partition_graph`` with ``--part_method``,
``--refine_iters``, the train-mask and edge balance and the label
community hint, writing the book under ``<workspace>/<rel_data_path>``.
Run it as ``python -m
dgl_operator_tpu_torch.examples.load_and_partition_graph``; it runs on
the host alone. :func:`main` returns the book's JSON path.
"""

from __future__ import annotations

# the repo root on sys.path, so the launcher can start this file by path
import os as _os, sys as _sys  # noqa: E401
_sys.path.insert(0, _os.path.abspath(_os.path.join(
    _os.path.dirname(__file__), "..", "..")))

import argparse
import os
import shutil
import tarfile
import zipfile

from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.partition import partition_graph


def stage_dataset_url(url: str, workspace: str) -> str:
    """The local root directory of ``--dataset_url``: a directory is
    used in place; a zip or tar archive is extracted into
    ``<workspace>/dataset_download`` (tar members by ``filter="data"``,
    which refuses absolute, escaping and link members); any other file
    is copied there. Only ``file://`` URLs and plain paths are taken:
    an http(s) URL raises at once, and nothing is downloaded."""
    if url.startswith(("http://", "https://")):
        raise RuntimeError(
            f"no network access for {url}; stage the dataset on a volume "
            "and pass file://<path>")
    path = url[len("file://"):] if url.startswith("file://") else url
    if os.path.isdir(path):
        return path
    if not os.path.exists(path):
        raise FileNotFoundError(f"--dataset_url target missing: {path}")
    dest = os.path.join(workspace, "dataset_download")
    os.makedirs(dest, exist_ok=True)
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            z.extractall(dest)
    elif tarfile.is_tarfile(path):
        with tarfile.open(path) as t:
            t.extractall(dest, filter="data")
    else:
        shutil.copy(path, dest)
    return dest


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graph_name", default="ogbn-products")
    ap.add_argument("--workspace", default="/tpu_workspace")
    ap.add_argument("--rel_data_path", default="dataset")
    ap.add_argument("--dataset_url", default="",
                    help="file:// URL or local path of a staged dataset "
                         "(a directory, or a zip or tar archive, in the "
                         "public OGB layout); empty: the synthetic graph")
    ap.add_argument("--balance_train", action="store_true")
    ap.add_argument("--balance_edges", action="store_true")
    ap.add_argument("--num_parts", type=int, default=2)
    ap.add_argument("--dataset_scale", type=float, default=1.0)
    ap.add_argument("--community_hint", choices=["none", "label"],
                    default="none",
                    help="seed the partitioner with the labels as "
                         "communities (kept only where it lowers the "
                         "balance-penalized edge cut)")
    ap.add_argument("--part_method", choices=["multilevel", "flat"],
                    default="multilevel",
                    help="multilevel: coarsen, seed competition, boundary "
                         "refinement; flat: one level of seed competition "
                         "and label-propagation refinement")
    ap.add_argument("--refine_iters", type=int, default=None,
                    help="boundary-refinement passes (default: the "
                         "method's own)")
    args, _ = ap.parse_known_args(argv)

    root = (stage_dataset_url(args.dataset_url, args.workspace)
            if args.dataset_url else None)
    ds = datasets.ogbn_products(root=root, scale=args.dataset_scale,
                                strict=root is not None)
    out_dir = os.path.join(args.workspace, args.rel_data_path)
    g = ds.graph
    cfg = partition_graph(
        g, args.graph_name, args.num_parts, out_dir,
        balance_ntypes=g.ndata["train_mask"] if args.balance_train
        else None,
        balance_edges=args.balance_edges,
        communities=g.ndata["label"] if args.community_hint == "label"
        else None,
        part_method=args.part_method, refine_iters=args.refine_iters)
    print(f"partitioned {args.graph_name} into {args.num_parts} parts "
          f"at {cfg}")
    return cfg


if __name__ == "__main__":
    main()
