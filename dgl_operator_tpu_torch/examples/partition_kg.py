"""KGE partitioner entry point (``dglke_partition``'s counterpart).

The counterpart of ``examples/DGL-KE/partition_kg.py`` of the JAX
package, with its flags: the KGE launcher's phase 1 runs it with
``--graph_name --workspace --num_parts --dataset`` (or a custom dataset
of entity, relation and train TSV files). It writes
``<workspace>/dataset/part<i>/triples.npz`` and
``<workspace>/dataset/<graph_name>.json``, with the relation-aware soft
partition unless ``--no_rel_part``; either package reads what the other
wrote. Run it as ``python -m dgl_operator_tpu_torch.examples.partition_kg``.
"""

from __future__ import annotations

# the repo root on sys.path, so the launcher can start this file by path
import os as _os, sys as _sys  # noqa: E401
_sys.path.insert(0, _os.path.abspath(_os.path.join(
    _os.path.dirname(__file__), "..", "..")))

import argparse
import os

import numpy as np

from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.kge_sampler import partition_kg


def _load_custom(entity_file, relation_file, train_file):
    """Triples of a custom dataset: entities and relations numbered by
    their line in their files, train lines ``head<TAB>rel<TAB>tail``."""
    def ids(path):
        with open(path) as f:
            return {ln.strip().split("\t")[0]: i
                    for i, ln in enumerate(f) if ln.strip()}

    ents, rels = ids(entity_file), ids(relation_file)
    h, r, t = [], [], []
    with open(train_file) as f:
        for ln in f:
            parts = ln.strip().split("\t")
            if len(parts) != 3:
                continue
            h.append(ents[parts[0]])
            r.append(rels[parts[1]])
            t.append(ents[parts[2]])
    return ((np.asarray(h), np.asarray(r), np.asarray(t)),
            len(ents), len(rels))


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graph_name", default="kg")
    ap.add_argument("--workspace", default="/tpu_workspace")
    ap.add_argument("--num_parts", type=int, default=2)
    ap.add_argument("--dataset", default="FB15k")
    ap.add_argument("--custom_name", default="")
    ap.add_argument("--entity_file", default="")
    ap.add_argument("--relation_file", default="")
    ap.add_argument("--train_file", default="")
    ap.add_argument("--dataset_scale", type=float, default=1.0)
    ap.add_argument("--no_rel_part", action="store_true")
    args, _ = ap.parse_known_args(argv)
    if args.custom_name:
        triples, ne, nr = _load_custom(args.entity_file, args.relation_file,
                                       args.train_file)
    else:
        ds = datasets.kg_dataset(args.dataset, scale=args.dataset_scale)
        triples, ne, nr = ds.train, ds.n_entities, ds.n_relations
    cfg = partition_kg(triples, ne, nr, args.num_parts,
                       os.path.join(args.workspace, "dataset"),
                       graph_name=args.graph_name,
                       rel_part=not args.no_rel_part)
    print(f"partitioned {len(triples[0])} triples ({ne} entities / {nr} "
          f"relations) into {args.num_parts} parts at {cfg}")
    return cfg


if __name__ == "__main__":
    main()
