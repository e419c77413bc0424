"""Partition books: writing one for a caller-supplied assignment, and
reading one back.

The on-disk format is the JAX package's (``graph/partition.py``), so a
book written by either package reads in the other::

    out_path/graph_name.json
    out_path/node_map.npy, out_path/edge_map.npy
    out_path/part{i}/{graph.npz,node_feat.npz,edge_feat.npz}

Each part owns its *core* nodes (assignment == part id) plus the
one-hop *halo* source nodes of its in-edges; local ids are ordered
``[core | halo]`` and the halo ownership manifest (owner part and core
row there) rides in ``graph.npz``. Computing an assignment (multilevel
or LDG) and out-of-core or quantized feature storage are not ported
yet.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from dgl_operator_tpu_torch.graph.graph import Graph


def core_rank_of(parts: np.ndarray, num_parts: int) -> np.ndarray:
    """Owner-local core row of every global node: its rank among its
    part's global ids, ascending — the local position the writer gives
    core nodes."""
    n = len(parts)
    counts = np.bincount(parts, minlength=num_parts).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    order = np.argsort(parts, kind="stable")  # part-major, id ascending
    rank = np.empty(n, dtype=np.int32)
    rank[order] = (np.arange(n, dtype=np.int64)
                   - np.repeat(starts, counts)).astype(np.int32)
    return rank


def partition_graph(g: Graph, graph_name: str, num_parts: int,
                    out_path: str, parts: Optional[np.ndarray] = None,
                    ooc: bool = False, feat_dtype: str = "float32") -> str:
    """Write the partition book of ``g`` under the assignment ``parts``
    (one part id per node) with float32 in-memory feature storage;
    returns the book's JSON path."""
    if parts is None:
        raise NotImplementedError(
            "computing a partition assignment is not ported; pass parts=")
    if ooc or feat_dtype != "float32":
        raise NotImplementedError(
            "only in-memory float32 feature storage is ported")
    parts = np.asarray(parts)
    if parts.shape != (g.num_nodes,):
        raise ValueError("parts must assign every node")
    if len(parts) and (parts.min() < 0 or parts.max() >= num_parts):
        raise ValueError(
            f"parts values must be in [0, {num_parts}); got "
            f"[{parts.min()}, {parts.max()}] — a node outside the "
            "range would silently land in no partition")
    parts = parts.astype(np.int32)
    os.makedirs(out_path, exist_ok=True)

    # an edge belongs to its destination's part (in-edges of core nodes
    # are local)
    edge_part = parts[g.dst]
    np.save(os.path.join(out_path, "node_map.npy"), parts)
    np.save(os.path.join(out_path, "edge_map.npy"), edge_part.astype(np.int32))
    core_rank = core_rank_of(parts, num_parts)
    meta = {
        "graph_name": graph_name,
        "num_parts": int(num_parts),
        "num_nodes": int(g.num_nodes),
        "num_edges": int(g.num_edges),
        "part_method": "caller-supplied-numpy",
        "node_map": "node_map.npy",
        "edge_map": "edge_map.npy",
        "halo_hops": 1,
        "halo_manifest": 1,
    }
    for p in range(num_parts):
        pdir = os.path.join(out_path, f"part{p}")
        os.makedirs(pdir, exist_ok=True)
        core = np.nonzero(parts == p)[0]
        own_edges = np.nonzero(edge_part == p)[0]
        src, dst = g.src[own_edges], g.dst[own_edges]
        # local node set: core first (inner prefix), then halo sources
        halo = np.setdiff1d(np.unique(src), core)
        local_nodes = np.concatenate([core, halo]).astype(np.int64)
        g2l = np.full(g.num_nodes, -1, dtype=np.int32)
        g2l[local_nodes] = np.arange(len(local_nodes), dtype=np.int32)
        np.savez(os.path.join(pdir, "graph.npz"),
                 src=g2l[src], dst=g2l[dst],
                 orig_id=local_nodes,
                 orig_eid=own_edges.astype(np.int64),
                 inner_node=(np.arange(len(local_nodes)) < len(core)),
                 num_nodes=np.int64(len(local_nodes)),
                 halo_owner_part=parts[halo].astype(np.int32),
                 halo_owner_local=core_rank[halo].astype(np.int32))
        np.savez(os.path.join(pdir, "node_feat.npz"),
                 **{k: np.asarray(v)[local_nodes]
                    for k, v in g.ndata.items()})
        np.savez(os.path.join(pdir, "edge_feat.npz"),
                 **{k: v[own_edges] for k, v in g.edata.items()})
        meta[f"part-{p}"] = {
            "node_feats": f"part{p}/node_feat.npz",
            "edge_feats": f"part{p}/edge_feat.npz",
            "part_graph": f"part{p}/graph.npz",
            "num_inner_nodes": int(len(core)),
            "num_local_nodes": int(len(local_nodes)),
            "num_edges": int(len(own_edges)),
        }
    cfg = os.path.join(out_path, f"{graph_name}.json")
    with open(cfg, "w") as f:
        json.dump(meta, f, sort_keys=True, indent=4)
    return cfg


class GraphPartition:
    """One loaded partition: local graph (``[core | halo]`` order, global
    ids in ``orig_id``) + features + the partition book's node map."""

    def __init__(self, part_dir_cfg: str, part_id: int):
        with open(part_dir_cfg) as f:
            self.meta = json.load(f)
        base = os.path.dirname(part_dir_cfg)
        self.part_id = part_id
        info = self.meta[f"part-{part_id}"]
        gz = np.load(os.path.join(base, info["part_graph"]))
        self.graph = Graph(gz["src"], gz["dst"], int(gz["num_nodes"]))
        self.orig_id = gz["orig_id"]
        self.orig_eid = gz["orig_eid"]
        self.inner_node = gz["inner_node"]
        self._halo_owner_part = (np.asarray(gz["halo_owner_part"])
                                 if "halo_owner_part" in gz.files
                                 else None)
        self._halo_owner_local = (np.asarray(gz["halo_owner_local"])
                                  if "halo_owner_local" in gz.files
                                  else None)
        nf = np.load(os.path.join(base, info["node_feats"]))
        self.graph.ndata.update({k: nf[k] for k in nf.files})
        # file-referenced feature entries: one .npy per key, opened
        # mmap'd so reads demand-page from disk
        for k, rel in info.get("node_feat_files", {}).items():
            self.graph.ndata[k] = np.load(os.path.join(base, rel),
                                          mmap_mode="r")
        ef = np.load(os.path.join(base, info["edge_feats"]))
        self.graph.edata.update({k: ef[k] for k in ef.files})
        self.node_map = np.load(os.path.join(base, self.meta["node_map"]))

    @property
    def num_inner(self) -> int:
        return int(self.inner_node.sum())

    def _build_halo_manifest(self) -> None:
        """Reconstruct the halo ownership manifest from the node map
        (books written before the ``halo_manifest`` key)."""
        halo_gids = self.orig_id[~self.inner_node]
        rank = core_rank_of(self.node_map, int(self.meta["num_parts"]))
        self._halo_owner_part = self.node_map[halo_gids].astype(np.int32)
        self._halo_owner_local = rank[halo_gids].astype(np.int32)

    @property
    def halo_owner_part(self) -> np.ndarray:
        """[num_halo] int32 — owning part of each halo row."""
        if self._halo_owner_part is None:
            self._build_halo_manifest()
        return self._halo_owner_part

    @property
    def halo_owner_local(self) -> np.ndarray:
        """[num_halo] int32 — each halo row's core row in its owner."""
        if self._halo_owner_local is None:
            self._build_halo_manifest()
        return self._halo_owner_local

    def check_float_features(self, key: str) -> None:
        """Raise unless the book stores ``key`` as float values: the
        port does not read quantized feature codes yet."""
        if key in self.meta.get("feat_quant", {}):
            raise NotImplementedError(
                f"node feature {key!r} is stored as quantized codes; "
                "quantized books are not ported yet")
