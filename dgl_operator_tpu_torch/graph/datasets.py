"""Node-classification datasets, knowledge-graph triples and graph
classification sets.

The generators draw from numpy in the same order as the JAX package's
``graph/datasets.py``, so the same seed gives the same graph, features,
labels and splits, the same triples and the same small graphs, in both
packages. The readers of staged on-disk copies take the datasets'
public layouts: the extracted OGB node-property CSVs
(:func:`_load_ogb_node_prop`), the LINQS ``cora.content`` /
``cora.cites`` files (:func:`_load_cora_content`) and the knowledge
graphs' triple directories (:func:`_load_triples_dir`); a loader given
a ``root`` without its files synthesizes the same shape, unless it is
``strict``. Nothing is downloaded.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
from typing import List, Optional, Tuple

import numpy as np

from dgl_operator_tpu_torch.graph.graph import Graph


@dataclasses.dataclass
class NodeClfDataset:
    graph: Graph
    num_classes: int
    name: str = "synthetic"
    # the generator's shape parameters of a synthetic_scale_graph: the
    # graph is reproducible from them alone
    gen_params: Optional[dict] = None


# ----------------------------------------------------------------------
# On-disk readers: each returns None when its files are absent
def _csv_path(dirname: str, stem: str) -> Optional[str]:
    """First existing variant of ``stem`` (.csv / .csv.gz / .txt /
    .txt.gz) in a directory."""
    for suffix in (".csv", ".csv.gz", ".txt", ".txt.gz"):
        p = os.path.join(dirname, stem + suffix)
        if os.path.exists(p):
            return p
    return None


def _load_ogb_node_prop(root: str, name: str) -> Optional[NodeClfDataset]:
    """Read an extracted OGB node-property dataset (the layout
    ``DglNodePropPredDataset`` unpacks):

        <root>/<name_>/raw/{edge,node-feat,node-label}.csv[.gz]
        <root>/<name_>/split/<scheme>/{train,valid,test}.csv[.gz]

    Edges are doubled by reversal; the first split scheme in name order
    sets the masks, or, with none shipped, :func:`_make_splits` seeded 0.
    """
    base = os.path.join(root, name.replace("-", "_"))
    raw = os.path.join(base, "raw")
    edge_p = _csv_path(raw, "edge")
    feat_p = _csv_path(raw, "node-feat")
    label_p = _csv_path(raw, "node-label")
    if not (edge_p and feat_p and label_p):
        return None
    edges = np.loadtxt(edge_p, delimiter=",", dtype=np.int64, ndmin=2)
    feat = np.loadtxt(feat_p, delimiter=",", dtype=np.float32, ndmin=2)
    label = np.loadtxt(label_p, delimiter=",", dtype=np.int64).reshape(-1)
    n = feat.shape[0]
    g = Graph(edges[:, 0].astype(np.int32), edges[:, 1].astype(np.int32),
              n).add_reverse_edges()
    g.ndata["feat"] = feat
    g.ndata["label"] = label.astype(np.int32)
    for k in ("train_mask", "val_mask", "test_mask"):
        g.ndata[k] = np.zeros(n, dtype=bool)
    split_dir = os.path.join(base, "split")
    scheme = None
    if os.path.isdir(split_dir):
        subdirs = sorted(d for d in os.listdir(split_dir)
                         if os.path.isdir(os.path.join(split_dir, d)))
        scheme = subdirs[0] if subdirs else None
    if scheme:
        sdir = os.path.join(split_dir, scheme)
        for stem, key in (("train", "train_mask"), ("valid", "val_mask"),
                          ("test", "test_mask")):
            p = _csv_path(sdir, stem)
            if p:
                ids = np.loadtxt(p, delimiter=",",
                                 dtype=np.int64).reshape(-1)
                g.ndata[key][ids] = True
    else:
        _make_splits(g, np.random.default_rng(0))
    return NodeClfDataset(g, int(label.max()) + 1, name)


def _load_cora_content(root: str) -> Optional[NodeClfDataset]:
    """Read the LINQS Cora files under ``root`` or ``root/cora``:
    ``cora.content`` (tab-separated ``<id> <w0..wN> <label>`` lines) and
    ``cora.cites`` (``<cited> <citing>`` pairs, an edge citing -> cited
    between known ids, doubled by reversal). Classes are numbered in
    name order; the splits are :func:`_make_splits` seeded 0."""
    for base in (root, os.path.join(root, "cora")):
        content = os.path.join(base, "cora.content")
        cites = os.path.join(base, "cora.cites")
        if os.path.exists(content) and os.path.exists(cites):
            break
    else:
        return None
    ids, feats, labels = [], [], []
    with open(content) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            ids.append(parts[0])
            feats.append([float(x) for x in parts[1:-1]])
            labels.append(parts[-1])
    id2ix = {v: i for i, v in enumerate(ids)}
    classes = {c: i for i, c in enumerate(sorted(set(labels)))}
    src, dst = [], []
    with open(cites) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            cited, citing = parts
            if cited in id2ix and citing in id2ix:
                src.append(id2ix[citing])
                dst.append(id2ix[cited])
    n = len(ids)
    g = Graph(np.asarray(src, np.int32), np.asarray(dst, np.int32),
              n).add_reverse_edges()
    g.ndata["feat"] = np.asarray(feats, np.float32)
    g.ndata["label"] = np.asarray([classes[c] for c in labels], np.int32)
    _make_splits(g, np.random.default_rng(0))
    return NodeClfDataset(g, len(classes), "cora")


def _power_law_edges(rng: np.random.Generator, num_nodes: int,
                     num_edges: int, alpha: float = 1.2
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Preferential-attachment-ish edge generator: dst drawn ~ rank^-alpha."""
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    dst = rng.choice(num_nodes, size=num_edges, p=probs).astype(np.int32)
    src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int32)
    keep = src != dst
    return src[keep], dst[keep]


def _power_law_dst(rng: np.random.Generator, num_nodes: int,
                   size: int, alpha: float) -> np.ndarray:
    """``size`` destination draws with P(rank) ~ rank^-alpha, by the
    inverse CDF of the bounded continuous Pareto on [1, N + 1): O(size)
    time and O(1) memory in ``num_nodes`` (``rng.choice(p=...)``'s
    [N] float64 table is 800 MB at papers100M's node count)."""
    u = rng.random(size)
    if abs(alpha - 1.0) < 1e-9:
        x = np.exp(u * np.log(num_nodes + 1.0))
    else:
        b = (num_nodes + 1.0) ** (1.0 - alpha)
        x = (1.0 - u * (1.0 - b)) ** (1.0 / (1.0 - alpha))
    return np.minimum(x.astype(np.int64) - 1, num_nodes - 1)


def power_law_edge_stream(num_nodes: int, num_edges: int,
                          alpha: float = 1.2, seed: int = 0,
                          chunk_edges: int = 1 << 22):
    """Yield the ``(src, dst)`` int32 chunks of a seeded power-law
    graph, the feed of ``graph/ooc.py::ChunkedEdgeWriter``. Self-loops
    are dropped a chunk at a time, so slightly fewer than ``num_edges``
    edges come out. Deterministic in every argument."""
    rng = np.random.default_rng(seed)
    remaining = int(num_edges)
    while remaining > 0:
        m = min(int(chunk_edges), remaining)
        dst = _power_law_dst(rng, num_nodes, m, alpha)
        src = rng.integers(0, num_nodes, size=m, dtype=np.int64)
        keep = src != dst
        yield src[keep].astype(np.int32), dst[keep].astype(np.int32)
        remaining -= m


def synthetic_scale_graph(num_nodes: int, num_edges: int,
                          feat_dim: int = 0, num_classes: int = 2,
                          alpha: float = 1.2, seed: int = 0,
                          out_dir: Optional[str] = None,
                          chunk_edges: int = 1 << 22) -> NodeClfDataset:
    """A power-law graph at papers100M-like shapes, generated a chunk
    at a time. With ``out_dir`` the edges stream through
    ``ooc.ChunkedEdgeWriter`` into memmap-backed files and the
    ``[N, feat_dim]`` features are written chunk by chunk to a mappable
    ``.npy``, so nothing edge- or feature-scale is resident; without
    it everything is. Features are class-centred gaussians, labels
    uniform; ``feat_dim=0`` draws none. ``gen_params`` records every
    shape parameter and the realized edge count."""
    params = {"num_nodes": int(num_nodes), "num_edges": int(num_edges),
              "feat_dim": int(feat_dim), "num_classes": int(num_classes),
              "alpha": float(alpha), "seed": int(seed),
              "chunk_edges": int(chunk_edges)}
    stream = power_law_edge_stream(num_nodes, num_edges, alpha, seed,
                                   chunk_edges)
    if out_dir is not None:
        from dgl_operator_tpu_torch.graph import ooc
        w = ooc.ChunkedEdgeWriter(os.path.join(out_dir, "edges"))
        for src, dst in stream:
            w.append(src, dst)
        g = w.finalize(num_nodes=num_nodes)
    else:
        chunks = list(stream)
        g = Graph(np.concatenate([c[0] for c in chunks])
                  if chunks else np.zeros(0, np.int32),
                  np.concatenate([c[1] for c in chunks])
                  if chunks else np.zeros(0, np.int32), num_nodes)
    params["num_edges_realized"] = int(g.num_edges)
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(0, num_classes, size=num_nodes)
    g.ndata["label"] = labels.astype(np.int32)
    if feat_dim > 0:
        centers = rng.normal(size=(num_classes, feat_dim)) \
            .astype(np.float32)
        chunk_rows = max(1, int(chunk_edges) // max(feat_dim, 1))
        if out_dir is not None:
            from numpy.lib.format import open_memmap
            feat = open_memmap(os.path.join(out_dir, "feat.npy"),
                               mode="w+", dtype=np.float32,
                               shape=(num_nodes, feat_dim))
        else:
            feat = np.empty((num_nodes, feat_dim), np.float32)
        for i0 in range(0, num_nodes, chunk_rows):
            sel = slice(i0, min(i0 + chunk_rows, num_nodes))
            feat[sel] = (centers[labels[sel]] + 0.8 * rng.normal(
                size=(sel.stop - sel.start, feat_dim))
                .astype(np.float32))
        if out_dir is not None:
            feat.flush()
            feat = np.load(os.path.join(out_dir, "feat.npy"),
                           mmap_mode="r")
        g.ndata["feat"] = feat
    _make_splits(g, rng)
    return NodeClfDataset(g, num_classes, "synthetic-scale",
                          gen_params=params)


def _make_splits(g: Graph, rng: np.random.Generator,
                 train_frac=0.6, val_frac=0.2) -> None:
    n = g.num_nodes
    perm = rng.permutation(n)
    n_tr, n_va = int(n * train_frac), int(n * val_frac)
    for k in ("train_mask", "val_mask", "test_mask"):
        g.ndata[k] = np.zeros(n, dtype=bool)
    g.ndata["train_mask"][perm[:n_tr]] = True
    g.ndata["val_mask"][perm[n_tr:n_tr + n_va]] = True
    g.ndata["test_mask"][perm[n_tr + n_va:]] = True


def _clustered_node_clf(name: str, num_nodes: int, num_edges: int,
                        feat_dim: int, num_classes: int, seed: int,
                        with_feats: bool = True) -> NodeClfDataset:
    """Node-classification graph with label-correlated structure and
    class-dependent gaussian features (homophily like citation
    networks).

    ``with_feats=False`` draws no ``[N, feat_dim]`` feature block (the
    largest cost at ogbn scale) and installs a zero broadcast view of
    its shape and dtype. The structure and labels are drawn first, so
    they are the same either way; the splits come from a later point
    of the stream and differ."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_nodes)
    src, dst = _power_law_edges(rng, num_nodes, num_edges)
    # rewire ~60% of edges to connect same-label nodes (homophily)
    same = rng.random(len(src)) < 0.6
    by_label = [np.nonzero(labels == c)[0] for c in range(num_classes)]
    src_label = labels[src]
    for c in range(num_classes):
        sel = np.nonzero(same & (src_label == c))[0]
        if len(sel) and len(by_label[c]):
            dst[sel] = rng.choice(by_label[c], size=len(sel))
    g = Graph(src, dst, num_nodes).add_reverse_edges()
    if with_feats:
        centers = rng.normal(size=(num_classes, feat_dim)).astype(
            np.float32)
        feat = centers[labels] + 0.8 * rng.normal(
            size=(num_nodes, feat_dim)).astype(np.float32)
        g.ndata["feat"] = feat.astype(np.float32)
    else:
        g.ndata["feat"] = np.broadcast_to(
            np.zeros((feat_dim,), np.float32), (num_nodes, feat_dim))
    g.ndata["label"] = labels.astype(np.int32)
    _make_splits(g, rng)
    return NodeClfDataset(g, num_classes, name)


def synthetic_node_clf(num_nodes: int, num_edges: int, feat_dim: int,
                       num_classes: int, seed: int = 0) -> NodeClfDataset:
    """Arbitrary-size homophilous node-classification graph."""
    return _clustered_node_clf("synthetic", num_nodes, num_edges, feat_dim,
                               num_classes, seed)


def cora(root: Optional[str] = None, seed: int = 0) -> NodeClfDataset:
    """Cora (the reference's node-classification example): the LINQS
    files under ``root`` when present (:func:`_load_cora_content`);
    otherwise a synthetic graph of its shape: 2,708 nodes, 5,278
    generated edges doubled by reversal, 1,433-dim features, 7
    classes."""
    if root:
        ds = _load_cora_content(root)
        if ds is not None:
            return ds
    return _clustered_node_clf("cora", 2708, 5278, 1433, 7, seed)


def ogbn_products(root: Optional[str] = None, seed: int = 0,
                  scale: float = 1.0, strict: bool = False,
                  with_feats: bool = True) -> NodeClfDataset:
    """ogbn-products (2.45M nodes, 61.9M edges, 100-dim features, 47
    classes): the extracted OGB layout under ``root`` when present
    (:func:`_load_ogb_node_prop`); otherwise a synthetic graph of its
    schema, ``scale`` shrinking the node and edge counts (30M generated
    edges, doubled by reversal, at scale 1). With ``strict`` a ``root``
    without that layout raises instead: a dataset the caller staged on
    purpose is never replaced by synthetic data. ``with_feats=False``
    draws no feature block (:func:`_clustered_node_clf`)."""
    if root:
        ds = _load_ogb_node_prop(root, "ogbn-products")
        if ds is not None:
            return ds
        if strict:
            raise FileNotFoundError(
                f"no OGB node-prop layout under {root!r} (expected "
                "<root>/ogbn_products/raw/{edge,node-feat,node-label}"
                ".csv[.gz]); refusing synthetic data for an explicitly "
                "staged dataset")
    n = max(1000, int(2_449_029 * scale))
    e = max(5000, int(30_000_000 * scale))
    return _clustered_node_clf("ogbn-products", n, e, 100, 47, seed,
                               with_feats=with_feats)


def link_pred_graph(num_nodes: int = 2708, num_edges: int = 5278,
                    feat_dim: int = 64, num_classes: int = 7,
                    latent_dim: int = 16, seed: int = 0
                    ) -> NodeClfDataset:
    """Citation-shaped graph whose edges encode latent proximity (the
    link-prediction workload): each node gets a unit latent (class
    centre plus noise); an edge's end is the most similar node of a
    random pool of 12 (the node itself excluded), so an encoder can
    recover the pairs; features are a noisy projection of the latents.
    Edges are doubled by reversal."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_nodes)
    centers = rng.normal(size=(num_classes, latent_dim))
    z = centers[labels] + 0.7 * rng.normal(size=(num_nodes, latent_dim))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    # oversample, then trim: an argmax over a small pool per edge, no
    # N^2 similarity matrix
    src = rng.integers(0, num_nodes, size=num_edges * 2)
    pool = rng.integers(0, num_nodes, size=(num_edges * 2, 12))
    sims = np.einsum("ed,epd->ep", z[src], z[pool])
    sims[pool == src[:, None]] = -np.inf
    dst = pool[np.arange(len(src)), sims.argmax(axis=1)]
    keep = src != dst      # only all-self pools remain (tiny n)
    src, dst = src[keep][:num_edges], dst[keep][:num_edges]
    g = Graph(src.astype(np.int32), dst.astype(np.int32),
              num_nodes).add_reverse_edges()
    proj = rng.normal(size=(latent_dim, feat_dim))
    g.ndata["feat"] = (z @ proj + 0.5 * rng.normal(
        size=(num_nodes, feat_dim))).astype(np.float32)
    g.ndata["label"] = labels.astype(np.int32)
    _make_splits(g, rng)
    return NodeClfDataset(g, num_classes, "link-pred-graph")


def karate_club() -> NodeClfDataset:
    """Zachary's karate club: 34 nodes, its 78 edges doubled by
    reversal, one-hot features, the two factions as labels, splits from
    :func:`_make_splits` seeded 0. Deterministic, for small tests."""
    edges = [(0, i) for i in (1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 17,
                              19, 21, 31)]
    edges += [(1, i) for i in (2, 3, 7, 13, 17, 19, 21, 30)]
    edges += [(2, i) for i in (3, 7, 8, 9, 13, 27, 28, 32)]
    edges += [(3, 7), (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10),
              (5, 16), (6, 16), (8, 30), (8, 32), (8, 33), (9, 33),
              (13, 33), (14, 32), (14, 33), (15, 32), (15, 33), (18, 32),
              (18, 33), (19, 33), (20, 32), (20, 33), (22, 32), (22, 33),
              (23, 25), (23, 27), (23, 29), (23, 32), (23, 33), (24, 25),
              (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33),
              (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33),
              (31, 32), (31, 33), (32, 33)]
    src = np.array([e[0] for e in edges], dtype=np.int32)
    dst = np.array([e[1] for e in edges], dtype=np.int32)
    g = Graph(src, dst, 34).add_reverse_edges()
    g.ndata["feat"] = np.eye(34, dtype=np.float32)
    labels = np.zeros(34, dtype=np.int32)
    labels[[8, 9, 14, 15, 18, 20, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
            32, 33]] = 1
    g.ndata["label"] = labels
    _make_splits(g, np.random.default_rng(0))
    return NodeClfDataset(g, 2, "karate")


# ----------------------------------------------------------------------
# Knowledge-graph triples (the DGL-KE path)
@dataclasses.dataclass
class KGDataset:
    """Triple store with the DGL-KE split layout: ``(head, rel, tail)``
    int64 arrays per split."""
    train: Tuple[np.ndarray, np.ndarray, np.ndarray]
    valid: Tuple[np.ndarray, np.ndarray, np.ndarray]
    test: Tuple[np.ndarray, np.ndarray, np.ndarray]
    n_entities: int
    n_relations: int
    name: str = "synthetic-kg"


def _load_triples_dir(root: str) -> Optional[KGDataset]:
    """Read an FB15k-style triple directory: ``{train,valid,test}.txt``
    of tab-separated ``head<TAB>relation<TAB>tail`` (string names or raw
    ids), plus optional ``entities.dict`` / ``relations.dict`` id maps
    (``id<TAB>name`` lines). Names are interned in the order they are
    first met, after the dictionaries' ids. Returns None when there is no
    train split."""
    train_p = _csv_path(root, "train")
    if train_p is None or not train_p.endswith((".txt", ".txt.gz")):
        return None

    def read_dict(path):
        m = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) == 2:
                        m[parts[1]] = int(parts[0])
        return m

    ent = read_dict(os.path.join(root, "entities.dict"))
    rel = read_dict(os.path.join(root, "relations.dict"))

    def intern(table, key):
        if key not in table:
            table[key] = len(table)
        return table[key]

    def read_split(stem):
        p = _csv_path(root, stem)
        if p is None:
            e = np.zeros(0, np.int64)
            return e, e.copy(), e.copy()
        hs, rs, ts = [], [], []
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "rt") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) != 3:
                    continue
                h, r, t = parts
                hs.append(intern(ent, h))
                rs.append(intern(rel, r))
                ts.append(intern(ent, t))
        return (np.asarray(hs, np.int64), np.asarray(rs, np.int64),
                np.asarray(ts, np.int64))

    train = read_split("train")
    valid = read_split("valid")
    test = read_split("test")
    if len(train[0]) == 0:
        return None
    return KGDataset(train, valid, test, len(ent), len(rel),
                     os.path.basename(os.path.abspath(root)) or "kg")


def _synth_kg(seed: int, ne: int, nr: int, nt: int, eval_div: int,
              name: str) -> KGDataset:
    """Synthetic KG: long-tail relation frequency (``r ~ rank^-1.1``)
    and ``(h, r)``-correlated tails (70%; the rest uniform) so scorers
    have signal. The numpy draw order is the JAX package's."""
    rng = np.random.default_rng(seed)
    rel_p = np.arange(1, nr + 1, dtype=np.float64) ** -1.1
    rel_p /= rel_p.sum()

    def make(n):
        h = rng.integers(0, ne, size=n).astype(np.int64)
        r = rng.choice(nr, size=n, p=rel_p).astype(np.int64)
        t = ((h * 2654435761 + r * 40503) % ne).astype(np.int64)
        noise = rng.random(n) < 0.3
        t[noise] = rng.integers(0, ne, size=noise.sum())
        return h, r, t

    return KGDataset(make(nt), make(max(50, nt // eval_div)),
                     make(max(50, nt // eval_div)), ne, nr, name)


# the dglke --dataset registry: canonical directory casing, real
# (entities, relations, train triples), synthesis floors and the eval
# split divisor of each dataset
_KG_REGISTRY = {
    "fb15k": ("FB15k", (14_951, 1_345, 483_142), (100, 10, 1000), 100),
    "fb15k-237": ("FB15k-237", (14_541, 237, 272_115),
                  (100, 10, 1000), 100),
    "wn18": ("wn18", (40_943, 18, 141_442), (100, 10, 1000), 100),
    "wn18rr": ("wn18rr", (40_943, 11, 86_835), (100, 10, 1000), 100),
    "freebase": ("Freebase", (86_054_151, 14_824, 304_727_650),
                 (100, 10, 1000), 100),
    "wikidata5m": ("wikidata5m", (4_594_485, 822, 20_614_279),
                   (200, 8, 2000), 200),
}


def kg_dataset(name: str, root: Optional[str] = None, seed: int = 0,
               scale: float = 1.0) -> KGDataset:
    """The DGL-KE ``--dataset`` surface (FB15k, FB15k-237, wn18, wn18rr,
    Freebase, wikidata5m). Reads ``{train,valid,test}.txt`` under
    ``root`` (or ``root/<name>`` in the caller's, lowercase or canonical
    casing) when present; otherwise synthesizes the dataset's real shape
    cut to ``scale`` (:func:`_synth_kg`), never below its floors."""
    key = name.lower().replace("_", "-")
    if key not in _KG_REGISTRY:
        raise ValueError(f"unknown KG dataset {name!r} "
                         f"(choices: {sorted(_KG_REGISTRY)})")
    canonical, shape, floors, eval_div = _KG_REGISTRY[key]
    if root:
        seen = []
        for sub in (None, name, key, canonical):
            base = os.path.join(root, sub) if sub else root
            if base in seen:
                continue
            seen.append(base)
            if os.path.isdir(base):
                ds = _load_triples_dir(base)
                if ds is not None:
                    return ds
    ne, nr, nt = shape
    f_ne, f_nr, f_nt = floors
    return _synth_kg(seed, ne=max(f_ne, int(ne * scale)),
                     nr=max(f_nr, int(nr * scale)),
                     nt=max(f_nt, int(nt * scale)),
                     eval_div=eval_div, name=key)


def fb15k(root: Optional[str] = None, seed: int = 0,
          scale: float = 1.0) -> KGDataset:
    """FB15k: 14,951 entities, 1,345 relations, 483,142 train triples
    (the reference's DGL-KE job: ComplEx, dim 400, 2 workers)."""
    return kg_dataset("fb15k", root=root, seed=seed, scale=scale)


def wikidata5m(root: Optional[str] = None, seed: int = 0,
               scale: float = 1.0) -> KGDataset:
    """Wikidata5M: about 4.59M entities, 822 relations, 20.6M train
    triples (the scale that needs the sharded entity table)."""
    return kg_dataset("wikidata5m", root=root, seed=seed, scale=scale)


# ----------------------------------------------------------------------
# Graph classification (the GIN path)
@dataclasses.dataclass
class GraphClfDataset:
    graphs: List[Graph]
    labels: np.ndarray
    num_classes: int
    dim_nfeats: int
    name: str = "synthetic-graphs"


def gin_dataset(num_graphs: int = 300, seed: int = 0) -> GraphClfDataset:
    """A PROTEINS-shaped graph-classification set (the reference's
    GIN example), synthetic only: graph ``i`` has
    label ``i % 2``, 10 to 59 nodes and undirected edges drawn with
    probability 0.10 (label 0) or 0.25 (label 1), doubled by reversal;
    its ``attr`` features are ``[in-degree, 1]``."""
    rng = np.random.default_rng(seed)
    graphs, labels = [], []
    for i in range(num_graphs):
        y = i % 2
        n = int(rng.integers(10, 60))
        p = 0.10 if y == 0 else 0.25
        mask = np.triu(rng.random((n, n)) < p, 1)
        src, dst = np.nonzero(mask)
        if len(src) == 0:
            src, dst = np.array([0]), np.array([min(1, n - 1)])
        g = Graph(src.astype(np.int32), dst.astype(np.int32),
                  n).add_reverse_edges()
        deg = g.in_degrees().astype(np.float32)[:, None]
        g.ndata["attr"] = np.concatenate([deg, np.ones((n, 1), np.float32)],
                                         1)
        graphs.append(g)
        labels.append(y)
    return GraphClfDataset(graphs, np.array(labels, np.int32), 2, 2,
                           "proteins")
