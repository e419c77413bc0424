"""KGE edge partitioning and chunked negative sampling.

A copy of the JAX package's ``graph/kge_sampler.py`` (numpy only): the
same functions draw from numpy in the same order, so one seed gives the
same partitions and batch streams in both packages. Its parity with the
reference's DGL-KE sampler stack (``examples/DGL-KE/hotfix/sampler.py``):

- relation-aware edge partitioning across trainers:
  ``soft_relation_partition`` (large relations split evenly, small ones
  packed onto the least-loaded part), ``balanced_relation_partition``
  (strict equal-size parts), ``random_partition``;
- ``get_long_tail_partition``, the relation -> machine assignment;
- ``TrainDataset.create_sampler``: chunked negative sampling. A batch of
  B positives is split into C chunks and every chunk shares one block of
  N negative entities, so negative scoring is a ``[chunk, D] x [N, D]^T``
  batched GEMM (``nn/kge.py::neg_score``);
- ``EvalSampler`` and the head/tail-alternating
  ``BidirectionalOneShotIterator``;
- ``partition_kg`` / ``load_kg_partition``: the partitioned dataset's
  files, which either package reads from the other.

Samplers emit fixed-shape int32 numpy batches (the ragged tail batch is
dropped), and negatives are uniform entity draws on the host.
``draw_negatives=False`` skips that draw for the device negatives of
``DistKGETrainer(neg_sampler="device")`` (``ROADMAP.md`` Queue 1 item
8.2; ``ops/kge_negatives.py``), which sets it on every sampler it
creates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

Triples = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (heads, rels, tails)


# ------------------------------------------------------------ partition
def soft_relation_partition(triples: Triples, n: int,
                            threshold: float = 0.05):
    """Partition edge indices by relation: any relation with more edges
    than ``threshold`` (or more than one part's capacity) is spread
    evenly over all parts; small relations go wholly to the currently
    least-loaded part. Returns (edge_parts, rel_parts, has_cross,
    cross_rels) like sampler.py:32-144 — without the reference's
    in-place shuffle of the input arrays (parts index the caller's
    triples directly)."""
    heads, rels, tails = triples
    uniq, cnts = np.unique(rels, return_counts=True)
    order = np.argsort(cnts)[::-1]
    uniq, cnts = uniq[order], cnts[order]

    large = int(len(rels) * threshold)
    capacity = len(rels) // n
    large = min(large, capacity) if capacity > 0 else large

    edge_cnts = np.zeros(n, dtype=np.int64)
    rel_parts: List[List[int]] = [[] for _ in range(n)]
    # relation -> list of (part, remaining quota), consumed in order
    quota: Dict[int, List[List[int]]] = {}
    cross_rels = []
    for r, cnt in zip(uniq, cnts):
        if cnt > large:
            cross_rels.append(int(r))
            per = cnt // n + 1
            left = int(cnt)
            parts = []
            for j in range(n):
                take = min(per, left)
                parts.append([j, take])
                rel_parts[j].append(int(r))
                edge_cnts[j] += take
                left -= take
            quota[int(r)] = parts
        else:
            j = int(np.argmin(edge_cnts))
            quota[int(r)] = [[j, int(cnt)]]
            rel_parts[j].append(int(r))
            edge_cnts[j] += cnt

    parts: List[List[int]] = [[] for _ in range(n)]
    for i, r in enumerate(rels):
        slot = quota[int(r)][0]
        parts[slot[0]].append(i)
        slot[1] -= 1
        if slot[1] == 0:
            quota[int(r)].pop(0)
    edge_parts = [np.asarray(p, dtype=np.int64) for p in parts]
    rel_part_arrays = [np.asarray(sorted(rp), dtype=np.int64)
                       for rp in rel_parts]
    return (edge_parts, rel_part_arrays, len(cross_rels) > 0,
            np.asarray(cross_rels, dtype=np.int64))


def balanced_relation_partition(triples: Triples, n: int):
    """Strictly equal-size parts (sampler.py:150-255): walk relations
    from most to least frequent, filling each part to exactly
    ceil(E/n); a relation is split across parts only when it overflows
    the current part."""
    heads, rels, tails = triples
    uniq, cnts = np.unique(rels, return_counts=True)
    order = np.argsort(cnts)[::-1]
    uniq, cnts = uniq[order], cnts[order]
    capacity = -(-len(rels) // n)

    by_rel = {int(r): list(np.nonzero(rels == r)[0]) for r in uniq}
    parts: List[List[int]] = [[] for _ in range(n)]
    rel_parts: List[set] = [set() for _ in range(n)]
    cross_rels = set()
    j = 0
    for r in uniq:
        idxs = by_rel[int(r)]
        placed_in = []
        while idxs:
            room = capacity - len(parts[j])
            if room == 0:
                j += 1
                continue
            take, idxs = idxs[:room], idxs[room:]
            parts[j].extend(take)
            rel_parts[j].add(int(r))
            placed_in.append(j)
        if len(placed_in) > 1:
            cross_rels.add(int(r))
    return ([np.asarray(p, dtype=np.int64) for p in parts],
            [np.asarray(sorted(rp), dtype=np.int64) for rp in rel_parts],
            len(cross_rels) > 0,
            np.asarray(sorted(cross_rels), dtype=np.int64))


def random_partition(triples: Triples, n: int,
                     seed: int = 0) -> List[np.ndarray]:
    """Uniform shuffle split (sampler.py:256-295)."""
    heads, _, _ = triples
    idx = np.random.default_rng(seed).permutation(len(heads))
    return [np.asarray(p, dtype=np.int64) for p in np.array_split(idx, n)]


def get_long_tail_partition(n_relations: int, n_machine: int
                            ) -> np.ndarray:
    """Relation -> machine assignment for sharded relation embeddings
    (kvclient.py:56-121): walk relations in id order, always assigning
    to the machine with the fewest relations so the long tail spreads
    evenly. Returns an int64 array of machine ids per relation."""
    loads = np.zeros(n_machine, dtype=np.int64)
    out = np.empty(n_relations, dtype=np.int64)
    for r in range(n_relations):
        m = int(np.argmin(loads))
        out[r] = m
        loads[m] += 1
    return out


# -------------------------------------------------------------- sampler
@dataclasses.dataclass
class KGEBatch:
    """One fixed-shape training batch: positives [B] + per-chunk shared
    negatives [C, N]; ``neg_mode`` says which side the negatives
    replace."""
    h: np.ndarray
    r: np.ndarray
    t: np.ndarray
    neg_ids: np.ndarray
    neg_mode: str


class ChunkedEdgeSampler:
    """Chunked-negative edge sampler over one edge partition — the
    EdgeSampler(negative_mode=head|tail, chunk_size, ...) equivalent
    (sampler.py:404-419), emitting static shapes.

    ``exclude_positive`` resamples any negative that collides with its
    chunk's positive entities (the reference's true-negative filter)."""

    def __init__(self, triples: Triples, edge_ids: np.ndarray,
                 n_entities: int, batch_size: int, neg_sample_size: int,
                 neg_chunk_size: int, mode: str = "tail",
                 shuffle: bool = True, exclude_positive: bool = False,
                 seed: int = 0, draw_negatives: bool = True):
        if batch_size % neg_chunk_size != 0:
            raise ValueError("batch_size must be divisible by "
                             "neg_chunk_size")
        self.h, self.r, self.t = triples
        self.edge_ids = np.asarray(edge_ids, dtype=np.int64)
        self.n_entities = n_entities
        self.batch_size = batch_size
        self.neg_sample_size = neg_sample_size
        self.neg_chunk_size = neg_chunk_size
        self.num_chunks = batch_size // neg_chunk_size
        self.mode = mode
        self.shuffle = shuffle
        self.exclude_positive = exclude_positive
        # False when negatives are drawn elsewhere (a
        # device-side sampler): skips the [C, N] host draw per batch
        # and emits an empty neg_ids placeholder
        self.draw_negatives = draw_negatives
        if not draw_negatives and exclude_positive:
            raise ValueError("exclude_positive needs host-drawn "
                             "negatives (draw_negatives=True)")
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[KGEBatch]:
        order = (self.rng.permutation(self.edge_ids) if self.shuffle
                 else self.edge_ids)
        # static shapes: drop the ragged tail batch
        n_full = len(order) // self.batch_size
        if n_full == 0 and len(order) > 0:
            # partition smaller than one batch (small ranks of a large
            # mesh): sample with replacement so the rank still yields a
            # full static-shape batch instead of livelocking the
            # endless iterator (same move as DistTrainer's short-
            # partition seed repeat, runtime/dist.py)
            yield self._make_batch(
                self.rng.choice(order, size=self.batch_size,
                                replace=True))
            return
        for b in range(n_full):
            sel = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield self._make_batch(sel)

    def _make_batch(self, sel: np.ndarray) -> KGEBatch:
        h = self.h[sel].astype(np.int32)
        r = self.r[sel].astype(np.int32)
        t = self.t[sel].astype(np.int32)
        if not self.draw_negatives:
            return KGEBatch(h=h, r=r, t=t,
                            neg_ids=np.empty((0, 0), np.int32),
                            neg_mode=self.mode)
        neg = self.rng.integers(
            0, self.n_entities,
            size=(self.num_chunks, self.neg_sample_size)).astype(np.int32)
        if self.exclude_positive:
            pos = (t if self.mode == "tail" else h).reshape(
                self.num_chunks, self.neg_chunk_size)
            for c in range(self.num_chunks):
                bad = np.isin(neg[c], pos[c])
                while bad.any():
                    neg[c, bad] = self.rng.integers(
                        0, self.n_entities, size=int(bad.sum()))
                    bad = np.isin(neg[c], pos[c])
        return KGEBatch(h=h, r=r, t=t, neg_ids=neg, neg_mode=self.mode)


class BidirectionalOneShotIterator:
    """Endless iterator alternating tail- and head-corrupt batches,
    tail first (NewBidirectionalOneShotIterator parity: step starts at
    0, is incremented before the parity check, and odd steps draw from
    the tail sampler — sampler.py:843-855)."""

    def __init__(self, head_sampler: ChunkedEdgeSampler,
                 tail_sampler: ChunkedEdgeSampler):
        self._head = self._endless(head_sampler)
        self._tail = self._endless(tail_sampler)
        self.step = 0

    @staticmethod
    def _endless(sampler: ChunkedEdgeSampler) -> Iterator[KGEBatch]:
        while True:
            produced = False
            for b in sampler:
                produced = True
                yield b
            if not produced:
                # a zero-edge partition can never produce a batch; fail
                # loudly instead of spinning the training loop forever
                raise ValueError(
                    "KGE sampler yielded no batches: empty edge "
                    "partition for this rank")

    def __iter__(self):
        return self

    def __next__(self) -> KGEBatch:
        self.step += 1
        return next(self._head if self.step % 2 == 0 else self._tail)


class TrainDataset:
    """Edge-partitioned KGE training set (sampler.py:346-419).

    ``rel_part=True`` uses soft relation partitioning so most relations
    live wholly on one trainer (embedding locality); otherwise random.
    """

    def __init__(self, triples: Triples, n_entities: int,
                 n_relations: int, ranks: int = 1, rel_part: bool = True):
        self.triples = triples
        self.n_entities = n_entities
        self.n_relations = n_relations
        num_train = len(triples[0])
        if ranks > 1 and rel_part:
            (self.edge_parts, self.rel_parts, self.cross_part,
             self.cross_rels) = soft_relation_partition(triples, ranks)
        elif ranks > 1:
            self.edge_parts = random_partition(triples, ranks)
            self.rel_parts = [np.arange(n_relations)] * ranks
            self.cross_part = True
            self.cross_rels = np.arange(n_relations)
        else:
            self.edge_parts = [np.arange(num_train)]
            self.rel_parts = [np.arange(n_relations)]
            self.cross_part = False
            self.cross_rels = np.empty(0, dtype=np.int64)

    def create_sampler(self, batch_size: int, neg_sample_size: int = 2,
                       neg_chunk_size: Optional[int] = None,
                       mode: str = "tail", shuffle: bool = True,
                       exclude_positive: bool = False, rank: int = 0,
                       seed: int = 0,
                       draw_negatives: bool = True) -> ChunkedEdgeSampler:
        return ChunkedEdgeSampler(
            self.triples, self.edge_parts[rank], self.n_entities,
            batch_size, neg_sample_size,
            neg_chunk_size or batch_size, mode=mode, shuffle=shuffle,
            exclude_positive=exclude_positive, seed=seed,
            draw_negatives=draw_negatives)


def partition_kg(triples: Triples, n_entities: int, n_relations: int,
                 num_parts: int, out_dir: str, graph_name: str = "kg",
                 rel_part: bool = True) -> str:
    """Write a partitioned KG dataset: ``part{i}/triples.npz`` + one
    ``<graph_name>.json`` metadata file shaped like the graph-partition
    config so the same dispatch path ships it (tools/dispatch.py parity;
    the reference's KGE partitioning is dglke_partition, dglkerun:119-160).
    Returns the metadata JSON path."""
    import json
    import os

    if num_parts > 1 and rel_part:
        edge_parts, rel_parts, cross, cross_rels = soft_relation_partition(
            triples, num_parts)
    elif num_parts > 1:
        edge_parts = random_partition(triples, num_parts)
        rel_parts = [np.arange(n_relations)] * num_parts
        cross_rels = np.arange(n_relations)
    else:
        edge_parts = [np.arange(len(triples[0]))]
        rel_parts = [np.arange(n_relations)]
        cross_rels = np.empty(0, dtype=np.int64)

    h, r, t = triples
    meta = {"graph_name": graph_name, "num_parts": num_parts,
            "n_entities": int(n_entities), "n_relations": int(n_relations),
            "part_method": "soft_relation" if rel_part else "random",
            "cross_rels": [int(x) for x in cross_rels]}
    os.makedirs(out_dir, exist_ok=True)
    for p, eids in enumerate(edge_parts):
        pdir = os.path.join(out_dir, f"part{p}")
        os.makedirs(pdir, exist_ok=True)
        np.savez(os.path.join(pdir, "triples.npz"),
                 h=h[eids], r=r[eids], t=t[eids],
                 rel_part=rel_parts[p])
        meta[f"part-{p}"] = {
            "part_graph": os.path.join(f"part{p}", "triples.npz"),
            "num_edges": int(len(eids))}
    cfg = os.path.join(out_dir, f"{graph_name}.json")
    with open(cfg, "w") as f:
        json.dump(meta, f, sort_keys=True, indent=4)
    return cfg


def load_kg_partition(part_config: str, rank: int):
    """Load one partition written by :func:`partition_kg`. Returns
    (triples, meta, rel_part)."""
    import json
    import os

    with open(part_config) as f:
        meta = json.load(f)
    path = meta[f"part-{rank}"]["part_graph"]
    if not os.path.isabs(path):
        path = os.path.join(os.path.dirname(part_config), path)
    z = np.load(path)
    return (z["h"], z["r"], z["t"]), meta, z["rel_part"]


class EvalSampler:
    """Plain batched iterator over eval triples (sampler.py:651-720);
    ranking against all entities happens on device in
    ``runtime.kge.full_ranking_eval``. Pads the last batch by repeating
    its final triple so shapes stay static; ``valid`` marks real rows."""

    def __init__(self, triples: Triples, batch_size: int):
        self.h, self.r, self.t = (np.asarray(a) for a in triples)
        self.batch_size = batch_size

    def __iter__(self):
        n = len(self.h)
        for b in range(0, n, self.batch_size):
            sel = np.arange(b, min(b + self.batch_size, n))
            valid = np.ones(self.batch_size, dtype=bool)
            if len(sel) < self.batch_size:
                valid[len(sel):] = False
                sel = np.concatenate(
                    [sel, np.full(self.batch_size - len(sel), sel[-1])])
            yield (self.h[sel].astype(np.int32),
                   self.r[sel].astype(np.int32),
                   self.t[sel].astype(np.int32), valid)
