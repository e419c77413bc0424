"""Host-side graph kernels: CSR construction, fanout sampling and
frontier compaction, in numpy.

These are the numpy bodies of the JAX package's ``graph/_native.py``
(whose C++ twins live in ``native/graphcore.cc``). The C++ sampler
draws from a different random stream than numpy, so the port keeps the
numpy bodies only: the same seed gives the same sample here as in the
JAX package run without its native library.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def build_csr(rows: np.ndarray, cols: np.ndarray, num_nodes: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Counting-sort COO into CSR; returns (indptr, indices, eids)."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    # stable argsort == counting sort here
    perm = np.argsort(rows, kind="stable")
    counts = np.bincount(rows, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, cols[perm].astype(np.int32), perm.astype(np.int64)


def sample_fanout(indptr: np.ndarray, indices: np.ndarray, eids: np.ndarray,
                  seeds: np.ndarray, fanout: int, seed: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform fixed-fanout neighbor sampling without replacement: a node
    with degree <= fanout keeps all its neighbors and pads the remaining
    slots with -1.

    Returns (nbr[num_seeds, fanout] int32 edge-endpoint node ids,
    nbr_eid[num_seeds, fanout] int32 edge positions) with -1 padding.
    """
    seeds = np.ascontiguousarray(seeds, dtype=np.int64)
    ns = seeds.shape[0]
    rng = np.random.default_rng(seed)
    nbr = np.full((ns, fanout), -1, dtype=np.int32)
    nbr_eid = np.full((ns, fanout), -1, dtype=np.int32)
    for i, s in enumerate(seeds):
        lo, hi = int(indptr[s]), int(indptr[s + 1])
        deg = hi - lo
        if deg == 0:
            continue
        if deg <= fanout:
            pick = np.arange(lo, hi)
        else:
            pick = lo + rng.choice(deg, size=fanout, replace=False)
        nbr[i, : len(pick)] = indices[pick]
        nbr_eid[i, : len(pick)] = eids[pick]
    return nbr, nbr_eid


def compact_frontier(frontier: np.ndarray, nbr: np.ndarray,
                     cap: Optional[int], seed: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One sampling layer's frontier compaction: returns (src_nodes,
    pos[ns, fanout] int32, mask[ns, fanout] float32). New unique
    neighbors are appended *sorted* after the frontier prefix; with a
    cap, a uniform random subset of the NEW nodes is kept and dropped
    slots are masked out."""
    frontier = np.ascontiguousarray(frontier, dtype=np.int64)
    nbr = np.ascontiguousarray(nbr, dtype=np.int32)
    nf = frontier.shape[0]
    valid = nbr >= 0
    uniq = np.unique(nbr[valid]).astype(np.int64)
    uniq = uniq[~np.isin(uniq, frontier, assume_unique=False)]
    if cap is not None and nf + len(uniq) > cap:
        keep_n = max(int(cap) - nf, 0)
        rng = np.random.default_rng(seed)
        keep = rng.choice(len(uniq), size=keep_n, replace=False)
        uniq = uniq[np.sort(keep)]
    src_nodes = np.concatenate([frontier, uniq])
    # map global neighbor ids -> position in src_nodes (binary search
    # over the sorted id array, then undo the sort); neighbors dropped
    # by the respill are not present — their slots get pos 0 / mask 0
    order = np.argsort(src_nodes, kind="stable")
    sorted_ids = src_nodes[order]
    pos = np.zeros(nbr.shape, dtype=np.int64)
    flat, vflat = nbr.reshape(-1), valid.reshape(-1)
    pos_flat = pos.reshape(-1)
    loc = np.minimum(np.searchsorted(sorted_ids, flat[vflat]),
                     max(len(sorted_ids) - 1, 0))
    found = sorted_ids[loc] == flat[vflat]
    pos_flat[vflat] = np.where(found, order[loc], 0)
    kept = vflat.copy()
    kept[vflat] = found
    return (src_nodes, pos.astype(np.int32),
            kept.reshape(valid.shape).astype(np.float32))
