"""Host-side graph kernels: the C++ graph core and its plain versions.

``native/graphcore.cc`` carries CSR construction, fanout sampling,
frontier compaction and the partitioner's kernels (greedy BFS
partition, heavy-edge-matching coarsening, boundary refinement). Its C
ABI is the JAX package's, so the same seeds give the same samples and
partitions in both packages. It is compiled with the host C++ compiler
at first use (``ops/_build.py::build_host``) and called through
``ctypes``, which releases the interpreter lock for the length of a
call, so sampler threads overlap. A library that fails to build or to
bind raises: nothing here falls back to numpy unasked.

The ``*_plain`` functions are numpy versions of the same contracts,
for tests and for ``chip_smoke.py`` to hold the library against; the
main path never calls them. ``build_csr_plain``,
``compact_frontier_plain`` (uncapped) and ``hem_coarsen_plain`` (on
integer weights) give the library's exact output.
``sample_fanout_plain`` agrees on every seed of degree at most the
fanout and draws other picks on other rows; ``compact_frontier_plain``
with a cap keeps another random subset of the new nodes, and
``refine_boundary_plain`` is a capacity-admitted majority sweep, not
the library's worklist: the same contract, other moves.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p, i64p, f32p = _I32P, _I64P, _F32P
    lib.gc_build_csr.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int64,
                                 i64p, i32p, i64p]
    lib.gc_build_csr.restype = None
    lib.gc_sample_fanout.argtypes = [i64p, i32p, i64p, ctypes.c_int64,
                                     i64p, ctypes.c_int64, ctypes.c_int32,
                                     ctypes.c_uint64, i32p, i32p]
    lib.gc_sample_fanout.restype = None
    lib.gc_greedy_partition.argtypes = [i64p, i32p, ctypes.c_int64,
                                        ctypes.c_int32, ctypes.c_uint64, i32p]
    lib.gc_greedy_partition.restype = None
    lib.gc_compact_frontier.argtypes = [i64p, ctypes.c_int64, i32p,
                                        ctypes.c_int64, ctypes.c_int32,
                                        ctypes.c_int64, ctypes.c_uint64,
                                        i64p, i64p, i32p, f32p]
    lib.gc_compact_frontier.restype = None
    lib.gc_hem_coarsen.argtypes = [i32p, i32p, f32p, ctypes.c_int64, f32p,
                                   ctypes.c_int64, ctypes.c_uint64, i32p,
                                   i32p, i32p, f32p, f32p, i64p, i64p]
    lib.gc_hem_coarsen.restype = None
    lib.gc_refine_boundary.argtypes = [i32p, i32p, f32p, ctypes.c_int64,
                                       f32p, ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_double, ctypes.c_int64, i32p]
    lib.gc_refine_boundary.restype = None
    return lib


def library() -> ctypes.CDLL:
    """The graph core, built and bound at first use."""
    # imported here: ops/ imports the graph layer
    from dgl_operator_tpu_torch.ops import _build
    return _build.load_host("graphcore.cc", _bind)


def _as(arr: np.ndarray, ptr):
    return arr.ctypes.data_as(ptr)


def _seed(seed: int) -> np.uint64:
    return np.uint64(int(seed) & ((1 << 64) - 1))


def _check_ids(name: str, ids: np.ndarray, n: int) -> None:
    """Raise unless every id lies in ``[0, n)``: the library indexes
    arrays of ``n`` entries with them."""
    if len(ids) and (int(ids.min()) < 0 or int(ids.max()) >= n):
        raise ValueError(f"{name} must lie in [0, {n}); got "
                         f"[{ids.min()}, {ids.max()}]")


def _check_csr(indptr: np.ndarray, indices: np.ndarray,
               eids: Optional[np.ndarray] = None) -> None:
    if indptr.ndim != 1 or len(indptr) < 1 or indptr[0] != 0:
        raise ValueError("indptr must be a 1-D array starting at 0")
    if indices.shape[0] < int(indptr[-1]) or (
            eids is not None and eids.shape[0] < int(indptr[-1])):
        raise ValueError(f"indptr ends at {int(indptr[-1])}; indices has "
                         f"{indices.shape[0]} entries"
                         + ("" if eids is None
                            else f", eids {eids.shape[0]}"))


# ----------------------------------------------------------------------
# CSR construction
def build_csr(rows: np.ndarray, cols: np.ndarray, num_nodes: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Counting-sort COO into CSR; returns (indptr int64, indices int32,
    eids int64), rows grouped in ascending order, each row's entries in
    input order."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    if rows.shape != cols.shape or rows.ndim != 1:
        raise ValueError("rows and cols must be equal-length 1-D arrays")
    _check_ids("rows", rows, num_nodes)
    ne = rows.shape[0]
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    indices = np.empty(ne, dtype=np.int32)
    eids = np.empty(ne, dtype=np.int64)
    library().gc_build_csr(_as(rows, _I32P), _as(cols, _I32P), ne,
                           num_nodes, _as(indptr, _I64P),
                           _as(indices, _I32P), _as(eids, _I64P))
    return indptr, indices, eids


def build_csr_plain(rows: np.ndarray, cols: np.ndarray, num_nodes: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`build_csr` in numpy: a stable argsort is the counting
    sort here."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    perm = np.argsort(rows, kind="stable")
    counts = np.bincount(rows, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, cols[perm].astype(np.int32), perm.astype(np.int64)


# ----------------------------------------------------------------------
# Sampling
def sample_fanout(indptr: np.ndarray, indices: np.ndarray, eids: np.ndarray,
                  seeds: np.ndarray, fanout: int, seed: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform fixed-fanout neighbor sampling without replacement
    (Floyd's algorithm over a splitmix64 stream keyed by ``seed`` and
    the node): a node with degree <= fanout keeps all its neighbors in
    CSR order and pads the remaining slots with -1; a seed outside the
    graph gets a row of -1.

    Returns (nbr[num_seeds, fanout] int32 edge-endpoint node ids,
    nbr_eid[num_seeds, fanout] int32 edge positions) with -1 padding.
    """
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    eids = np.ascontiguousarray(eids, dtype=np.int64)
    seeds = np.ascontiguousarray(seeds, dtype=np.int64)
    _check_csr(indptr, indices, eids)
    ns, fanout = seeds.shape[0], int(fanout)
    if fanout < 0:
        raise ValueError(f"fanout must be >= 0, got {fanout}")
    nbr = np.empty((ns, fanout), dtype=np.int32)
    nbr_eid = np.empty((ns, fanout), dtype=np.int32)
    library().gc_sample_fanout(_as(indptr, _I64P), _as(indices, _I32P),
                               _as(eids, _I64P), indptr.shape[0] - 1,
                               _as(seeds, _I64P), ns, fanout, _seed(seed),
                               _as(nbr, _I32P), _as(nbr_eid, _I32P))
    return nbr, nbr_eid


def sample_fanout_plain(indptr: np.ndarray, indices: np.ndarray,
                        eids: np.ndarray, seeds: np.ndarray, fanout: int,
                        seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`sample_fanout` in numpy, drawing its picks from
    ``np.random.default_rng(seed)``: rows of degree <= fanout are the
    library's; other rows hold other uniform picks."""
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
    """One sampling layer's frontier compaction: returns (src_nodes
    int64, pos[ns, fanout] int32, mask[ns, fanout] float32). New unique
    neighbors are appended *sorted* after the frontier prefix; with a
    cap, a uniform random subset of the NEW nodes is kept (a partial
    Fisher-Yates over a splitmix64 stream keyed by ``seed``) and the
    slots of dropped ones get position 0 and mask 0."""
    frontier = np.ascontiguousarray(frontier, dtype=np.int64)
    nbr = np.ascontiguousarray(nbr, dtype=np.int32)
    if nbr.ndim != 2:
        raise ValueError(f"nbr must be [num_seeds, fanout], got {nbr.shape}")
    ns, fanout = nbr.shape
    nf = frontier.shape[0]
    src = np.empty(nf + ns * fanout, dtype=np.int64)
    n_src = np.zeros(1, dtype=np.int64)
    pos = np.empty((ns, fanout), dtype=np.int32)
    mask = np.empty((ns, fanout), dtype=np.float32)
    library().gc_compact_frontier(
        _as(frontier, _I64P), nf, _as(nbr, _I32P), ns, fanout,
        -1 if cap is None else int(cap), _seed(seed), _as(src, _I64P),
        _as(n_src, _I64P), _as(pos, _I32P), _as(mask, _F32P))
    return src[: int(n_src[0])].copy(), pos, mask


def compact_frontier_plain(frontier: np.ndarray, nbr: np.ndarray,
                           cap: Optional[int], seed: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`compact_frontier` in numpy: the library's output when
    uncapped; with a cap, another uniform subset of the new nodes
    (``np.random.default_rng(seed)``)."""
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


# ----------------------------------------------------------------------
# Partitioning (graph/partition.py)
def greedy_partition(indptr: np.ndarray, indices: np.ndarray,
                     num_parts: int, seed: int = 0) -> np.ndarray:
    """Greedy BFS edge-cut partition: ``num_parts`` regions grown
    breadth-first from spread seeds, the smallest part extended first.
    Returns one int32 part id per node."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    _check_csr(indptr, indices)
    n = indptr.shape[0] - 1
    _check_ids("indices", indices[: int(indptr[-1])], n)
    parts = np.empty(n, dtype=np.int32)
    library().gc_greedy_partition(_as(indptr, _I64P), _as(indices, _I32P),
                                  n, int(num_parts), _seed(seed),
                                  _as(parts, _I32P))
    return parts


def _weighted_coo(u, v, w, vw, num_nodes):
    u = np.ascontiguousarray(u, dtype=np.int32)
    v = np.ascontiguousarray(v, dtype=np.int32)
    w = np.ascontiguousarray(w, dtype=np.float32)
    vw = np.ascontiguousarray(vw, dtype=np.float32)
    n = int(num_nodes)
    if not u.shape == v.shape == w.shape or u.ndim != 1:
        raise ValueError("u, v and w must be equal-length 1-D arrays")
    if vw.shape != (n,):
        raise ValueError(f"vw must hold {n} vertex weights, got {vw.shape}")
    _check_ids("u", u, n)
    _check_ids("v", v, n)
    return u, v, w, vw, n


def hem_coarsen(u: np.ndarray, v: np.ndarray, w: np.ndarray,
                vw: np.ndarray, num_nodes: int, seed: int = 0):
    """One heavy-edge-matching coarsening level over an undirected
    weighted COO graph. Returns ``(coarse_id, num_coarse, cu, cv, cw,
    cvw)``: the fine->coarse map plus the contracted graph (each coarse
    pair once, ``cu < cv``, sorted; parallel edges merged with summed
    weight, self-loops dropped, vertex weights accumulated)."""
    u, v, w, vw, n = _weighted_coo(u, v, w, vw, num_nodes)
    ne = u.shape[0]
    coarse_id = np.empty(n, dtype=np.int32)
    cu = np.empty(max(ne, 1), dtype=np.int32)
    cv = np.empty(max(ne, 1), dtype=np.int32)
    cw = np.empty(max(ne, 1), dtype=np.float32)
    cvw = np.empty(max(n, 1), dtype=np.float32)
    nc = np.zeros(1, dtype=np.int64)
    nce = np.zeros(1, dtype=np.int64)
    library().gc_hem_coarsen(_as(u, _I32P), _as(v, _I32P), _as(w, _F32P),
                             ne, _as(vw, _F32P), n, _seed(seed),
                             _as(coarse_id, _I32P), _as(cu, _I32P),
                             _as(cv, _I32P), _as(cw, _F32P),
                             _as(cvw, _F32P), _as(nc, _I64P),
                             _as(nce, _I64P))
    k, m = int(nc[0]), int(nce[0])
    return (coarse_id, k, cu[:m].copy(), cv[:m].copy(), cw[:m].copy(),
            cvw[:k].copy())


_SM64_MASK = (1 << 64) - 1


def _splitmix64_py(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _SM64_MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _SM64_MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _SM64_MASK
    return x ^ (x >> 31)


def _sym_csr_numpy(u: np.ndarray, v: np.ndarray, w: np.ndarray, n: int):
    """Symmetric weighted CSR with the library's row order (u->v
    entries before v->u entries, each in input order)."""
    rows = np.concatenate([u, v])
    cols = np.concatenate([v, u])
    ws = np.concatenate([w, w])
    perm = np.argsort(rows, kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr, cols[perm], ws[perm]


def hem_coarsen_plain(u: np.ndarray, v: np.ndarray, w: np.ndarray,
                      vw: np.ndarray, num_nodes: int, seed: int = 0):
    """:func:`hem_coarsen` in numpy and Python loops: the same
    splitmix64 visit order, CSR traversal and tie-breaks, so the same
    matching and contracted graph. Weights are summed in float64, so
    they are the library's exactly where its float32 sums are exact
    (integer weights, as the partitioner's are)."""
    u = np.ascontiguousarray(u, dtype=np.int32)
    v = np.ascontiguousarray(v, dtype=np.int32)
    w = np.ascontiguousarray(w, dtype=np.float32)
    vw = np.ascontiguousarray(vw, dtype=np.float32)
    n = int(num_nodes)
    indptr, adj, aw = _sym_csr_numpy(u, v, w, n)
    perm = np.arange(n, dtype=np.int64)
    ctr = int(seed) & _SM64_MASK
    for i in range(n - 1):
        j = i + _splitmix64_py(ctr) % (n - i)
        ctr = (ctr + 1) & _SM64_MASK
        perm[i], perm[j] = perm[j], perm[i]
    match = np.full(n, -1, dtype=np.int64)
    for x in perm:
        if match[x] >= 0:
            continue
        lo, hi = int(indptr[x]), int(indptr[x + 1])
        best, bw = -1, np.float32(0.0)
        for p in range(lo, hi):
            y = int(adj[p])
            if y == x or match[y] >= 0:
                continue
            if best < 0 or aw[p] > bw:
                best, bw = y, aw[p]
        if best >= 0:
            match[x] = best
            match[best] = x
    coarse_id = np.full(n, -1, dtype=np.int32)
    nc = 0
    for x in range(n):
        if coarse_id[x] >= 0:
            continue
        coarse_id[x] = nc
        if match[x] >= 0:
            coarse_id[match[x]] = nc
        nc += 1
    cvw = np.zeros(nc, dtype=np.float64)
    np.add.at(cvw, coarse_id, vw.astype(np.float64))
    a = np.minimum(coarse_id[u], coarse_id[v]).astype(np.int64)
    b = np.maximum(coarse_id[u], coarse_id[v]).astype(np.int64)
    keep = a != b
    a, b = a[keep], b[keep]
    keys = a * nc + b
    uniq, inv = np.unique(keys, return_inverse=True)
    cw = np.bincount(inv, weights=w[keep].astype(np.float64),
                     minlength=len(uniq))
    return (coarse_id, nc, (uniq // nc).astype(np.int32),
            (uniq % nc).astype(np.int32), cw.astype(np.float32),
            cvw.astype(np.float32))


def refine_boundary(u: np.ndarray, v: np.ndarray, w: np.ndarray,
                    vw: np.ndarray, num_nodes: int, num_parts: int,
                    cap: float, iters: int, parts: np.ndarray) -> np.ndarray:
    """Boundary-restricted weighted refinement: a worklist seeded with
    the cut vertices moves each to its max-connection part when that
    reduces the weighted cut (or, on a tie, evens the parts, or drains
    a part above ``cap``), keeping every target within ``cap`` total
    vertex weight; at most ``iters * num_nodes`` visits. Returns the
    refined copy of ``parts``."""
    u, v, w, vw, n = _weighted_coo(u, v, w, vw, num_nodes)
    k = int(num_parts)
    parts = np.array(parts, dtype=np.int32)
    if parts.shape != (n,):
        raise ValueError(f"parts must hold {n} entries, got {parts.shape}")
    if k <= 1 or n == 0:
        return parts
    _check_ids("parts", parts, k)
    library().gc_refine_boundary(_as(u, _I32P), _as(v, _I32P),
                                 _as(w, _F32P), u.shape[0], _as(vw, _F32P),
                                 n, k, float(cap), max(int(iters), 1) * n,
                                 _as(parts, _I32P))
    return parts


def refine_boundary_plain(u: np.ndarray, v: np.ndarray, w: np.ndarray,
                          vw: np.ndarray, num_nodes: int, num_parts: int,
                          cap: float, iters: int, parts: np.ndarray,
                          seed: int = 0) -> np.ndarray:
    """:func:`refine_boundary`'s contract in numpy as ``iters``
    capacity-admitted weighted majority sweeps (a seeded random half of
    the candidates moves each sweep) plus a drain of parts above
    ``cap``: other moves than the library's."""
    u = np.ascontiguousarray(u, dtype=np.int32)
    v = np.ascontiguousarray(v, dtype=np.int32)
    w = np.ascontiguousarray(w, dtype=np.float32)
    vw = np.ascontiguousarray(vw, dtype=np.float32)
    parts = np.ascontiguousarray(parts, dtype=np.int32).copy()
    n, k = int(num_nodes), int(num_parts)
    if k <= 1 or n == 0:
        return parts
    rng = np.random.default_rng(seed)
    wd = w.astype(np.float64)
    vwd = vw.astype(np.float64)
    arange_n = np.arange(n)
    for _ in range(max(int(iters), 1)):
        keys1 = u.astype(np.int64) * k + parts[v]
        keys2 = v.astype(np.int64) * k + parts[u]
        hist = (np.bincount(keys1, weights=wd, minlength=n * k)
                + np.bincount(keys2, weights=wd, minlength=n * k)
                ).reshape(n, k)
        cur = hist[arange_n, parts]
        best = hist.argmax(1).astype(np.int32)
        gain = hist.max(1) - cur
        cand = np.nonzero((gain > 0) & (best != parts))[0]
        if len(cand) == 0:
            break
        cand = cand[rng.random(len(cand)) < 0.5]  # damp oscillation
        if len(cand) == 0:
            continue
        pw = np.bincount(parts, weights=vwd, minlength=k)
        moved = False
        for b in range(k):
            into = cand[best[cand] == b]
            if len(into) == 0:
                continue
            into = into[np.argsort(-gain[into])]
            take = np.cumsum(vwd[into]) <= cap - pw[b]
            into = into[take]
            if len(into) == 0:
                continue
            np.subtract.at(pw, parts[into], vwd[into])
            pw[b] += float(vwd[into].sum())
            parts[into] = b
            moved = True
        # drain over-cap parts: least-attached members leave first, each
        # to its max-connection part with room
        drained = False
        for b in np.nonzero(pw > cap)[0]:
            members = np.nonzero(parts == b)[0]
            for m in members[np.argsort(hist[members, b])]:
                if pw[b] <= cap:
                    break
                room = np.nonzero(pw + vwd[m] <= cap)[0]
                room = room[room != b]
                if len(room) == 0:
                    break
                tgt = room[np.argmax(hist[m, room])]
                parts[m] = tgt
                pw[tgt] += vwd[m]
                pw[b] -= vwd[m]
                drained = True
        if not (moved or drained):
            break
    return parts
