"""Out-of-core graph ingestion and index construction: the partitioner
under a bounded resident working set.

The in-memory partitioner holds the edge list, every coarsening level
and the CSR permutation at once: fine at ogbn-products' size, not at
papers100M's (1.6B edges, 13 GB per int32 edge array, times the level
stack). This module keeps the edge-scale state on disk and bounds what
is resident to a budget (``ooc_budget_mb``, ``autotune/knobs.py``):

- :class:`ChunkedEdgeWriter`: append ``(src, dst)`` chunks of any size,
  then finalize into memory-mapped int32 edge arrays inside a normal
  :class:`~dgl_operator_tpu_torch.graph.graph.Graph` (a memmap is an
  ndarray, so every consumer works unchanged, paging pieces in);
- :func:`ooc_build_csr`: a chunked counting sort of COO into CSR whose
  edge-scale outputs are ``.npy`` memmaps. In-order placement makes it
  a stable sort by row, so it equals ``_native.build_csr`` byte for
  byte;
- :func:`spill` and the ``spill_dir`` of
  :func:`~dgl_operator_tpu_torch.graph.partition.multilevel_partition`:
  each coarsening level is written to disk as it is made and read back
  as a memmap while uncoarsening. ``np.save`` keeps the bits, so a
  spilled run gives the resident run's partition.

Nothing here changes an algorithm, only where the arrays live.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
from numpy.lib.format import open_memmap

# the streaming granularity without a budget (ooc_budget_mb overrides)
_DEFAULT_CHUNK_BYTES = 64 << 20


def rows_per_chunk(bytes_per_row: int,
                   budget_mb: Optional[int] = None) -> int:
    """Streaming chunk length under the working-set budget. The budget
    covers one resident chunk and its scratch (sort order and
    positions, about 4x the row bytes), hence the / 4."""
    budget = (int(budget_mb) << 20) if budget_mb else _DEFAULT_CHUNK_BYTES
    return max(1, budget // max(4 * bytes_per_row, 1))


# ----------------------------------------------------------------------
class ChunkedEdgeWriter:
    """Streamed edge-list ingestion: :meth:`append` ``(src, dst)``
    chunks in arrival order, :meth:`finalize` into a memmap-backed
    ``Graph``. Chunks are appended to raw int32 files, so the edge list
    is never resident. Without a given node count, finalize scans the
    edges chunk by chunk."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self._src_path = os.path.join(out_dir, "edges_src.i32")
        self._dst_path = os.path.join(out_dir, "edges_dst.i32")
        self._src_f = open(self._src_path, "wb")
        self._dst_f = open(self._dst_path, "wb")
        self.num_edges = 0

    def append(self, src: np.ndarray, dst: np.ndarray) -> None:
        src = np.ascontiguousarray(src, dtype=np.int32)
        dst = np.ascontiguousarray(dst, dtype=np.int32)
        if src.shape != dst.shape or src.ndim != 1:
            raise ValueError("src/dst chunks must be equal-length 1-D")
        src.tofile(self._src_f)
        dst.tofile(self._dst_f)
        self.num_edges += len(src)

    def finalize(self, num_nodes: Optional[int] = None,
                 budget_mb: Optional[int] = None):
        """Close the ingest files and return the memmap-backed Graph."""
        from dgl_operator_tpu_torch.graph.graph import Graph
        self._src_f.close()
        self._dst_f.close()
        src = np.memmap(self._src_path, dtype=np.int32, mode="r") \
            if self.num_edges else np.empty(0, np.int32)
        dst = np.memmap(self._dst_path, dtype=np.int32, mode="r") \
            if self.num_edges else np.empty(0, np.int32)
        if num_nodes is None:
            step = rows_per_chunk(8, budget_mb)
            hi = -1
            for i0 in range(0, self.num_edges, step):
                hi = max(hi, int(src[i0:i0 + step].max(initial=-1)),
                         int(dst[i0:i0 + step].max(initial=-1)))
            num_nodes = hi + 1
        return Graph(src, dst, num_nodes)


# ----------------------------------------------------------------------
def ooc_build_csr(rows: np.ndarray, cols: np.ndarray, num_nodes: int,
                  out_dir: str, budget_mb: Optional[int] = None,
                  prefix: str = "csr"
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Chunked counting sort of COO into CSR with memmap-backed edge
    arrays: ``(indptr, indices, eids)`` as ``_native.build_csr`` gives
    them, indptr int64 resident, indices int32 and eids int64 as
    ``.npy`` memmaps under ``out_dir``. A counting pass accumulates the
    row degrees chunk by chunk; a placement pass puts each chunk's
    elements at their rows' next free slots in input order, a stable
    sort by row (``eids`` is ``argsort(rows, kind="stable")``)."""
    os.makedirs(out_dir, exist_ok=True)
    ne = int(np.shape(rows)[0])
    step = rows_per_chunk(8, budget_mb)
    counts = np.zeros(num_nodes, dtype=np.int64)
    for i0 in range(0, ne, step):
        counts += np.bincount(np.asarray(rows[i0:i0 + step]),
                              minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = open_memmap(os.path.join(out_dir, f"{prefix}_indices.npy"),
                          mode="w+", dtype=np.int32, shape=(ne,))
    eids = open_memmap(os.path.join(out_dir, f"{prefix}_eids.npy"),
                       mode="w+", dtype=np.int64, shape=(ne,))
    nxt = indptr[:-1].copy()
    for i0 in range(0, ne, step):
        r = np.asarray(rows[i0:i0 + step], dtype=np.int64)
        c = np.asarray(cols[i0:i0 + step], dtype=np.int32)
        order = np.argsort(r, kind="stable")
        rs = r[order]
        # an element's slot: its row's next free position plus its rank
        # in the row's run within this chunk
        starts = np.nonzero(np.r_[True, rs[1:] != rs[:-1]])[0] \
            if len(rs) else np.empty(0, np.int64)
        run_len = np.diff(np.append(starts, len(rs)))
        within = np.arange(len(rs)) - np.repeat(starts, run_len)
        pos = nxt[rs] + within
        indices[pos] = c[order]
        eids[pos] = i0 + order
        nxt[rs[starts]] += run_len   # run heads are unique rows
    indices.flush()
    eids.flush()
    return indptr, indices, eids


def attach_csr(g, csr: Tuple[np.ndarray, np.ndarray, np.ndarray],
               csc: Optional[Tuple[np.ndarray, np.ndarray,
                                   np.ndarray]] = None) -> None:
    """Install precomputed (possibly memmap-backed) CSR and CSC indexes
    on a Graph instead of building them resident."""
    g._csr = tuple(csr)
    if csc is not None:
        g._csc = tuple(csc)


# ----------------------------------------------------------------------
def column_stats(arr: np.ndarray, budget_mb: Optional[int] = None
                 ) -> list:
    """Chunked per-column ``(min[D], max[D])`` over a possibly mapped
    ``[N, D]`` array: the calibration that feeds
    ``quant.merge_column_stats`` without loading the matrix."""
    d = int(arr.shape[1])
    step = rows_per_chunk(max(d, 1) * 4, budget_mb)
    stats = []
    for i0 in range(0, len(arr), step):
        ch = np.asarray(arr[i0:i0 + step], np.float32)
        if len(ch):
            stats.append((ch.min(axis=0), ch.max(axis=0)))
    if not stats:
        z = np.zeros(d, np.float32)
        stats = [(z, z)]
    release_pages(arr)
    return stats


def write_part_feature(path: str, arr: np.ndarray,
                       local_nodes: np.ndarray,
                       budget_mb: Optional[int] = None,
                       codec=None, dtype=np.float32) -> None:
    """Chunked gather of ``arr[local_nodes]`` into a mappable ``.npy``
    file: the file-referenced feature write of a partition book.
    ``codec`` (a ``quant.quantize`` closure) maps each float32 chunk to
    the storage dtype; each chunk is written, flushed and its pages
    dropped before the next, so the writer holds one chunk."""
    d = int(arr.shape[1])
    out = open_memmap(path, mode="w+", dtype=np.dtype(dtype),
                      shape=(len(local_nodes), d))
    step = rows_per_chunk(max(d, 1) * 4, budget_mb)
    for i0 in range(0, len(local_nodes), step):
        sel = local_nodes[i0:i0 + step]
        rows = np.asarray(arr[sel], dtype=np.float32)
        out[i0:i0 + len(sel)] = codec(rows) if codec is not None else rows
        out.flush()
        release_pages(out, arr)
    del out


# ----------------------------------------------------------------------
def spill(spill_dir: str, name: str, arr: np.ndarray) -> np.ndarray:
    """Write ``arr`` to ``spill_dir/name.npy`` and return a read-only
    memmap of it: the same bits, no longer resident."""
    os.makedirs(spill_dir, exist_ok=True)
    path = os.path.join(spill_dir, f"{name}.npy")
    np.save(path, np.ascontiguousarray(arr))
    return np.load(path, mmap_mode="r")


def _backing_mmap(a):
    """The mmap object behind an array, along its ``.base`` chain
    (``Graph`` keeps plain-ndarray views of memmaps); None for an
    anonymous array."""
    while isinstance(a, np.ndarray):
        if isinstance(a, np.memmap):
            return getattr(a, "_mmap", None)
        a = a.base
    return None


def release_pages(*arrays) -> None:
    """Drop the resident pages behind file-backed arrays
    (``madvise(MADV_DONTNEED)`` on the mapping): pages once touched
    count toward the process's RSS until dropped. Values are untouched
    (later reads fault the pages in again), so this is paging policy
    only. A dirty writable mapping must be flushed first. Anonymous
    arrays and platforms without ``madvise`` are skipped."""
    import mmap as _mmaplib
    advise = getattr(_mmaplib, "MADV_DONTNEED", None)
    seen = set()
    for a in arrays:
        m = _backing_mmap(a) if isinstance(a, np.ndarray) else None
        if m is None or id(m) in seen or advise is None:
            continue
        seen.add(id(m))
        try:
            m.madvise(advise)
        except (AttributeError, ValueError, OSError):
            pass


def spilled_bytes(spill_dir: str) -> int:
    """Bytes on disk under the spill directory (a book's
    ``ooc_spill_mib``)."""
    total = 0
    for root, _, files in os.walk(spill_dir):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total
