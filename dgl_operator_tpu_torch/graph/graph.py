"""Host-side graph container.

The host owns the irregular data structure (numpy COO with a lazily built
CSC index). The card sees the dense ``[num_dst, fanout]`` neighbor
tables of sampled blocks (``graph/blocks.py``) and, for full-graph
inference, the CSC as a sparse adjacency (:meth:`Graph.adjacency`).
``ndata`` / ``edata`` are DGL-style dicts of numpy arrays.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dgl_operator_tpu_torch.graph import _native


class Graph:
    """A directed graph in COO form with a lazily-built CSC index.

    Parameters
    ----------
    src, dst : int arrays of equal length — directed edges src -> dst.
    num_nodes : total node count (>= max id + 1 if omitted).
    """

    def __init__(self, src, dst, num_nodes: Optional[int] = None):
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        if src.shape != dst.shape or src.ndim != 1:
            raise ValueError("src/dst must be equal-length 1-D arrays")
        if num_nodes is None:
            num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        self.src = src
        self.dst = dst
        self.num_nodes = int(num_nodes)
        self.ndata: Dict[str, np.ndarray] = {}
        self.edata: Dict[str, np.ndarray] = {}
        self._csc: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._adj: Dict[torch.device, torch.Tensor] = {}

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def __repr__(self) -> str:  # pragma: no cover
        return f"Graph(num_nodes={self.num_nodes}, num_edges={self.num_edges})"

    def csc(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Incoming adjacency (rows are destinations) as (indptr,
        indices, eids); eids map positions back to edge ids."""
        if self._csc is None:
            self._csc = _native.build_csr(self.dst, self.src, self.num_nodes)
        return self._csc

    def adjacency(self, device) -> torch.Tensor:
        """The in-edge adjacency as a sparse CSR ``[num_nodes,
        num_nodes]`` float32 tensor on ``device``: entry ``(v, u)`` is
        the number of edges ``u -> v`` (repeated edges are merged into
        one entry, columns sorted within each row). Built from
        :meth:`csc` once per device."""
        device = torch.device(device)
        if device not in self._adj:
            indptr, indices, _ = self.csc()
            n = self.num_nodes
            dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
            pairs, counts = np.unique(dst * n + indices, return_counts=True)
            crow = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(np.bincount(pairs // n, minlength=n), out=crow[1:])
            itype = torch.int32 if len(pairs) < 2**31 else torch.int64
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", "Sparse CSR tensor support "
                                        "is in beta state")
                warnings.filterwarnings("ignore", "Sparse invariant checks "
                                        "are implicitly disabled")
                self._adj[device] = torch.sparse_csr_tensor(
                    torch.from_numpy(crow).to(device, itype),
                    torch.from_numpy(pairs % n).to(device, itype),
                    torch.from_numpy(counts.astype(np.float32)).to(device),
                    size=(n, n), check_invariants=True)
        return self._adj[device]

    def add_reverse_edges(self) -> "Graph":
        g = Graph(np.concatenate([self.src, self.dst]),
                  np.concatenate([self.dst, self.src]), self.num_nodes)
        g.ndata = dict(self.ndata)
        return g
