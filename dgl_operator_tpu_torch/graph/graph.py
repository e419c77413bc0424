"""Host-side graph container.

The host owns the irregular data structure (numpy COO with a lazily built
CSC index); the card only ever sees the dense ``[num_dst,
fanout]`` neighbor tables of sampled blocks (``graph/blocks.py``).
``ndata`` / ``edata`` are DGL-style dicts of numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

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

    def add_reverse_edges(self) -> "Graph":
        g = Graph(np.concatenate([self.src, self.dst]),
                  np.concatenate([self.dst, self.src]), self.num_nodes)
        g.ndata = dict(self.ndata)
        return g
