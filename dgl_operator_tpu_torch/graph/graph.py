"""Host-side graph container.

The host owns the irregular data structure (numpy COO with lazily built
CSR and CSC indexes, counted by the C++ graph core). The card sees the
dense ``[num_dst, fanout]`` neighbor tables of sampled blocks
(``graph/blocks.py``) and, for full-graph inference, the CSC as a
sparse adjacency (:meth:`Graph.adjacency`); the full-graph layers
(``nn/conv.py``: ``GraphConv``, ``GATConv``) read the padded edge list
of :meth:`Graph.to_device` (:class:`DeviceGraph`).
``ndata`` / ``edata`` are DGL-style dicts of numpy arrays.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dgl_operator_tpu_torch.graph import _native


def sparse_csr(crow: torch.Tensor, col: torch.Tensor, values: torch.Tensor,
               n: int, check_invariants: bool = False) -> torch.Tensor:
    """An ``[n, n]`` sparse CSR tensor (torch's beta-state warnings
    silenced)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support "
                                "is in beta state")
        warnings.filterwarnings("ignore", "Sparse invariant checks "
                                "are implicitly disabled")
        return torch.sparse_csr_tensor(crow, col, values, size=(n, n),
                                       check_invariants=check_invariants)


class Graph:
    """A directed graph in COO form with lazily-built CSR/CSC indexes.

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
        self._csr: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._csc: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._adj: Dict[torch.device, torch.Tensor] = {}

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def __repr__(self) -> str:  # pragma: no cover
        return f"Graph(num_nodes={self.num_nodes}, num_edges={self.num_edges})"

    def csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Outgoing adjacency (rows are sources) as (indptr, indices,
        eids); eids map positions back to edge ids."""
        if self._csr is None:
            self._csr = _native.build_csr(self.src, self.dst, self.num_nodes)
        return self._csr

    def csc(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Incoming adjacency (rows are destinations) as (indptr,
        indices, eids); eids map positions back to edge ids."""
        if self._csc is None:
            self._csc = _native.build_csr(self.dst, self.src, self.num_nodes)
        return self._csc

    def in_degrees(self) -> np.ndarray:
        indptr, _, _ = self.csc()
        return (indptr[1:] - indptr[:-1]).astype(np.int32)

    def out_degrees(self) -> np.ndarray:
        indptr, _, _ = self.csr()
        return (indptr[1:] - indptr[:-1]).astype(np.int32)

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
            self._adj[device] = sparse_csr(
                torch.from_numpy(crow).to(device, itype),
                torch.from_numpy(pairs % n).to(device, itype),
                torch.from_numpy(counts.astype(np.float32)).to(device), n,
                check_invariants=True)
        return self._adj[device]

    def add_self_loop(self) -> "Graph":
        """A new graph with one self-loop edge per node appended (node
        data shared, edge data not carried over)."""
        loop = np.arange(self.num_nodes, dtype=np.int32)
        g = Graph(np.concatenate([self.src, loop]),
                  np.concatenate([self.dst, loop]), self.num_nodes)
        g.ndata = dict(self.ndata)
        return g

    def to_device(self, device, sort_by_dst: bool = True,
                  pad_to: Optional[int] = None) -> "DeviceGraph":
        """The padded edge list on ``device`` that the full-graph layers
        read: edges sorted by destination (stable) when
        ``sort_by_dst``, then padded to ``pad_to`` edges; a padded edge
        runs from node 0 to the dummy node ``num_nodes`` and has
        ``edge_mask`` 0."""
        src, dst = self.src, self.dst
        if sort_by_dst:
            perm = np.argsort(dst, kind="stable")
            src, dst = src[perm], dst[perm]
        n_valid = src.shape[0]
        if pad_to is not None:
            if pad_to < n_valid:
                raise ValueError(f"pad_to={pad_to} < num_edges={n_valid}")
            pad = pad_to - n_valid
            src = np.concatenate([src, np.zeros(pad, np.int32)])
            dst = np.concatenate([dst, np.full(pad, self.num_nodes,
                                               np.int32)])
        mask = (np.arange(src.shape[0]) < n_valid).astype(np.float32)
        return DeviceGraph(
            src=torch.from_numpy(np.ascontiguousarray(src)).to(device),
            dst=torch.from_numpy(np.ascontiguousarray(dst)).to(device),
            edge_mask=torch.from_numpy(mask).to(device),
            num_nodes=self.num_nodes, sorted_by_dst=sort_by_dst)

    def add_reverse_edges(self) -> "Graph":
        g = Graph(np.concatenate([self.src, self.dst]),
                  np.concatenate([self.dst, self.src]), self.num_nodes)
        g.ndata = dict(self.ndata)
        return g


@dataclasses.dataclass
class DeviceGraph:
    """The static-shape edge list the full-graph layers read (the JAX
    package's ``DeviceGraph``), as tensors on one device: ``src`` and
    ``dst`` int32 ``[E]``, ``edge_mask`` float32 ``[E]`` (0 on a padded
    edge, whose ``dst`` is ``num_nodes``, so a segment reduction over
    ``num_nodes + 1`` segments drops it with the last row)."""

    src: torch.Tensor
    dst: torch.Tensor
    edge_mask: torch.Tensor
    num_nodes: int
    sorted_by_dst: bool = True

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])
