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
from dgl_operator_tpu_torch.ops.scatter import (ScatterPlan, scatter_plan,
                                                ship_ids_and_plans,
                                                ship_int32)


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

    def node_subgraph(self, nodes: np.ndarray,
                      relabel: bool = True) -> "Graph":
        """Induced subgraph on a node set (DGL ``g.subgraph``): every
        edge whose both endpoints are in ``nodes`` (ids, or a boolean
        mask of ``num_nodes``). With ``relabel`` the nodes compact to
        ``[0, len(nodes))`` in the given order, ndata rows follow, and
        ``ndata["orig_id"]`` / ``edata["orig_eid"]`` map back to this
        graph; without it the node ids stay (:meth:`edge_subgraph`)."""
        nodes = np.asarray(nodes)
        if nodes.dtype == bool:
            if nodes.shape != (self.num_nodes,):
                raise ValueError(
                    f"boolean node mask must have shape "
                    f"({self.num_nodes},), got {nodes.shape}")
            nodes = np.nonzero(nodes)[0]
        nodes = nodes.astype(np.int64)
        if nodes.size and (nodes.min() < 0
                           or nodes.max() >= self.num_nodes):
            raise ValueError("node ids out of range")
        if len(np.unique(nodes)) != len(nodes):
            raise ValueError("duplicate node ids in subgraph set")
        keep = np.zeros(self.num_nodes, dtype=bool)
        keep[nodes] = True
        eids = np.nonzero(keep[self.src] & keep[self.dst])[0]
        if not relabel:
            return self.edge_subgraph(eids, relabel=False)
        new_id = np.full(self.num_nodes, -1, dtype=np.int64)
        new_id[nodes] = np.arange(len(nodes), dtype=np.int64)
        g = Graph(new_id[self.src[eids]].astype(np.int32),
                  new_id[self.dst[eids]].astype(np.int32), len(nodes))
        g.ndata = {k: v[nodes] for k, v in self.ndata.items()}
        g.ndata["orig_id"] = nodes
        g.edata = {k: v[eids] for k, v in self.edata.items()}
        g.edata["orig_eid"] = eids
        return g

    def edge_subgraph(self, eids: np.ndarray,
                      relabel: bool = False) -> "Graph":
        """The subgraph of the edges ``eids``, with ``edata["orig_eid"]``.
        Without ``relabel`` it keeps every node and shares ndata; with
        it the endpoints compact in id order and ``ndata["orig_id"]``
        maps back."""
        eids = np.asarray(eids, dtype=np.int64)
        src, dst = self.src[eids], self.dst[eids]
        if not relabel:
            g = Graph(src, dst, self.num_nodes)
            g.ndata = dict(self.ndata)
        else:
            uniq, inv = np.unique(np.concatenate([src, dst]),
                                  return_inverse=True)
            g = Graph(inv[: len(src)].astype(np.int32),
                      inv[len(src):].astype(np.int32), len(uniq))
            g.ndata = {k: v[uniq] for k, v in self.ndata.items()}
            g.ndata["orig_id"] = uniq.astype(np.int64)
        g.edata = {k: v[eids] for k, v in self.edata.items()}
        g.edata["orig_eid"] = eids
        return g

    def to_device(self, device, sort_by_dst: bool = True,
                  pad_to: Optional[int] = None) -> "DeviceGraph":
        """The padded edge list on ``device`` that the full-graph layers
        read: edges sorted by destination (stable) when
        ``sort_by_dst``, then padded to ``pad_to`` edges; a padded edge
        runs from node 0 to the dummy node ``num_nodes`` and has
        ``edge_mask`` 0. The two transpose plans (:class:`DeviceGraph`)
        and the degrees are built here on the host, once per graph, and
        shipped with the edge list in one copy."""
        src, dst = self.src, self.dst
        perm = None
        if sort_by_dst:
            perm = np.argsort(dst, kind="stable")
            src, dst = src[perm], dst[perm]
        n_valid = src.shape[0]
        n = self.num_nodes
        if pad_to is not None:
            if pad_to < n_valid:
                raise ValueError(f"pad_to={pad_to} < num_edges={n_valid}")
            pad = pad_to - n_valid
            src = np.concatenate([src, np.zeros(pad, np.int32)])
            dst = np.concatenate([dst, np.full(pad, n, np.int32)])
        # every edge, padded ones included, enters both plans, so each
        # transpose is exact for any cotangent: a padded edge's gradient
        # lands on row 0 (src) or on the spare segment n (dst), as the
        # JAX package's gathers and segment sums put it
        src_plan = scatter_plan(src[:, None], None, n)
        dst_plan = scatter_plan(dst[:, None], None, n + 1)
        fields = ScatterPlan.FIELDS
        shipped = ship_int32(
            [src, dst, np.bincount(dst[:n_valid], minlength=n),
             np.bincount(src[:n_valid], minlength=n)]
            + [getattr(src_plan, k) for k in fields]
            + [getattr(dst_plan, k) for k in fields], device)
        k = len(fields)
        mask = torch.arange(src.shape[0], device=shipped[0].device) < n_valid
        return DeviceGraph(
            src=shipped[0], dst=shipped[1], edge_mask=mask.float(),
            num_nodes=n, sorted_by_dst=sort_by_dst,
            in_deg=shipped[2], out_deg=shipped[3],
            src_plan=ScatterPlan(*shipped[4:4 + k]),
            dst_plan=ScatterPlan(*shipped[4 + k:]), edge_perm=perm)

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
    ``num_nodes + 1`` segments drops it with the last row).

    ``src_plan`` is the transpose of ``src`` into ``num_nodes`` rows:
    the backward of every source gather (``ops/sddmm.py::gather_src``).
    ``dst_plan`` is the transpose of ``dst`` into ``num_nodes + 1``
    segments: the segment sum's forward (``ops/segment.py``) and the
    backward of every destination gather. Both hold every edge.
    ``in_deg`` / ``out_deg`` are the int32 ``[num_nodes]`` counts of
    valid in- and out-edges. ``edge_perm`` (host numpy, or None when
    unsorted) is the sort that :meth:`permute_edata` applies to a host
    edge-feature array."""

    src: torch.Tensor
    dst: torch.Tensor
    edge_mask: torch.Tensor
    num_nodes: int
    in_deg: torch.Tensor
    out_deg: torch.Tensor
    src_plan: ScatterPlan
    dst_plan: ScatterPlan
    sorted_by_dst: bool = True
    edge_perm: Optional[np.ndarray] = None

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def permute_edata(self, x: np.ndarray) -> np.ndarray:
        """A host edge-feature array in the sorted edge order."""
        return x if self.edge_perm is None else x[self.edge_perm]

    def edge_types(self, etype: np.ndarray, num_types: int) -> "EdgeTypes":
        """The :class:`EdgeTypes` of a host array of one type per edge in
        the graph's input order (:meth:`permute_edata` sorts it; a padded
        edge takes type 0), its plan built here once."""
        ids = np.asarray(self.permute_edata(np.asarray(etype)), np.int64)
        if ids.ndim != 1 or ids.shape[0] > self.num_edges:
            raise ValueError(f"etype must be [E] for a graph of "
                             f"{self.num_edges} edges, got {ids.shape}")
        ids = np.concatenate(
            [ids, np.zeros(self.num_edges - ids.shape[0], np.int64)])
        return EdgeTypes(ids, num_types, self.src.device)


class EdgeTypes:
    """One type per edge of a ``DeviceGraph``, in its edge order, and the
    transposes that gathers of per-type rows need for their backward:
    ``ids`` int32 ``[E]`` on the graph's device, ``plan`` the
    ``scatter_plan`` of every id into ``num_types`` rows (built once on
    the host), and :meth:`chunks`, the same per run of edges."""

    def __init__(self, ids: np.ndarray, num_types: int, device):
        if ids.size and (ids.min() < 0 or ids.max() >= num_types):
            raise ValueError(f"edge types must lie in [0, {num_types})")
        self.host = ids.astype(np.int32)
        self.num_types = int(num_types)
        self.device = torch.device(device)
        (self.ids,), (self.plan,) = ship_ids_and_plans(
            [self.host], [self.num_types], self.device)
        self._chunks: Dict[int, list] = {}

    def chunks(self, step: int) -> list:
        """``(begin, end, ids, plan)`` for each run of ``step`` edges
        (the last one shorter), each with the plan of its own ids; built
        once per step."""
        if step not in self._chunks:
            out = []
            for a in range(0, self.host.shape[0], step):
                part = self.host[a:a + step]
                (ids,), (plan,) = ship_ids_and_plans(
                    [part], [self.num_types], self.device)
                out.append((a, a + part.shape[0], ids, plan))
            self._chunks[step] = out
        return self._chunks[step]
