"""gspmm — full-graph message passing over the graph's in-edges.

The counterpart of ``dgl_operator_tpu/ops/spmm.py::gspmm``, in two
forms, chosen by the graph's type:

- over a ``DeviceGraph`` (training, and every op and reduce): the
  source rows are gathered with ``gather_rows`` over the graph's
  ``src_plan``, combined with the edge features, and segment-reduced
  into the destinations (``ops/segment.py``: the sum over the
  ``dst_plan`` by ``scatter_add_rows``; max and min by
  ``scatter_reduce_``). Differentiable, and the same bits on every run.
- over a host ``Graph`` (no-grad layer-wise inference, ``copy_u``
  only): no ``[E, D]`` message table is built (6 GB at ogbn-products
  scale 0.1 and D = 256). The sum and mean are one sparse-CSR product
  with the adjacency (``Graph.adjacency``, repeated edges merged into
  counts); the max and min run destination chunk by destination chunk
  over its rows, each chunk's gathered messages under
  ``CHUNK_ELEMS`` elements.
"""

from __future__ import annotations

import numpy as np
import torch

from dgl_operator_tpu_torch.graph import graph as graph_mod
from dgl_operator_tpu_torch.ops.gather import gather_rows
from dgl_operator_tpu_torch.ops.sddmm import gather_src
from dgl_operator_tpu_torch.ops.segment import (identity_of, segment_max,
                                                segment_mean, segment_min,
                                                segment_sum)

_BINARY = {
    "copy_u": lambda u, e: u,
    "copy_e": lambda u, e: e,
    "u_mul_e": lambda u, e: u * e,
    "u_add_e": lambda u, e: u + e,
    "u_sub_e": lambda u, e: u - e,
    "u_div_e": lambda u, e: u / e,
    "e_sub_u": lambda u, e: e - u,
    "e_div_u": lambda u, e: e / u,
}
_REDUCE = ("sum", "mean", "max", "min")
# elements of one destination chunk's gathered [C, D] messages in the
# host graph's max and min (256 MB of float32); a node with more
# in-edges than that is a chunk of its own
CHUNK_ELEMS = 1 << 26


def gspmm(g, op: str, reduce: str, ufeat=None, efeat=None
          ) -> torch.Tensor:
    """``out[v] = reduce_{(u, v) in E} op(ufeat[u], efeat[uv])``; a
    node with no in-edge gets 0.

    ``g`` a ``DeviceGraph``: ``ufeat`` ``[num_nodes, ...]``, ``efeat``
    ``[num_edges, ...]`` in the graph's (sorted, padded) edge order
    (``DeviceGraph.permute_edata``); a padded edge never wins a max or
    min; integer features keep their dtype (the identity of max and
    min is the type's extreme); returns ``[num_nodes, ...]``.

    ``g`` a host ``Graph``: ``copy_u`` with ``ufeat`` ``[num_nodes,
    D]`` float32 on the device the reduce runs on, no gradient."""
    if op not in _BINARY:
        raise ValueError(f"unknown message op {op}")
    if reduce not in _REDUCE:
        raise ValueError(f"unknown reduce {reduce}")
    if isinstance(g, graph_mod.Graph):
        return _host_gspmm(g, op, reduce, ufeat)
    n, nseg = g.num_nodes, g.num_nodes + 1
    u = gather_src(g, ufeat) if ufeat is not None else None
    msg = _BINARY[op](u, efeat)
    if reduce == "sum":
        return segment_sum(msg, g.dst, nseg, g.dst_plan)[:n]
    if reduce == "mean":
        return segment_mean(msg, g.dst, nseg, g.dst_plan)[:n]
    # mask padded edges to the reduce's identity so they never win, then
    # zero the empty segments by their real edge count (a message equal
    # to the identity survives)
    trail = (1,) * (msg.dim() - 1)
    valid = (g.edge_mask > 0).view((-1,) + trail)
    ident = identity_of(msg.dtype, "amax" if reduce == "max" else "amin")
    msg = torch.where(valid, msg, torch.full((), ident, dtype=msg.dtype,
                                             device=msg.device))
    fn = segment_max if reduce == "max" else segment_min
    out = fn(msg, g.dst, nseg)[:n]
    return torch.where((g.in_deg > 0).view((-1,) + trail), out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _host_gspmm(g, op: str, reduce: str, ufeat: torch.Tensor
                ) -> torch.Tensor:
    if op != "copy_u":
        raise NotImplementedError(
            f"gspmm {op!r} over a host Graph: only 'copy_u' runs there; "
            "pass Graph.to_device(...) for the other message ops")
    if ufeat is None or ufeat.dim() != 2 or ufeat.shape[0] != g.num_nodes:
        raise ValueError(f"ufeat must be [{g.num_nodes}, D], got "
                         f"{None if ufeat is None else tuple(ufeat.shape)}")
    adj = g.adjacency(ufeat.device)
    if reduce in ("max", "min"):
        return _csr_extreme(adj, ufeat.float().contiguous(), reduce)
    out = adj @ ufeat.float()
    if reduce == "mean":
        ones = torch.ones(g.num_nodes, 1, device=ufeat.device)
        out = out / (adj @ ones).clamp_min(1.0)     # in-degree, repeats counted
    return out


def _csr_extreme(adj: torch.Tensor, h: torch.Tensor, reduce: str
                 ) -> torch.Tensor:
    """The max (min) of ``h`` over each row's columns of the sparse-CSR
    adjacency (merged repeats do not change it), 0 for an empty row:
    rows in chunks whose gathered ``[C, D]`` messages (``gather_rows``)
    stay under ``CHUNK_ELEMS`` elements."""
    n, d = h.shape
    crow, col = adj.crow_indices(), adj.col_indices()
    ends = crow.cpu().numpy().astype(np.int64)
    step = max(1, CHUNK_ELEMS // max(d, 1))
    fn = segment_max if reduce == "max" else segment_min
    out = h.new_zeros(n, d)
    a = 0
    while a < n:
        b = int(np.searchsorted(ends, ends[a] + step, side="right")) - 1
        b = min(max(b, a + 1), n)
        deg = (crow[a + 1:b + 1] - crow[a:b]).long()
        rows = torch.repeat_interleave(
            torch.arange(b - a, device=h.device), deg)
        msg = gather_rows(h, col[ends[a]:ends[b]])
        red = fn(msg, rows, b - a)
        out[a:b] = torch.where((deg > 0).unsqueeze(1), red,
                               torch.zeros((), dtype=h.dtype,
                                           device=h.device))
        a = b
    return out
