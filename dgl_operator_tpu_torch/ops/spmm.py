"""gspmm — full-graph message passing over the graph's in-edges.

The counterpart of ``dgl_operator_tpu/ops/spmm.py::gspmm`` for the ops
layer-wise inference needs: ``copy_u`` messages with a ``sum`` or
``mean`` reduce. The JAX version gathers an ``[E, D]`` message table
and segment-reduces it (XLA, no Pallas kernel); here the reduce is one
sparse-CSR product with the adjacency (``Graph.adjacency``, repeated edges
merged into counts), so no
``[E, D]`` table is ever built (6 GB at ogbn-products scale 0.1 and
D=256).
"""

from __future__ import annotations

import torch

from dgl_operator_tpu_torch.graph.graph import Graph

_REDUCE = ("sum", "mean")


def gspmm(g: Graph, op: str, reduce: str, ufeat: torch.Tensor
          ) -> torch.Tensor:
    """``out[v] = reduce_{(u, v) in E} ufeat[u]`` over every in-edge of
    ``v`` (a repeated edge counts each time); a node with no in-edge
    gets 0. ``ufeat`` is ``[num_nodes, D]`` float32; the product runs
    on ``ufeat``'s device."""
    if op != "copy_u":
        raise NotImplementedError(f"gspmm message op {op!r}: only "
                                  "'copy_u' is ported")
    if reduce not in _REDUCE:
        raise NotImplementedError(f"gspmm reduce {reduce!r}: only "
                                  f"{_REDUCE} are ported")
    if ufeat.dim() != 2 or ufeat.shape[0] != g.num_nodes:
        raise ValueError(f"ufeat must be [{g.num_nodes}, D], got "
                         f"{tuple(ufeat.shape)}")
    adj = g.adjacency(ufeat.device)
    out = adj @ ufeat.float()
    if reduce == "mean":
        ones = torch.ones(g.num_nodes, 1, device=ufeat.device)
        out = out / (adj @ ones).clamp_min(1.0)     # in-degree, repeats counted
    return out
