"""gsddmm — per-edge values from the features of each edge's two ends.

The counterpart of ``dgl_operator_tpu/ops/sddmm.py`` (DGL's
``apply_edges(fn.u_dot_v / u_add_v / ...)``: the link predictors'
scores). Both ends are gathered with ``gather_rows`` over the graph's
transpose plans (:func:`gather_src`, :func:`gather_dst`), so the
backward is the port's deterministic ``scatter_add_rows``; then the op
is elementwise (or a contraction) in plain torch.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from dgl_operator_tpu_torch.ops.gather import gather_edges

if TYPE_CHECKING:  # the graph module imports the ops package
    from dgl_operator_tpu_torch.graph.graph import DeviceGraph

_OPS = {
    "dot": lambda a, b: (a * b).sum(-1, keepdim=True),
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    # DGL's copy_lhs / copy_rhs: one end's rows per edge
    "copy_u": lambda a, b: a,
    "copy_v": lambda a, b: b,
}


def gather_src(g: DeviceGraph, feat: torch.Tensor) -> torch.Tensor:
    """``feat[g.src]``, ``[N, ...]`` to ``[E, ...]``; its backward sums
    over ``g.src_plan``."""
    return gather_edges(feat, g.src, g.src_plan)


def gather_dst(g: DeviceGraph, feat: torch.Tensor) -> torch.Tensor:
    """``feat[g.dst]``, ``[N, ...]`` to ``[E, ...]``; its backward sums
    over ``g.dst_plan``. A padded edge (``dst == num_nodes``) reads row
    ``num_nodes - 1`` and sends it no gradient, as the JAX package's
    clamped gather does: the table gets a detached copy of its last row
    as the spare row ``num_nodes``."""
    spare = torch.cat([feat, feat[-1:].detach()])
    return gather_edges(spare, g.dst, g.dst_plan)


def gsddmm(g: DeviceGraph, op: str, ufeat, vfeat=None) -> torch.Tensor:
    """Per-edge ``op(ufeat[src], vfeat[dst])``, ``[E, ...]`` (``dot``
    keeps a trailing axis of 1). The unused side of a copy op may be
    None and is never gathered."""
    if op not in _OPS:
        raise ValueError(f"unknown sddmm op {op}")
    a = gather_src(g, ufeat) if op != "copy_v" else None
    b = gather_dst(g, vfeat) if op != "copy_u" else None
    return _OPS[op](a, b)


def u_dot_v(g: DeviceGraph, u, v) -> torch.Tensor:
    return gsddmm(g, "dot", u, v)


def u_add_v(g: DeviceGraph, u, v) -> torch.Tensor:
    return gsddmm(g, "add", u, v)


def u_sub_v(g: DeviceGraph, u, v) -> torch.Tensor:
    return gsddmm(g, "sub", u, v)
