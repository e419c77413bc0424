"""Model FLOPs of a training step, from the configuration's widths and
the step's sampled blocks.

What is counted: the products on the rows each layer needs (2 FLOPs a
multiply-add), one add per valid slot element of an aggregation, and an
attention's arithmetic per valid slot and head (add, LeakyReLU, exp,
sum, divide: 5). Left out, as under one percent of a step: activations,
dropout, bias adds, the loss and the optimizer. Rows and slots that are
padding, or that no seed reaches, are not counted, and nothing is
recomputed. The backward takes the weights' gradients and, where a
layer's input needs one (every layer but the first, whose input is the
features), the input's. Where a layer is linear in its projected rows
the count takes the cheaper order, so it reads the same work whatever
order the program runs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def tree_counts(masks: Sequence[torch.Tensor], valid_seeds: int
                ) -> List[Dict[str, int]]:
    """Per block, outermost first, of tree-form blocks (``masks`` ``[n,
    F]`` bool, outermost first): ``dst`` (valid destination rows),
    ``edges`` (valid slots) and ``src`` (valid source rows: the
    destinations and the valid slots)."""
    out = []
    dst = int(valid_seeds)
    for mask in reversed(list(masks)):
        edges = int(mask.sum())
        out.append({"dst": dst, "edges": edges, "src": dst + edges})
        dst = dst + edges
    return out[::-1]


def sage_mean_layer(c: Dict[str, int], din: int, dout: int,
                    input_grad: bool) -> float:
    """Forward and backward FLOPs of ``W_self h_v + W_neigh mean(h_u)``
    (aggregating before the product, the cheaper order)."""
    nd, e = c["dst"], c["edges"]
    dense = 4 * nd * din * dout            # the two products
    fwd = dense + e * din
    bwd = dense                            # the two weight gradients
    if input_grad:
        bwd += dense + e * din             # h_dst's and the slots' rows
    return float(fwd + bwd)


def gat_layer(c: Dict[str, int], din: int, heads: int, width: int,
              input_grad: bool) -> float:
    """Forward and backward FLOPs of a GAT layer, in the cheaper of its
    two orders: project every source row and sum the projections, or
    sum the raw rows per head and project the sums (the source logits
    then ``x @ (W a_l)``)."""
    nd, ns, e = c["dst"], c["src"], c["edges"]
    hd = heads * width
    score = 5 * e * heads
    # project first: z = W x on every source row
    fwd_p = 2 * ns * din * hd + 2 * ns * hd + 2 * nd * hd + score \
        + 2 * e * hd
    bwd_p = 2 * ns * din * hd + 2 * e * hd + 2 * e * hd + score \
        + 4 * ns * hd + 4 * nd * hd
    if input_grad:
        bwd_p += 2 * ns * din * hd
    # aggregate first: z_v = sum_u alpha_vu x_u per head, then W z_v
    fwd_a = 2 * nd * din * hd + 2 * din * hd + 2 * ns * din * heads \
        + 2 * nd * hd + score + 2 * e * heads * din \
        + 2 * nd * heads * din * width
    bwd_a = 4 * nd * heads * din * width + 2 * e * heads * din + score \
        + 2 * ns * din * heads + 2 * din * hd + 4 * nd * hd \
        + 2 * nd * din * hd
    if input_grad:
        bwd_a += 2 * e * heads * din + 2 * ns * din * heads \
            + 2 * nd * din * hd
    return float(min(fwd_p + bwd_p, fwd_a + bwd_a))
