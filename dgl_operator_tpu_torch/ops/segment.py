"""Segment reductions over an edge array — the full-graph layers' reduce.

The counterpart of ``dgl_operator_tpu/ops/segment.py``. There they are
XLA's segment ops (no Pallas kernel); here they are plain torch:
``index_add_`` for the sum and ``scatter_reduce_`` for the max. Every
function takes ``num_segments`` explicitly; a padded edge points at
segment ``num_segments - 1`` when the caller allocates one spare row
(``Graph.to_device``).
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = sum of data[e]`` over the entries ``e`` with
    ``segment_ids[e] == s``; an empty segment gives 0."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = max of data[e]`` over the segment's entries; an empty
    segment gives ``-inf`` (``jax.ops.segment_max``'s identity)."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    idx = segment_ids.long().view((-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce_(0, idx.expand_as(data), data, "amax",
                               include_self=True)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax of ``scores`` over the entries of each segment (DGL's
    ``edge_softmax``), with the JAX package's semantics: a segment whose
    max is not finite (empty, or all ``-inf``) shifts by 0, and the
    denominator is clamped at 1e-16, so an all-``-inf`` segment gives 0,
    not NaN. The shift carries no gradient: the softmax does not depend
    on it."""
    ids = segment_ids.long()
    smax = segment_max(scores.detach(), ids, num_segments)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    ex = torch.exp(scores - smax[ids])
    denom = segment_sum(ex, ids, num_segments).clamp_min(1e-16)
    return ex / denom[ids]
