"""Segment reductions over an edge array — the full-graph layers' reduce.

The counterpart of ``dgl_operator_tpu/ops/segment.py``. There they are
XLA's segment ops (no Pallas kernel). Here the sum runs on the port's
kernels over the transpose plan of the segment ids
(``DeviceGraph.dst_plan``): forward ``scatter_add_rows``, backward
``gather_rows`` of the cotangent. Each segment adds its entries in a
fixed order, so a sum gives the same bits on every run; on a CPU
tensor both take their plain versions (``index_add_`` in index order,
and indexing). The max and min are ``scatter_reduce_``, whose value
does not depend on the order. Every function takes ``num_segments``
explicitly; a padded edge points at segment ``num_segments - 1`` when
the caller allocates one spare row (``Graph.to_device``). Data of any
trailing shape is reduced as ``[E, -1]`` rows and shaped back.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from dgl_operator_tpu_torch.ops.gather import gather_edges, gather_rows
from dgl_operator_tpu_torch.ops.scatter import ScatterPlan, scatter_add_rows


class _SegmentSum(torch.autograd.Function):
    """Forward: ``scatter_add_rows`` of ``[E, D]`` rows over ``plan``
    into ``num_segments`` rows, cast back to the rows' dtype. Backward:
    ``gather_rows`` of the cotangent at the ids."""

    @staticmethod
    def forward(ctx, rows, ids, num_segments, plan):
        ctx.save_for_backward(ids)
        out = scatter_add_rows(rows, ids.view(-1, 1), None, num_segments,
                               mean=False, plan=plan)
        return out.to(rows.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return gather_rows(grad.contiguous(), ids), None, None, None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, plan: Optional[ScatterPlan] = None
                ) -> torch.Tensor:
    """``out[s] = sum of data[e]`` over the entries ``e`` with
    ``segment_ids[e] == s``; an empty segment gives 0.

    ``plan`` is ``scatter_plan(segment_ids[:, None], None,
    num_segments)``; a CUDA tensor needs it (the kernel raises without
    one). Integer data carries no gradient and is summed exactly by
    ``index_add_``."""
    shape = (num_segments,) + tuple(data.shape[1:])
    if not data.is_floating_point():
        return data.new_zeros(shape).index_add_(0, segment_ids.long(), data)
    rows = data.reshape(data.shape[0], -1).contiguous()
    return _SegmentSum.apply(rows, segment_ids, num_segments,
                             plan).view(shape)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, plan: Optional[ScatterPlan] = None
                 ) -> torch.Tensor:
    """:func:`segment_sum` over each segment's entry count (at least 1:
    the plan's offsets when one is given, else ``bincount``); integer
    data gives float32, as in the JAX package."""
    if plan is None:
        cnt = torch.bincount(segment_ids.long(), minlength=num_segments)
    else:
        off = plan.to(segment_ids.device).offsets
        cnt = off[1:] - off[:-1]
    cnt = cnt.clamp_min(1)
    s = segment_sum(data, segment_ids, num_segments, plan)
    return s / cnt.to(s.dtype if s.is_floating_point() else torch.float32
                      ).view((-1,) + (1,) * (data.dim() - 1))


def identity_of(dtype: torch.dtype, reduce: str):
    """The identity of ``amax`` / ``amin`` for ``dtype``: -inf / +inf,
    or the integer type's extremes."""
    if dtype.is_floating_point:
        return float("-inf") if reduce == "amax" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if reduce == "amax" else info.max


def _segment_extreme(data, segment_ids, num_segments, reduce):
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        identity_of(data.dtype, reduce))
    idx = segment_ids.long().view((-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce_(0, idx.expand_as(data), data, reduce,
                               include_self=True)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = max of data[e]`` over the segment's entries; an empty
    segment gives ``-inf`` (an integer type's least value), as
    ``jax.ops.segment_max``. Tied entries share the gradient evenly."""
    return _segment_extreme(data, segment_ids, num_segments, "amax")


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = min of data[e]``; an empty segment gives ``+inf`` (an
    integer type's greatest value), as ``jax.ops.segment_min``."""
    return _segment_extreme(data, segment_ids, num_segments, "amin")


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, plan: Optional[ScatterPlan] = None
                    ) -> torch.Tensor:
    """Softmax of ``scores`` over the entries of each segment (DGL's
    ``edge_softmax``), with the JAX package's semantics: a segment whose
    max is not finite (empty, or all ``-inf``) shifts by 0, and the
    denominator is clamped at 1e-16, so an all-``-inf`` segment gives 0,
    not NaN. The shift carries no gradient: the softmax does not depend
    on it. ``plan`` as :func:`segment_sum`'s: the sum of the
    exponentials and the backward of the denominator's gather run
    over it."""
    smax = segment_max(scores.detach(), segment_ids, num_segments)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    ex = torch.exp(scores - gather_edges(smax, segment_ids))
    denom = segment_sum(ex, segment_ids, num_segments, plan).clamp_min(1e-16)
    return ex / gather_edges(denom, segment_ids, plan)
