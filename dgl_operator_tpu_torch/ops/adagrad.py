"""Row-sparse Adagrad — the push of the KGE trainers.

The counterpart of the JAX package's ``runtime/kge.py::
_sparse_adagrad_update`` and of the owner half of ``parallel/
embedding.py::sharded_push_adagrad``, the reference's server-side
update (``examples/DGL-KE/hotfix/kvserver.py:41-57``): gradient rows of
duplicate ids accumulate, then for every touched row
``state[row] += mean(acc^2)`` and ``row -= lr * acc / sqrt(state + eps)``.

The JAX update is dense over all rows. This one touches only the ``U``
distinct rows of a push. The host builds a :class:`PushPlan` next to the
sampler: the push's unique ids, each entry's index among them and the
transpose of that index (``ops/scatter.py::scatter_plan``). On the
device ``scatter_add_rows`` sums each unique row's gradients in a fixed
order into ``[U, D]`` (on a card, the hand-written kernel), and plain
torch ops update those ``U`` rows of the table and of the state through
the unique ids, so the update is deterministic and every other row
keeps its bits. Id ``-1`` is a null entry that adds nothing.

Where the ids are drawn on the device (the KGE trainer's device
negatives), :func:`device_push_plan` builds the same plan there, with
static shapes and no host sync: a stable sort stands in for the host's
``argsort``, the targets are the sorted run of distinct ids padded to
``M + 1`` (the last always empty), and the long-target pieces are padded
to their most. A padding target's row is 0 and its sum exact zeros, so
:func:`adagrad_rows_` adds nothing to it.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from dgl_operator_tpu_torch.ops.scatter import (CHUNK, ScatterPlan,
                                                scatter_add_rows, scatter_plan,
                                                ship_int32)

EPS = 1e-10


class PushPlan:
    """One push of ``M`` gradient rows into a table, built on the host by
    :func:`push_plan`.

    rows     [U]     the distinct target rows, ascending.
    inverse  [M, 1]  each entry's index into ``rows`` (0 for a null one).
    mask     [M, 1]  uint8, 0 on null entries; None when there is none.
    scatter  ``scatter_plan(inverse, mask, U)``.

    Numpy on the host, int32 tensors (the mask uint8) after :meth:`to`.
    """

    def __init__(self, rows, inverse, mask, scatter: ScatterPlan):
        self.rows = rows
        self.inverse = inverse
        self.mask = mask
        self.scatter = scatter

    @property
    def num_rows(self) -> int:
        return int(self.rows.shape[0])

    def arrays(self) -> List:
        """The integer arrays to ship (the mask goes apart)."""
        return [self.rows, self.inverse] + [
            getattr(self.scatter, k) for k in ScatterPlan.FIELDS]

    def rebuilt(self, shipped: Sequence[torch.Tensor]) -> "PushPlan":
        """The plan from :meth:`arrays` as shipped by :func:`ship_int32`."""
        mask = None
        if self.mask is not None:
            mask = torch.from_numpy(self.mask).to(shipped[0].device)
        return PushPlan(shipped[0], shipped[1], mask,
                        ScatterPlan(*shipped[2:]))

    def to(self, device) -> "PushPlan":
        return self.rebuilt(ship_int32(self.arrays(), device))


def push_plan(ids) -> PushPlan:
    """The plan of a push of gradient rows to ``ids`` (``[M]``, ``-1`` a
    null entry)."""
    ids = np.asarray(ids).reshape(-1)
    valid = ids >= 0
    rows, inv = np.unique(ids[valid], return_inverse=True)
    inverse = np.zeros((len(ids), 1), np.int32)
    inverse[valid, 0] = inv
    mask = None if valid.all() else valid.astype(np.uint8)[:, None]
    return PushPlan(rows.astype(np.int64), inverse, mask,
                    scatter_plan(inverse, mask, len(rows)))


def device_push_plan(ids: torch.Tensor) -> PushPlan:
    """:func:`push_plan` of ``ids`` (``[M]`` int32 or int64 on any device,
    ``-1`` a null entry) built on their device from tensors alone: no
    host sync, and every shape fixed by ``M``.

    Targets are the distinct ids in ascending order, then empty ones up
    to ``M + 1``; target ``u``'s entries are its ids' positions in entry
    order (a stable sort), so a target's sum adds what the host plan's
    adds in the same order. ``rows`` is 0 for an empty target, whose sum
    is zero. The long targets (more than ``CHUNK`` entries) are listed
    first and padded with the last target (always empty) to ``M // (CHUNK
    + 1)``, and their pieces padded with empty ones to the most they can
    need, so the kernel's grid does not depend on the ids."""
    dev = ids.device
    i32 = torch.int32
    ids = ids.reshape(-1).long()
    m = ids.numel()
    r = m + 1
    valid = ids >= 0
    key = torch.where(valid, ids, torch.iinfo(torch.int64).max)
    sorted_ids, order = torch.sort(key, stable=True)
    head = torch.ones(m, dtype=torch.bool, device=dev)
    head[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(head, 0) - 1
    # the null entries sort last and fall outside every target
    offsets = torch.minimum(
        torch.searchsorted(seg, torch.arange(r + 1, device=dev)),
        valid.sum())
    lens = offsets[1:] - offsets[:-1]
    rows = torch.where(lens > 0, sorted_ids[offsets[:-1].clamp(max=m - 1)],
                       0)
    inverse = torch.where(valid, torch.empty_like(seg).scatter_(
        0, order, seg), r - 1)
    cap_long = m // (CHUNK + 1)
    is_long = lens > CHUNK
    dest = torch.where(is_long, torch.cumsum(is_long, 0) - 1, cap_long)
    long_rows = torch.full((cap_long + 1,), r - 1, dtype=torch.int64,
                           device=dev).scatter_(
        0, dest, torch.arange(r, device=dev))[:cap_long]
    pieces = (lens[long_rows] + CHUNK - 1) // CHUNK
    long_part = torch.cat([pieces.new_zeros(1), torch.cumsum(pieces, 0)])
    cap_chunks = (m + (CHUNK - 1) * cap_long) // CHUNK
    w = torch.arange(cap_chunks, device=dev)
    q = torch.searchsorted(long_part[1:], w, right=True).clamp(
        max=max(cap_long - 1, 0))
    if cap_long:
        tgt = long_rows[q]
        begin = offsets[tgt] + CHUNK * (w - long_part[q])
        end = torch.minimum(begin + CHUNK, offsets[tgt + 1])
        real = w < long_part[-1]
        chunks = torch.stack([torch.where(real, begin, 0),
                              torch.where(real, end, 0)], 1)
    else:
        chunks = torch.zeros((0, 2), dtype=torch.int64, device=dev)
    plan = ScatterPlan(offsets.to(i32), order.to(i32), valid.to(i32),
                       chunks.to(i32).contiguous(), long_rows.to(i32),
                       long_part.to(i32))
    return PushPlan(rows, inverse.to(i32)[:, None],
                    valid.to(torch.uint8)[:, None], plan)


def accumulate(grads: torch.Tensor, plan: PushPlan) -> torch.Tensor:
    """``[U, D]`` float32: each distinct row's gradient rows summed in
    entry order (``scatter_add_rows`` over the plan)."""
    return scatter_add_rows(grads, plan.inverse, plan.mask, plan.num_rows,
                            mean=False, plan=plan.scatter)


@torch.no_grad()
def adagrad_rows_(table: torch.Tensor, state: torch.Tensor,
                  rows: torch.Tensor, acc: torch.Tensor, lr: float,
                  eps: float = EPS) -> None:
    """Adagrad on the distinct ``rows`` of ``table`` and ``state`` in
    place, ``acc`` ``[U, D]`` their accumulated gradients:
    ``state[u] += mean(acc^2)``, ``table[u] -= lr * acc /
    sqrt(state[u] + eps)``. A row may repeat where its other entries'
    ``acc`` is exact zeros (a device plan's empty targets): those adds
    leave its bits as they are."""
    state.index_add_(0, rows, (acc * acc).mean(-1))
    st = state[rows]
    step = acc * (lr / torch.sqrt(st + eps))[:, None]
    # one non-zero add per row: table - step exactly
    table.index_add_(0, rows, step, alpha=-1)


def sparse_adagrad_(table: torch.Tensor, state: torch.Tensor,
                    grads: torch.Tensor, plan: PushPlan, lr: float,
                    eps: float = EPS) -> None:
    """Push ``grads`` ``[M, D]`` into ``table`` ``[N, D]`` and its Adagrad
    sums ``state`` ``[N]`` in place, over ``plan`` (``push_plan`` of the
    rows' ids, on the host or on the table's device)."""
    if not isinstance(plan.rows, torch.Tensor):
        plan = plan.to(table.device)
    adagrad_rows_(table, state, plan.rows, accumulate(grads, plan), lr, eps)

