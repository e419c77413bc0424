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
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from dgl_operator_tpu_torch.ops.scatter import (ScatterPlan, scatter_add_rows,
                                                scatter_plan, ship_int32)

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
    sqrt(state[u] + eps)``."""
    st = state[rows] + (acc * acc).mean(-1)
    state.index_put_((rows,), st)
    step = acc * (lr / torch.sqrt(st + eps))[:, None]
    # the rows are distinct: one add per row, table - step exactly
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

