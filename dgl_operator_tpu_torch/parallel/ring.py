"""Ring-collective sharded-embedding access (the memory-lean pull and
push).

The counterpart of the JAX package's ``parallel/ring.py``: the same
semantics as ``parallel/embedding.py``'s ``sharded_lookup`` and
``sharded_push_adagrad`` (the KVStore pull, and push with the server's
row-sparse Adagrad), as a ring program. Each shard's ``[B, D]`` buffer
travels the ring once and every shard adds the rows it owns as it
passes, so a shard holds one ``[B, D]`` buffer at a time instead of the
``[nshard * B, D]`` request image of the dense form.

A table of ``spec.num_shards`` blocks is laid out as in
``parallel/embedding.py``: shard ``m`` owns rows ``[m * rps, (m + 1) *
rps)`` of the padded table, one shard a slot. In one process every
shard is here and a hop rotates the list of the shards' buffers; in a
``torch.distributed`` group of ``W`` processes each holds ``num_shards
/ W`` consecutive shards and a hop sends its last shard's buffer to the
next rank and receives the previous rank's
(``batch_isend_irecv``; through the host under gloo). Every process knows every slot's ids (the
port's KGE trainers draw every slot's batch on every host), so only
rows and gradients ride the ring.

- :func:`ring_lookup`: at hop ``t`` shard ``m`` holds the partly filled
  answer of slot ``(m - 1 - t) mod n`` and adds its own rows of that
  slot's ids (``gather_rows``); after ``n - 1`` hops each answer is at
  its slot. Each row has one owner, so the answer is the dense lookup's
  bit for bit.
- :func:`ring_push_adagrad`: each slot's gradient rows travel the ring;
  every shard folds the rows it owns into a ``[rps, D]`` accumulator
  (``scatter_add_rows`` over a plan built on the host), then updates the
  touched rows with Adagrad. The sums run in ring order, not slot
  order, so the tables agree with the dense push to float rounding.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from dgl_operator_tpu_torch.obs.comm import register_collective
from dgl_operator_tpu_torch.ops.adagrad import EPS
from dgl_operator_tpu_torch.ops.gather import gather_rows
from dgl_operator_tpu_torch.ops.scatter import scatter_add_rows, scatter_plan
from dgl_operator_tpu_torch.parallel.collectives import send_recv
from dgl_operator_tpu_torch.parallel.embedding import ShardedTableSpec
from dgl_operator_tpu_torch.parallel.mesh import DP_AXIS


def ring_shift(bufs: List[torch.Tensor], rank: int = 0, world: int = 1
               ) -> List[torch.Tensor]:
    """One hop of the ring over the shards' buffers ``bufs`` (this
    process's, in shard order): every buffer moves to the next shard. In
    one process a rotation of the list; in a group the last buffer goes
    to rank ``rank + 1`` and the previous rank's arrives first
    (``parallel/collectives.py::send_recv``)."""
    if world == 1:
        return bufs[-1:] + bufs[:-1]
    return [send_recv(bufs[-1], rank, world)] + bufs[:-1]


def _all_ids(ids, device) -> torch.Tensor:
    ids = torch.as_tensor(np.asarray(ids) if not isinstance(
        ids, torch.Tensor) else ids)
    return ids.to(device=device, dtype=torch.int64)


def _local_shards(spec: ShardedTableSpec, rank: int, world: int
                  ) -> List[int]:
    if spec.num_shards % world:
        raise ValueError(f"{spec.num_shards} shards do not split over "
                         f"{world} processes")
    L = spec.num_shards // world
    return [rank * L + i for i in range(L)]


def ring_lookup(table: torch.Tensor, ids, spec: ShardedTableSpec,
                rank: int = 0, world: int = 1,
                axis: str = DP_AXIS) -> torch.Tensor:
    """``[L, B, D]``: the rows of this process's ``L`` slots' ids over a
    ring. ``table`` is this process's shards (the whole padded table in
    one process); ``ids`` ``[n, B]`` every slot's global ids (``-1`` a
    zero row), on the host or the device. Registers ``ring_lookup`` on
    ``axis`` with the comm ledger (the JAX bill: the ids and ``n - 1``
    hops of a ``[B, D]`` buffer)."""
    n, rps = spec.num_shards, spec.rows_per_shard
    mine_shards = _local_shards(spec, rank, world)
    all_ids = _all_ids(ids, table.device)
    B = all_ids.shape[1]
    register_collective("ring_lookup", axis,
                        n * B * 4 + (n - 1) * B * table.shape[-1]
                        * table.element_size())

    def contribution(i: int, slot: int) -> torch.Tensor:
        req = all_ids[slot]
        local = req - mine_shards[i] * rps
        mine = (req >= 0) & (local >= 0) & (local < rps)
        rows = gather_rows(table[i * rps:(i + 1) * rps],
                           torch.where(mine, local, 0))
        return torch.where(mine[:, None], rows, rows.new_zeros(()))

    acc = [contribution(i, (m - 1) % n) for i, m in enumerate(mine_shards)]
    for t in range(1, n):
        acc = ring_shift(acc, rank, world)
        acc = [a + contribution(i, (m - 1 - t) % n)
               for i, (a, m) in enumerate(zip(acc, mine_shards))]
    return torch.stack(acc)


def _fold_plans(ids: np.ndarray, spec: ShardedTableSpec,
                shards: Sequence[int], device):
    """Per local shard and slot the accumulate's ``(idx, mask, plan)``
    (on ``device``) of that slot's ids into the shard's rows, and per
    local shard its touched rows (``[L * rps]`` bool)."""
    rps = spec.rows_per_shard
    plans = {}
    touched = np.zeros(len(shards) * rps, bool)
    for i, m in enumerate(shards):
        for slot in range(ids.shape[0]):
            req = ids[slot].astype(np.int64)
            local = req - m * rps
            mine = (req >= 0) & (local >= 0) & (local < rps)
            idx = np.where(mine, local, 0).astype(np.int32)[:, None]
            mask = mine.astype(np.uint8)[:, None]
            touched[i * rps + local[mine]] = True
            plans[i, slot] = (torch.from_numpy(idx).to(device),
                              torch.from_numpy(mask).to(device),
                              scatter_plan(idx, mask, rps).to(device))
    return plans, torch.from_numpy(touched).to(device)


@torch.no_grad()
def ring_push_adagrad(table: torch.Tensor, state: torch.Tensor, ids,
                      grads: torch.Tensor, spec: ShardedTableSpec,
                      lr: float, eps: float = EPS, rank: int = 0,
                      world: int = 1, axis: str = DP_AXIS) -> None:
    """Row-sparse Adagrad of this process's slots' gradient rows
    ``grads`` ``[L, B, D]`` into their owners' shards, in place, over a
    ring: each slot's rows travel the ring once and every shard folds the
    rows it owns into its accumulator as they pass (``scatter_add_rows``
    over plans built on the host from ``ids``, ``[n, B]`` every slot's
    global ids, ``-1`` adding nothing); then each touched row takes
    ``state += mean(acc^2)``, ``row -= lr * acc / sqrt(state + eps)``.
    Registers ``ring_push`` on ``axis`` with the comm ledger."""
    n, rps = spec.num_shards, spec.rows_per_shard
    shards = _local_shards(spec, rank, world)
    ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids)
    B, D = grads.shape[1], grads.shape[2]
    register_collective("ring_push", axis,
                        (n - 1) * (B * 4 + B * D * grads.element_size()))
    plans, touched = _fold_plans(ids, spec, shards, table.device)
    acc = [table.new_zeros(rps, D, dtype=torch.float32) for _ in shards]

    def fold(pairs: List[torch.Tensor], t: int) -> None:
        for i, m in enumerate(shards):
            idx, mask, plan = plans[i, (m - t) % n]
            acc[i] += scatter_add_rows(pairs[i].contiguous(), idx, mask,
                                       rps, mean=False, plan=plan)

    pairs = list(grads)
    fold(pairs, 0)
    for t in range(1, n):
        pairs = ring_shift(pairs, rank, world)
        fold(pairs, t)
    acc = torch.cat(acc)
    gsum = (acc * acc).mean(-1)
    state += torch.where(touched, gsum, gsum.new_zeros(()))
    step = acc * (lr / torch.sqrt(state + eps))[:, None]
    table -= torch.where(touched[:, None], step, step.new_zeros(()))


class RingEmbeddingOps(NamedTuple):
    """The ring forms bound to one table's spec and this process's place:
    ``lookup(table, ids)`` and ``push(table, state, ids, grads, lr)``."""

    lookup: object
    push: object


def make_ring_embedding_ops(spec: ShardedTableSpec, rank: int = 0,
                            world: int = 1, axis: str = DP_AXIS
                            ) -> RingEmbeddingOps:
    """:func:`ring_lookup` and :func:`ring_push_adagrad` bound to
    ``spec`` and ``(rank, world)``."""
    def lookup(table, ids):
        return ring_lookup(table, ids, spec, rank, world, axis)

    def push(table, state, ids, grads, lr, eps=EPS):
        ring_push_adagrad(table, state, ids, grads, spec, lr, eps, rank,
                          world, axis)

    return RingEmbeddingOps(lookup, push)
