"""Sharded embedding tables: the parameter server's pull and push.

The counterpart of the JAX package's ``parallel/embedding.py``. The
reference keeps entity embeddings in a KVStore sharded by machine:
clients pull rows before scoring and push gradients back, and the server
applies row-sparse Adagrad. Here a table of ``num_rows`` rows is cut
into ``num_shards`` blocks (one a slot; slot ``s`` owns rows ``[s * rps,
(s + 1) * rps)``, padded to ``rps * num_shards``) and each row has one
owner, so a lookup is exact.

Two forms give one result:

- **in one process** every slot's block lives in one padded table on one
  device: a lookup is one ``gather_rows`` and a push one Adagrad update
  over every slot's gradient rows, concatenated in slot order;
- **in a ``torch.distributed`` group** of ``W`` processes each holds the
  ``num_shards / W`` consecutive blocks of its slots. A lookup is each
  owner's ``gather_rows`` of the rows asked of it and one
  ``all_to_all_single`` of rows; a push is one ``all_to_all_single`` of
  gradient rows to their owners, which sum them in slot order and update.

The JAX step all-gathers every slot's ids over the mesh. The port's KGE
trainers draw every slot's batch on every process's host instead
(``runtime/kge.py``), so each process builds its :class:`Route` from
all the requests with no exchange of ids, and only rows and gradients
cross processes. The owner sums the gradient rows of a target in slot
order, as the JAX package's tiled ``all_gather`` + ``segment_sum`` does,
so two ranks equal one process bit for bit.

Two more forms serve the ``dp x mp`` grid and device-drawn ids:

- **the dp-replica reduction** (JAX's
  ``sharded_push_adagrad(reduce_axis=)``): ``sparse_adagrad_`` of
  :func:`all_gather_rows` over the push plan of every slot's ids. On a
  grid the table is sharded over ``mp`` and replicated over ``dp``;
  each shard sums the gradient rows of every dp replica before its
  Adagrad row update, so every replica stays identical. In one process
  the replicas are one table and the sum is the push of every slot's
  rows. In a group whose processes each hold whole dp rows (every block
  of the table) the processes' gradient rows are gathered in slot order
  first, so every replica sums the same rows in the same order.
- **ids the host never sees** (:func:`device_lookup`,
  :func:`device_push_adagrad`), the KGE trainer's device negatives. A
  :class:`Route` cannot be built for them, so they take JAX's form:
  every process sees every process's fixed-size id list, keeps the rows
  it owns, and one exchange returns each process its rows; a push
  gathers every process's ids and gradient rows and each owner sums its
  rows over :func:`~dgl_operator_tpu_torch.ops.adagrad.device_push_plan`,
  built on the device. In one process each is one ``gather_rows`` and
  one push.

:func:`dense_lookup` and :func:`dense_push_adagrad` are the unsharded
forms, where id ``-1`` is a null row (zeros in a lookup, nothing in a
push).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dgl_operator_tpu_torch.ops.adagrad import (EPS, PushPlan,
                                                device_push_plan, push_plan,
                                                sparse_adagrad_)
from dgl_operator_tpu_torch.ops.gather import gather_rows
from dgl_operator_tpu_torch.ops.scatter import ship_int32
from dgl_operator_tpu_torch.parallel.collectives import host_gather_rows


@dataclasses.dataclass
class ShardedTableSpec:
    """Static metadata of one sharded table."""

    num_rows: int          # logical rows (un-padded)
    dim: int
    num_shards: int

    @property
    def rows_per_shard(self) -> int:
        return -(-self.num_rows // self.num_shards)

    @property
    def padded_rows(self) -> int:
        return self.rows_per_shard * self.num_shards


def pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """``a`` with zero rows appended up to ``rows`` rows, float32."""
    a = np.asarray(a, np.float32)
    out = np.zeros((rows,) + a.shape[1:], np.float32)
    out[:len(a)] = a
    return out


# ----------------------------------------------------------------------
# Unsharded reference forms
def dense_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with a zero row where an id is -1 (``gather_rows``
    takes only valid rows, so the null ones are read from row 0 and
    masked)."""
    rows = gather_rows(table, ids.clamp_min(0))
    return rows * (ids >= 0).to(rows.dtype)[:, None]


def dense_push_adagrad(table: torch.Tensor, state: torch.Tensor, ids,
                       grads: torch.Tensor, lr: float, eps: float = EPS):
    """Row-sparse Adagrad of ``grads`` ``[M, D]`` into the rows ``ids``
    (``[M]``, -1 adds nothing); returns the updated ``(table, state)``
    as new tensors."""
    ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else ids
    table, state = table.clone(), state.clone()
    sparse_adagrad_(table, state, grads, push_plan(ids), lr, eps)
    return table, state


# ----------------------------------------------------------------------
# Sharded forms
class Route:
    """How one process's requests meet their owners' rows, and how the
    owners' pushes are summed, built on the host by :func:`route`.

    world      the processes of the exchange (1: one process).
    serve      [n_serve] the local rows this process serves, requester
               by requester, each requester's requests in its order;
               also the targets of the gradient rows pushed to it.
    serve_counts [world] rows served to (and pushed from) each process.
    recv_counts  [world] rows received from (and pushed to) each owner.
    order      [n_req] this process's requests sorted by owner, stably
               (None in one process).
    unorder    [n_req] the inverse permutation (None in one process).
    push       ``push_plan(serve)``.
    """

    def __init__(self, world, serve, serve_counts, recv_counts, order,
                 unorder, push: PushPlan):
        self.world = world
        self.serve = serve
        self.serve_counts = serve_counts
        self.recv_counts = recv_counts
        self.order = order
        self.unorder = unorder
        self.push = push

    def arrays(self) -> List:
        perm = [] if self.world == 1 else [self.order, self.unorder]
        return [self.serve] + perm + self.push.arrays()

    def rebuilt(self, shipped: Sequence[torch.Tensor]) -> "Route":
        k = 1 if self.world == 1 else 3
        order, unorder = (None, None) if k == 1 else shipped[1:3]
        return Route(self.world, shipped[0], self.serve_counts,
                     self.recv_counts, order, unorder,
                     self.push.rebuilt(shipped[k:]))

    def to(self, device) -> "Route":
        return self.rebuilt(ship_int32(self.arrays(), device))


def route(requests: Sequence[np.ndarray], spec: ShardedTableSpec,
          rank: int) -> Route:
    """The :class:`Route` of process ``rank`` when process ``p`` asks for
    the rows ``requests[p]`` (global ids, in ``[0, num_rows)``) of a
    table whose ``spec.num_shards`` blocks are split evenly over the
    ``len(requests)`` processes in order."""
    W = len(requests)
    if spec.num_shards % W:
        raise ValueError(f"{spec.num_shards} shards do not split over "
                         f"{W} processes")
    block = spec.padded_rows // W
    reqs = [np.asarray(r, np.int64).reshape(-1) for r in requests]
    for r in reqs:
        if r.size and (r.min() < 0 or r.max() >= spec.num_rows):
            raise ValueError(f"a request names a row outside [0, "
                             f"{spec.num_rows})")
    if W == 1:
        return Route(1, reqs[0], [len(reqs[0])], [len(reqs[0])], None,
                     None, push_plan(reqs[0]))
    owners = [r // block for r in reqs]
    mine = [r[o == rank] - rank * block for r, o in zip(reqs, owners)]
    serve = np.concatenate(mine)
    order = np.argsort(owners[rank], kind="stable")
    unorder = np.empty_like(order)
    unorder[order] = np.arange(len(order))
    return Route(W, serve, [len(m) for m in mine],
                 np.bincount(owners[rank], minlength=W).tolist(), order,
                 unorder, push_plan(serve))


def _exchange(rows: torch.Tensor, send_counts, recv_counts) -> torch.Tensor:
    out = rows.new_empty((sum(recv_counts), rows.shape[1]))
    dist.all_to_all_single(out, rows, output_split_sizes=list(recv_counts),
                           input_split_sizes=list(send_counts))
    return out


def sharded_lookup(table: torch.Tensor, rt: Route) -> torch.Tensor:
    """This process's requested rows, in request order. ``table`` is its
    block of the table (the whole padded table in one process); ``rt``
    its :class:`Route` on the table's device. One ``gather_rows`` in one
    process; in a group the owner's ``gather_rows``, one
    ``all_to_all_single`` of rows and a ``gather_rows`` back into request
    order."""
    rows = gather_rows(table, rt.serve)
    if rt.world == 1:
        return rows
    return gather_rows(_exchange(rows, rt.serve_counts, rt.recv_counts),
                       rt.unorder)


def sharded_push_adagrad(table: torch.Tensor, state: torch.Tensor,
                         grads: torch.Tensor, rt: Route, lr: float,
                         eps: float = EPS) -> None:
    """Row-sparse Adagrad of this process's gradient rows ``grads`` (in
    request order) into their owners' blocks, in place. In a group the
    rows go to their owners in one ``all_to_all_single``; each owner sums
    a row's gradients in slot order (``rt.push``) and updates its
    block."""
    if rt.world > 1:
        grads = _exchange(gather_rows(grads, rt.order), rt.recv_counts,
                          rt.serve_counts)
    sparse_adagrad_(table, state, grads, rt.push, lr, eps)


def all_gather_rows(t: torch.Tensor, group: bool) -> torch.Tensor:
    """Every process's rows of ``t`` (the same shape on each) in rank
    order; ``t`` itself when ``group`` is False."""
    if not group:
        return t
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t.contiguous())
    return torch.cat(out)


def _owned(ids: torch.Tensor, spec: ShardedTableSpec, rank: int,
           world: int):
    """``(local row, owned by rank)`` of global ``ids`` under the blocks
    of ``world`` processes."""
    block = spec.padded_rows // world
    local = ids.long() - rank * block
    return local, (local >= 0) & (local < block)


def device_lookup(table: torch.Tensor, ids: torch.Tensor,
                  spec: ShardedTableSpec, rank: int, world: int
                  ) -> torch.Tensor:
    """The rows of ``ids`` (``[n]`` on the device, the same ``n`` on every
    process) from a table split in blocks over ``world`` processes, with
    no host sync: every process gathers every process's ids, reads the
    rows it owns (zeros elsewhere), one ``all_to_all_single`` sends each
    requester its rows from every owner, and each request takes its
    owner's. One process: one ``gather_rows``."""
    if world == 1:
        return gather_rows(table, ids)
    local, mine = _owned(all_gather_rows(ids, True), spec, rank, world)
    rows = gather_rows(table, torch.where(mine, local, 0))
    rows = torch.where(mine[:, None], rows, 0.0)
    recv = torch.empty_like(rows)
    dist.all_to_all_single(recv, rows)
    n = ids.numel()
    owner = ids.long() // (spec.padded_rows // world)
    return gather_rows(recv, owner * n + torch.arange(n, device=ids.device))


def device_push_adagrad(table: torch.Tensor, state: torch.Tensor,
                        ids: torch.Tensor, grads: torch.Tensor,
                        spec: ShardedTableSpec, rank: int, world: int,
                        lr: float, group: bool, eps: float = EPS) -> None:
    """Row-sparse Adagrad of gradient rows ``grads`` to ``ids`` (both on
    the device) into this process's rows, in place, over a plan built on
    the device: with ``group``, every process's ids and rows gathered in
    slot order first, and, where the table is split over ``world`` > 1
    processes, the rows another process owns left out."""
    all_ids = all_gather_rows(ids, group)
    if world > 1:
        local, mine = _owned(all_ids, spec, rank, world)
        all_ids = torch.where(mine, local, -1)
    sparse_adagrad_(table, state, all_gather_rows(grads, group),
                    device_push_plan(all_ids), lr, eps)


def gather_blocks(block: torch.Tensor) -> np.ndarray:
    """The whole padded table on the host from every process's block, in
    process order (a copy of ``block`` without a group)."""
    return host_gather_rows(block.detach().cpu().numpy().copy())


def my_block(full: np.ndarray, rank: int, world: int) -> np.ndarray:
    """Process ``rank``'s rows of the padded host table ``full``."""
    n = len(full) // world
    return full[rank * n:(rank + 1) * n]

