"""Owner-sharded halo features: the degree-ranked hot-halo cache and
the exchange of halo rows between slots.

Each partition stores its core feature rows once; a halo row is read
from the part that owns it, unless it is among the hottest halo rows
that every part keeps resident. Rows cross between slots in one of two
functions: :func:`alltoall_serve_rows` when every slot lives in one
process (one row gather), :func:`alltoall_request_rows` across the
processes of a ``torch.distributed`` group (the requests out and the
rows back by ``all_to_all_single``, one row gather in between). Rows
move in the store's own dtype: a bfloat16 store sends bfloat16, a store
of int8 or uint8 codes sends the raw codes (the receive buffers are made
in that dtype), and the receiver reconstructs them with the global
sidecar (``runtime/forward.py::dequant_rows``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from dgl_operator_tpu_torch.obs.comm import register_collective
from dgl_operator_tpu_torch.ops.gather import gather_rows
from dgl_operator_tpu_torch.parallel.mesh import DP_AXIS

# default fraction of a partition's halo rows kept resident as the hot
# cache: sampling draws a halo node with probability proportional to
# its local edge count, so a small degree-ranked cache absorbs an
# outsized share of halo reads
DEFAULT_HALO_CACHE_FRAC = 0.25


def build_halo_cache(src: np.ndarray, num_nodes: int, num_inner: int,
                     cache_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Degree-ranked hot-halo cache selection for ONE partition
    (hotness = local edge count).

    src       : [num_edges] local src endpoint of every local edge.
    num_nodes : local node count ([core | halo] ordering).
    num_inner : core prefix length; halo rows follow.
    cache_rows: slots to fill.

    Returns ``(cache_idx, slot_of)``: ``cache_idx`` [cache_rows]
    halo-local rows to store, hottest first (a halo shorter than the
    cache repeats its hottest row); ``slot_of`` [num_halo] halo-local
    row -> cache slot, -1 = not cached (on duplicates the first slot
    wins).
    """
    nh = int(num_nodes) - int(num_inner)
    slot_of = np.full(max(nh, 0), -1, np.int32)
    if cache_rows <= 0 or nh <= 0:
        return np.zeros(0, np.int64), slot_of
    deg = np.bincount(np.asarray(src), minlength=num_nodes)[num_inner:]
    idx = np.argsort(-deg, kind="stable")[:cache_rows]
    if len(idx) < cache_rows:   # short halo: repeat hottest row
        idx = np.concatenate(
            [idx, np.repeat(idx[:1], cache_rows - len(idx))])
    slot_of[idx[::-1]] = np.arange(cache_rows - 1, -1, -1)
    return idx.astype(np.int64), slot_of


def alltoall_serve_rows(store: torch.Tensor, serve: torch.Tensor,
                        rows_per_slot: int) -> torch.Tensor:
    """The compacted halo exchange of one step, every slot on one
    device: ``recv[r, o, j] = store[o, serve[o, r, j]]``, a zero row
    where ``serve[o, r, j]`` is -1.

    store : ``[P * rows_per_slot + 1, D]`` every slot's store, slot-major,
            then one zero row.
    serve : ``[P, P, pair_cap]`` integer; ``serve[o, r]`` are the rows of
            owner ``o`` that requester ``r`` asked for, in its request
            order (the transposed request tables).

    Returns ``recv`` ``[P, P, pair_cap, D]`` from one ``gather_rows``
    launch over the flattened store."""
    P, P2, cap = serve.shape
    if P2 != P or store.shape[0] != P * rows_per_slot + 1:
        raise ValueError(f"serve must be [P, P, cap] over a store of "
                         f"P * {rows_per_slot} + 1 rows; got serve "
                         f"{tuple(serve.shape)}, store "
                         f"{tuple(store.shape)}")
    # every slot's answer to every requester: the process's bytes
    register_collective("halo_a2a_serve", DP_AXIS,
                        P * P * cap * store.shape[1] * store.element_size())
    recv = gather_rows(store, exchange_index(serve, rows_per_slot))
    return recv.view(P, P, cap, store.shape[1])


def exchange_index(serve: torch.Tensor, rows_per_slot: int) -> torch.Tensor:
    """The flat store row of every ``recv[r, o, j]`` of
    :func:`alltoall_serve_rows`, flattened in ``recv``'s order:
    ``o * rows_per_slot + serve[o, r, j]``, or the zero row after every
    slot's rows where the request is -1."""
    P = serve.shape[0]
    base = torch.arange(P, device=serve.device,
                        dtype=torch.int64).view(P, 1, 1) * rows_per_slot
    idx = torch.where(serve >= 0, serve.long() + base, P * rows_per_slot)
    return idx.transpose(0, 1).reshape(-1)


def alltoall_request_rows(store: torch.Tensor, req: torch.Tensor,
                          rows_per_slot: int) -> torch.Tensor:
    """The compacted halo exchange of one step across the ``W`` processes
    of the group, each holding ``L`` consecutive slots of ``P = W * L``.

    store : ``[L * rows_per_slot + 1, D]`` this process's slots' stores,
            slot-major, then one zero row.
    req   : ``[L, P, pair_cap]`` integer; ``req[a, o]`` are the rows that
            local slot ``a`` asks of part ``o`` (owner-local, -1 pads).

    A first ``all_to_all_single`` ships each request list to the process
    of its owner, which answers every list it received with ONE
    ``gather_rows`` launch over its store; a second returns the rows.
    Returns ``recv`` ``[L, P, pair_cap, D]``: ``recv[a, o, j]`` is row
    ``req[a, o, j]`` of part ``o``, a zero row where it is -1 — what
    :func:`alltoall_serve_rows` gives the same slots in one process.
    :func:`request_rows_start` and :func:`request_rows_finish` are its
    two halves, the first collective in flight between them."""
    return request_rows_finish(request_rows_start(store, req,
                                                  rows_per_slot))


def request_rows_start(store: torch.Tensor, req: torch.Tensor,
                       rows_per_slot: int, async_op: bool = False):
    """The first half of :func:`alltoall_request_rows`: the request
    ``all_to_all_single``, with ``async_op`` left in flight. Returns the
    handle :func:`request_rows_finish` takes."""
    L, P, cap = req.shape
    W = dist.get_world_size()
    R = int(rows_per_slot)
    if P != W * L or store.shape[0] != L * R + 1:
        raise ValueError(f"req must be [L, W * L, cap] over a store of L * "
                         f"{R} + 1 rows with W = {W}; got req "
                         f"{tuple(req.shape)}, store {tuple(store.shape)}")
    register_collective("halo_a2a_request", DP_AXIS,
                        L * alltoall_bytes_per_step(P, cap, store.shape[1],
                                                    store.element_size()))
    # by destination process q: send[q, a, b] = req[a, q * L + b]
    send = req.reshape(L, W, L, cap).transpose(0, 1).contiguous()
    asked = torch.empty_like(send)
    work = dist.all_to_all_single(asked, send, async_op=async_op)
    return store, asked, R, work, (W, L, P, cap)


def request_rows_finish(handle) -> torch.Tensor:
    """The second half of :func:`alltoall_request_rows`: wait for the
    requests, answer them in one ``gather_rows`` and return the rows."""
    store, asked, R, work, (W, L, P, cap) = handle
    if work is not None:
        work.wait()
    D = store.shape[1]
    # asked[s, a, b]: what slot a of process s asks of my slot b
    base = torch.arange(L, device=asked.device,
                        dtype=torch.int64).view(1, 1, L, 1) * R
    idx = torch.where(asked >= 0, asked.long() + base, L * R)
    rows = gather_rows(store, idx.reshape(-1))
    back = torch.empty_like(rows)
    dist.all_to_all_single(back, rows)
    # back[q, a, b]: the rows my slot a asked of slot b of process q
    return back.view(W, L, L, cap, D).transpose(0, 1).reshape(L, P, cap, D)


def exchange_bytes_per_step(num_slots: int, rows: int, feat_dim: int,
                            itemsize: int = 4) -> int:
    """Analytic per-slot bytes of the device sampler's exchange
    (``DistTrainer.owner_rows``): the request all-gather (owner and
    local, int32 each, from every slot) plus the row payload every owner
    returns for every request, ``itemsize`` bytes an element (the
    store's: 1 for codes)."""
    request = num_slots * rows * 2 * 4
    payload = num_slots * rows * feat_dim * itemsize
    return request + payload


def alltoall_bytes_per_step(num_slots: int, pair_cap: int,
                            feat_dim: int, itemsize: int = 4) -> int:
    """Analytic per-slot bytes of one compacted exchange
    (:func:`alltoall_serve_rows`): the request rows out (int32) plus
    the payload back — each requested row crosses once, so the bill
    scales with the calibrated pair cap, not the input width; ``itemsize``
    is the store's element size."""
    return num_slots * pair_cap * (4 + feat_dim * itemsize)


def staging_buffer_bytes(num_slots: int, pair_cap: int, feat_dim: int,
                         depth: int = 2, itemsize: int = 4) -> int:
    """Per-slot memory bill of the exchange pipeline's staged receive
    buffers: each batch's ``[num_slots, pair_cap, D]`` payload in the
    store's dtype, ``depth`` of them in flight (the JAX package's
    formula)."""
    return depth * num_slots * pair_cap * feat_dim * itemsize
