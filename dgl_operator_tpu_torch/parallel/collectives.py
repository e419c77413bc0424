"""Host-side agreement between the processes of a ``torch.distributed``
group, and where a collective's tensor lives.

The counterparts of ``_allreduce_host`` and ``_host_gather_rows`` of
``dgl_operator_tpu/runtime/dist.py``: every process contributes its
host-side integers and all adopt the same elementwise reduction (min of
step counts, max of caps and pads), so every process builds the same
static shapes. Without an initialized process group each is the
identity.

Under NCCL a collective's tensor must be on the rank's CUDA card; under
gloo the host values stay on the CPU. :func:`comm_device` is the one
place that choice is made. The sharded step's flat collectives
(:func:`reduce_scatter_sum`, :func:`all_gather_flat`) and the ring's
point-to-point hop (:func:`send_recv`) take CUDA tensors under NCCL and
copy them through the host under gloo, whose support of these calls on
CUDA tensors varies by version (its ``all_reduce``, ``all_gather`` and
``all_to_all_single`` take them, ``examples/gloo_cuda_probe.py``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist


def group_active() -> bool:
    """Whether a process group is initialized in this process."""
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """``(rank, world size)`` of the process group; ``(0, 1)`` without
    one."""
    if not group_active():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def comm_device() -> torch.device:
    """The device of a host value's collective: the rank's current CUDA
    card under NCCL, the CPU under any other backend."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(arr: np.ndarray) -> np.ndarray:
    """``[world, *arr.shape]``: every rank's ``arr`` in rank order (the
    same shape and dtype on every rank)."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(comm_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def allreduce_host(local, reduce: Callable):
    """Every rank's integer scalar or vector ``local`` reduced
    elementwise over the ranks by ``reduce(stacked, axis=0)`` (``np.min``,
    ``np.max``, ``np.sum``); one ``all_gather`` of an int64 vector a
    call, so pass vectors whole. Returns an int for a scalar, a list of
    ints for a vector."""
    arr = np.atleast_1d(np.asarray(local, np.int64))
    if group_active():
        arr = reduce(_all_gather(arr), axis=0)
    return (int(arr[0]) if np.ndim(local) == 0
            else [int(v) for v in arr])


def host_gather_rows(arr: np.ndarray) -> np.ndarray:
    """Every rank's rows of ``arr`` concatenated in rank order along
    the first axis. Each rank holds a contiguous block of the parts, so
    rank order is part order. Without a group: ``arr``."""
    arr = np.asarray(arr)
    if not group_active():
        return arr
    g = _all_gather(arr)
    return g.reshape((-1,) + arr.shape[1:])


def broadcast_params(module: torch.nn.Module, src: int = 0) -> None:
    """Every rank takes rank ``src``'s parameters and buffers, as DDP
    does at construction."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)


def barrier() -> None:
    """Wait for every rank of the group."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _host_staged(t: torch.Tensor) -> bool:
    """A CUDA tensor under gloo: the call goes through a host copy."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _op(new: str, old: str):
    """The collective ``new`` where this torch has it, else ``old`` (the
    same signature under its older name)."""
    return getattr(dist, new, None) or getattr(dist, old)


def reduce_scatter_sum(out: torch.Tensor, inp: torch.Tensor) -> None:
    """``out`` = this rank's ``1 / world`` block of the sum over the
    ranks of ``inp`` (``reduce_scatter_tensor``)."""
    fn = _op("reduce_scatter_single", "reduce_scatter_tensor")
    if _host_staged(inp):
        host = out.new_empty(out.shape, device="cpu")
        fn(host, inp.cpu())
        out.copy_(host)
        return
    fn(out, inp)


def all_gather_flat(out: torch.Tensor, inp: torch.Tensor,
                    async_op: bool = False):
    """``out`` = every rank's ``inp`` in rank order
    (``all_gather_into_tensor``); with ``async_op`` the work's handle,
    None where nothing is left to wait for."""
    fn = _op("all_gather_single", "all_gather_into_tensor")
    if _host_staged(inp):
        host = out.new_empty(out.shape, device="cpu")
        fn(host, inp.cpu())
        out.copy_(host)
        return None
    return fn(out, inp, async_op=async_op)


def send_recv(x: torch.Tensor, rank: int, world: int, d: int = 1
              ) -> torch.Tensor:
    """``x`` sent to rank ``rank + d`` while rank ``rank - d``'s arrives
    (one ``batch_isend_irecv``); returns what arrived."""
    x = x.contiguous()
    staged = _host_staged(x)
    send = x.cpu() if staged else x
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (rank + d) % world),
           dist.P2POp(dist.irecv, recv, (rank - d) % world)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if staged else recv
