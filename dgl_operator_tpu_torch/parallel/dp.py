"""Data parallelism over partition slots: the gradient mean.

The counterpart of the JAX package's ``_ddp_update``
(``dgl_operator_tpu/parallel/dp.py``): each slot's loss is
differentiated on its own batch, the gradients are averaged over the
slots (``pmean``) and one optimizer step applies the mean. This module
is the one place that reduction lives. Every process accumulates
``grad / P`` over its own slots in slot order, ``P`` the global slot
count; in a ``torch.distributed`` group one ``all_reduce`` then sums the
processes' gradients, as the reference's DDP does.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from dgl_operator_tpu_torch.parallel.collectives import group_active, world


def slot_mean_step(optimizer: torch.optim.Optimizer,
                   loss_of_slot: Callable[[int], torch.Tensor],
                   num_slots: int,
                   num_parts: Optional[int] = None) -> torch.Tensor:
    """One optimizer step on the mean over every slot of the per-slot
    gradients; returns the mean of the slot losses (a device scalar, no
    sync).

    ``loss_of_slot(s)`` builds local slot ``s``'s loss, for ``s`` in
    ``range(num_slots)``. Each is back-propagated as soon as it is
    built, weighted ``1 / num_parts`` (default ``num_slots``), so one
    slot's activations are alive at a time. A slot without train seeds
    gives a zero loss and zero gradients and still counts: the divisor
    is the slot count, not the non-empty slots.

    With a process group initialized, this process holds slots ``rank *
    num_slots`` to ``(rank + 1) * num_slots - 1`` of ``num_parts``; one
    ``all_reduce(SUM)`` of every gradient and the slot losses, in one
    flat bucket, makes each process's step the global one."""
    P = num_slots if num_parts is None else int(num_parts)
    optimizer.zero_grad(set_to_none=True)
    losses = []
    for s in range(num_slots):
        loss = loss_of_slot(s)
        (loss / P).backward()
        losses.append(loss.detach())
    loss_vec = torch.stack(losses)
    if group_active():
        loss_vec = _all_reduce_bucket(optimizer, loss_vec, P)
    optimizer.step()
    return loss_vec.mean()


def _all_reduce_bucket(optimizer: torch.optim.Optimizer,
                       local_losses: torch.Tensor, P: int) -> torch.Tensor:
    """Sum every parameter's gradient over the group in place and return
    the ``[P]`` vector of every slot's loss. The losses ride the same
    bucket: each slot's entry has one non-zero contributor, so the sum
    is exact and the mean equals the single-process one bit for bit."""
    rank, size = world()
    L = local_losses.numel()
    if L * size != P:
        raise ValueError(f"{size} processes of {L} slots each do not hold "
                         f"the {P} slots")
    params: List[torch.Tensor] = [
        p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    loss_vec = local_losses.new_zeros(P)
    loss_vec[rank * L:(rank + 1) * L] = local_losses
    flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss_vec])
    dist.all_reduce(flat)
    off = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n
    return flat[off:]
