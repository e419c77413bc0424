"""Data parallelism over partition slots: the gradient mean.

The counterpart of the JAX package's ``_ddp_update``
(``dgl_operator_tpu/parallel/dp.py``): each slot's loss is
differentiated on its own batch, the gradients are averaged over the
slots (``pmean``) and one optimizer step applies the mean. This module
is the one place that reduction lives. Every process accumulates
``grad / P`` over its own slots in slot order, ``P`` the global slot
count; in a ``torch.distributed`` group one ``all_reduce`` then sums the
processes' gradients, as the reference's DDP does. The mean registers
its bytes (``grad_pmean``) with the comm ledger (``obs/comm.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from dgl_operator_tpu_torch.obs import quality as Q
from dgl_operator_tpu_torch.obs.comm import register_collective
from dgl_operator_tpu_torch.parallel.collectives import group_active, world
from dgl_operator_tpu_torch.parallel.mesh import DP_AXIS


def slot_mean_step(optimizer: torch.optim.Optimizer,
                   loss_of_slot: Callable[[int], torch.Tensor],
                   num_slots: int,
                   num_parts: Optional[int] = None,
                   delta: Optional[Q.ParamDelta] = None
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One optimizer step on the mean over every slot of the per-slot
    gradients; returns the mean of the slot losses (a device scalar, no
    sync) and, given ``delta`` (the sentry's
    :class:`~dgl_operator_tpu_torch.obs.quality.ParamDelta` over the
    optimizer's parameters), the step's ``dp_slot_stats`` stacked over
    the slots, else None.

    ``loss_of_slot(s)`` builds local slot ``s``'s loss, for ``s`` in
    ``range(num_slots)``. Each is differentiated as soon as it is
    built, weighted ``1 / num_parts`` (default ``num_slots``), so one
    slot's activations are alive at a time, and its gradients are added
    into ``.grad`` in slot order, as ``backward`` accumulates them; the
    slot's own gradients are counted for non-finite elements on the
    way (``part_nonfinite``). A slot without train seeds gives a zero
    loss and zero gradients and still counts: the divisor is the slot
    count, not the non-empty slots.

    With a process group initialized, this process holds slots ``rank *
    num_slots`` to ``(rank + 1) * num_slots - 1`` of ``num_parts``; one
    ``all_reduce(SUM)`` of every gradient, the slot losses and the slot
    non-finite counts, in one flat bucket, makes each process's step
    the global one, and the stats cover every slot of the group."""
    P = num_slots if num_parts is None else int(num_parts)
    params: List[torch.Tensor] = [
        p for group in optimizer.param_groups for p in group["params"]]
    optimizer.zero_grad(set_to_none=True)
    losses, nonfinite = [], []
    for s in range(num_slots):
        loss = loss_of_slot(s)
        grads = torch.autograd.grad(loss / P, params, allow_unused=True)
        for p, g in zip(params, grads):
            if g is None:
                continue
            if p.grad is None:
                p.grad = g.contiguous()
            else:
                p.grad += g
        if delta is not None:
            nonfinite.append(Q.nonfinite_count([*grads, loss.reshape(1)]))
        losses.append(loss.detach())
    loss_vec = torch.stack(losses)
    nonfinite_vec = (torch.stack(nonfinite).float() if nonfinite
                     else torch.zeros_like(loss_vec))
    # the comm ledger's bill of the gradient mean (the JAX pmean's)
    register_collective("grad_pmean", DP_AXIS,
                        sum(2 * p.numel() * p.element_size()
                            for p in params))
    if group_active():
        loss_vec, nonfinite_vec = _all_reduce_bucket(
            params, loss_vec, nonfinite_vec, P)
    if delta is None:
        optimizer.step()
        return loss_vec.mean(), None
    stats = Q.grad_part([p.grad for p in params])
    delta.before()
    optimizer.step()
    stats.update(delta.stats())
    stats["part_loss"] = loss_vec.float()
    stats["part_nonfinite"] = nonfinite_vec.round().long()
    return loss_vec.mean(), stats


def _all_reduce_bucket(params: List[torch.Tensor],
                       local_losses: torch.Tensor,
                       local_nonfinite: torch.Tensor, P: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum every parameter's gradient over the group in place and return
    the ``[P]`` vectors of every slot's loss and non-finite count. Both
    ride the same bucket, whose layout does not depend on the sentry:
    each slot's entry has one non-zero contributor, so the sum is exact
    and the mean equals the single-process one bit for bit."""
    rank, size = world()
    L = local_losses.numel()
    if L * size != P:
        raise ValueError(f"{size} processes of {L} slots each do not hold "
                         f"the {P} slots")
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    vecs = local_losses.new_zeros(2, P)
    vecs[0, rank * L:(rank + 1) * L] = local_losses
    vecs[1, rank * L:(rank + 1) * L] = local_nonfinite
    flat = torch.cat([p.grad.reshape(-1) for p in params]
                     + [vecs.reshape(-1)])
    dist.all_reduce(flat)
    off = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n
    vecs = flat[off:].view(2, P)
    return vecs[0], vecs[1]
