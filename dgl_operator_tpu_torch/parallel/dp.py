"""Data parallelism over partition slots: the gradient mean.

The counterpart of the JAX package's ``_ddp_update``
(``dgl_operator_tpu/parallel/dp.py``): each slot's loss is
differentiated on its own batch, the gradients are averaged over the
slots (``pmean``) and one optimizer step applies the mean. This module
is the one place that reduction lives. In the single-process form every
slot is resident on one device, so the mean is an accumulation of
``grad / P`` in slot order; across cards it becomes an ``all_reduce``.
"""

from __future__ import annotations

from typing import Callable

import torch


def slot_mean_step(optimizer: torch.optim.Optimizer,
                   loss_of_slot: Callable[[int], torch.Tensor],
                   num_slots: int) -> torch.Tensor:
    """One optimizer step on the mean over ``num_slots`` of the
    per-slot gradients; returns the mean of the slot losses (a device
    scalar, no sync).

    ``loss_of_slot(s)`` builds slot ``s``'s loss. Each is
    back-propagated as soon as it is built, weighted ``1 / num_slots``,
    so one slot's activations are alive at a time. A slot without train
    seeds gives a zero loss and zero gradients and still counts: the
    divisor is ``num_slots``, not the non-empty slots."""
    optimizer.zero_grad(set_to_none=True)
    losses = []
    for s in range(num_slots):
        loss = loss_of_slot(s)
        (loss / num_slots).backward()
        losses.append(loss.detach())
    optimizer.step()
    return torch.stack(losses).mean()
