"""KGE negatives drawn on the device.

The counterpart of the device draw in ``dgl_operator_tpu/runtime/kge.py``
(``neg_sampler="device"``). JAX draws each slot's ``[num_chunks,
neg_sample_size]`` negatives with ``jax.random.randint(fold_in(
PRNGKey(seed_u), slot), ..., 0, n_entities)``, ``seed_u`` the update's
seed (:func:`update_seed`) and ``slot`` the dp-major slot index. The
port cannot reproduce threefry's bits; as the device sampler does
(``ops/device_sample.py``), it draws from a counter hash in torch
integer ops keyed on ``(seed_u, slot)``: the same values on the CPU and
on the card, uniform over ``[0, n_entities)`` (a 31-bit draw scaled by
a multiply and a shift, so no id is favoured by more than one part in
2^31 / n_entities).

The key is made of host integers and the counters stay on the device,
so a draw never waits for the card and nothing of it comes back to the
host. :func:`negatives_from_draws` is the seam for draws made elsewhere:
the trainer's update takes them as a tensor, so a test can hand it
JAX's own.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dgl_operator_tpu_torch.ops.device_sample import draw_key, mix32

_P31 = 2 ** 31 - 1


def update_seed(seed: int, step: int, num_client: int, client: int) -> int:
    """The per-update seed of the JAX trainer: ``(seed * 1000003 + step
    * K + c) % (2^31 - 1)``, in Python integers."""
    return (int(seed) * 1000003 + int(step) * int(num_client)
            + int(client)) % _P31


def draw_counters(num_chunks: int, neg_sample_size: int, device
                  ) -> torch.Tensor:
    """``mix32`` of every flat draw index ``[C * N]`` (int64): the part
    of a draw that no update changes."""
    return mix32(torch.arange(int(num_chunks) * int(neg_sample_size),
                              dtype=torch.int64, device=device))


def draw_negatives(seed_u: int, slots: Sequence[int], counters: torch.Tensor,
                   num_chunks: int, n_entities: int) -> torch.Tensor:
    """``[len(slots), C, N]`` int32 negatives in ``[0, n_entities)``,
    slot ``s`` keyed on ``draw_key(seed_u, s)``, on the counters'
    device: ``(mix32(counter ^ key) >> 1) * n_entities >> 31``."""
    out = []
    for s in slots:
        key = draw_key(int(seed_u), int(s))
        bits = mix32(counters ^ key) >> 1
        out.append(((bits * int(n_entities)) >> 31).to(torch.int32)
                   .view(int(num_chunks), -1))
    return torch.stack(out)


def negatives_from_draws(draws, n_entities: int, device) -> torch.Tensor:
    """Draws made elsewhere (``[S, C, N]`` integers in ``[0,
    n_entities)``, e.g. JAX's ``jax.random.randint``) as the int32
    tensor the trainer's update takes."""
    t = torch.as_tensor(draws).to(device=device, dtype=torch.int32)
    if t.dim() != 3:
        raise ValueError(f"draws must be [slots, chunks, negatives], got "
                         f"shape {tuple(t.shape)}")
    if t.numel() and (int(t.min()) < 0 or int(t.max()) >= n_entities):
        raise ValueError(f"a draw lies outside [0, {n_entities})")
    return t
