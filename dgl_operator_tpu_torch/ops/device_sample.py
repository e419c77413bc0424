"""Neighbor sampling on the card — the device sampler.

The counterpart of ``dgl_operator_tpu/ops/device_sample.py``. The graph's
CSR (``indptr`` and ``indices``) lives on the device, each step draws
uniform with-replacement neighbors (the reference's ``replace=True``)
with plain torch ops, and the only per-step input is the ``[batch]``
seed ids. Nothing syncs the host and every shape is fixed by the batch
size and the fanouts, so a step that samples this way can be captured
in a CUDA graph (``runtime/graphs.py``).

Tree-form blocks, no frontier compaction: every dst-node occurrence
samples its own fanout slots and nothing is deduplicated, so layer
sizes are ``n_{l+1} = n_l * (fanout_l + 1)`` (:func:`tree_caps`). For
the mean and sum aggregators the tree is distribution-identical to the
host sampler's compacted blocks; it costs duplicate gathers and
aggregations. Blocks come outermost-first with the dst-prefix invariant
(dst node ``i`` at source position ``i``, its slot ``k`` at ``n + i * F
+ k``), so ``FanoutSAGEConv`` consumes them unchanged.

The draws. JAX draws each layer's ``[n, F]`` slot numbers with
``jax.random.randint`` from a split key; this module draws them from a
counter-based hash in torch integer ops instead (:func:`draw_key`,
:func:`tree_draws`): a 31-bit value per ``(key, layer, flat index)``,
where the key hashes the caller's integers (``SampledTrainer``: the
run's seed and the global step; ``DistTrainer``: the step seed and the
part). The values are not ``jax.random``'s, but they are the same on
the CPU and on the card, the same whether a step runs alone or inside a
captured K-step call, and a device tensor can carry the step, so no
generator is reseeded inside a graph. :func:`sample_fanout_tree_from_draws`
takes the draws from outside, so a test can hand it JAX's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dgl_operator_tpu_torch.graph.blocks import FanoutBlock
from dgl_operator_tpu_torch.ops.scatter import tree_scatter_plan

IntLike = Union[int, torch.Tensor]
_M32 = 0xFFFFFFFF
# murmur3's 32-bit finalizer constants
_C1, _C2 = 0x85EBCA6B, 0xC2B2AE35
_KEY_BASIS = 0x9E3779B9


def tree_caps(seed_cap: int, fanouts: Sequence[int]) -> List[int]:
    """Tree layer sizes, innermost (seeds) outward: ``n_{l+1} = n_l *
    (fanout_l + 1)``, with no clamp to the graph size (the tree keeps
    duplicates)."""
    caps = [int(seed_cap)]
    for f in reversed(list(fanouts)):
        caps.append(caps[-1] * (int(f) + 1))
    return caps


def csr_index_dtype(num_nodes: int, num_edges: int) -> np.dtype:
    """The device CSR's index type: int32 when both counts are below
    2^31, else int64."""
    return np.dtype(np.int32 if max(int(num_nodes), int(num_edges)) < 2**31
                    else np.int64)


def device_csr(csc: Tuple[np.ndarray, np.ndarray, np.ndarray],
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A host CSC ``(indptr, indices, eids)`` as ``(indptr, indices)`` on
    ``device`` in :func:`csr_index_dtype` (``indptr`` holds offsets,
    ``indices`` node ids; either past int32 widens both). An edgeless
    graph gets one sentinel index, which every draw masks (each node has
    degree 0)."""
    indptr, indices, _ = csc
    dt = csr_index_dtype(len(indptr) - 1, len(indices))
    if len(indices) == 0:
        indices = np.zeros(1, dt)
    return (torch.from_numpy(np.asarray(indptr, dt)).to(device),
            torch.from_numpy(np.asarray(indices, dt)).to(device))


def _mul32(x, c: int):
    """``x * c mod 2^32`` for ``0 <= x < 2^32``, in products below 2^49
    (no int64 overflow): the high and low 16 bits of ``x`` apart."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def mix32(x):
    """murmur3's 32-bit finalizer, a bijection of ``[0, 2^32)``, on a
    Python int or an int64 tensor of such values."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def _fold(part: IntLike):
    """A non-negative integer below 2^63 as 32 bits."""
    return (part & _M32) ^ ((part >> 32) & _M32)


def draw_key(*parts: IntLike) -> IntLike:
    """The draws' key of a tuple of integers (Python ints, or int64
    scalar tensors on the sampler's device, such as a device step
    counter), each in ``[0, 2^63)``: one :func:`mix32` round per part."""
    key = _KEY_BASIS
    for part in parts:
        key = mix32(key ^ _fold(part))
    return key


def draw_counters(seed_cap: int, fanouts: Sequence[int], device
                  ) -> List[torch.Tensor]:
    """Per layer in sampling order (the seeds' layer first), the
    :func:`mix32` of every flat slot index ``[n * F]`` (int64): the part
    of each draw that no step changes."""
    out = []
    n = int(seed_cap)
    for fan in reversed(list(fanouts)):
        out.append(mix32(torch.arange(n * int(fan), dtype=torch.int64,
                                      device=device)))
        n *= int(fan) + 1
    return out


def tree_draws(key: IntLike, counters: Sequence[torch.Tensor],
               fanouts: Sequence[int]) -> List[torch.Tensor]:
    """Each layer's ``[n, F]`` int32 draws in ``[0, 2^31)``, in sampling
    order: ``mix32(counter ^ mix32(key ^ mix32(layer + 1))) >> 1`` over
    :func:`draw_counters`' ``counters``."""
    out = []
    for layer, (cnt, fan) in enumerate(zip(counters,
                                           reversed(list(fanouts)))):
        k = mix32(key ^ mix32(layer + 1))
        bits = mix32(cnt ^ k) >> 1
        out.append(bits.to(torch.int32).view(-1, int(fan)))
    return out


def tree_positions(seed_cap: int, fanouts: Sequence[int], device
                   ) -> List[torch.Tensor]:
    """Per layer in sampling order, the tree block's neighbor table
    ``pos[i, k] = n + i * F + k`` (int32 ``[n, F]``): the same every
    step."""
    out = []
    n = int(seed_cap)
    for fan in reversed(list(fanouts)):
        out.append((n + torch.arange(n * int(fan), dtype=torch.int32,
                                     device=device)).view(n, int(fan)))
        n *= int(fan) + 1
    return out


def sample_fanout_tree_from_draws(
        indptr: torch.Tensor, indices: torch.Tensor, seeds: torch.Tensor,
        fanouts: Sequence[int], draws: Sequence[torch.Tensor],
        positions: Optional[Sequence[torch.Tensor]] = None,
        plans: bool = False, slot_plans: bool = False
        ) -> Tuple[List[FanoutBlock], torch.Tensor]:
    """Multi-layer uniform with-replacement fanout sampling from given
    draws; returns ``(blocks, input_ids)``, blocks outermost-first and
    ``input_ids`` the global ids whose rows the first layer reads.

    indptr, indices  the CSR on the device (:func:`device_csr`).
    seeds            ``[B]`` integer seed ids; ``-1`` pads.
    draws            per layer in sampling order (the seeds' layer
                     first), ``[n, F]`` non-negative integers; slot
                     ``(i, k)`` takes in-neighbor ``draws[i, k] % deg``
                     of its node.
    positions        :func:`tree_positions` of these shapes, to reuse
                     (built here when None).
    plans            attach :func:`~ops.scatter.tree_scatter_plan` (the
                     transposes the card's backward sums over) as
                     :func:`~ops.scatter.attach_plans` does:
                     ``slot_plans`` (the model's) gives every block
                     the plan of its slots, else every block but the
                     first gets the plan of its rows.

    A padded seed and a node of degree 0 mask their whole fanout row; a
    masked slot's source id is 0. Out-of-range reads are clamped, as
    JAX's ``mode="clip"`` takes are, so no index leaves its array."""
    if positions is None:
        positions = tree_positions(seeds.shape[0], fanouts, seeds.device)
    idt = indptr.dtype
    last_ptr = indptr.numel() - 1
    last_idx = indices.numel() - 1
    f = seeds.to(idt).clamp_min(0)
    valid = seeds >= 0
    per_layer = []
    for layer, (fan, r) in enumerate(zip(reversed(list(fanouts)), draws)):
        fan = int(fan)
        n = f.shape[0]
        start = indptr.index_select(0, f.clamp_max(last_ptr))
        deg = indptr.index_select(0, (f + 1).clamp_max(last_ptr)) - start
        slot = r.to(idt) % deg.clamp_min(1).unsqueeze(1)
        at = (start.unsqueeze(1) + slot).clamp(0, last_idx)
        nbr = indices.index_select(0, at.view(-1)).view(n, fan)
        mask = ((deg > 0) & valid).unsqueeze(1).expand(n, fan)
        per_layer.append((positions[layer], mask.to(torch.uint8).contiguous(),
                          n * (fan + 1)))
        f = torch.cat([f, torch.where(mask, nbr,
                                      torch.zeros((), dtype=idt,
                                                  device=f.device))
                       .view(-1)])
        valid = torch.cat([valid, mask.reshape(-1)])
    blocks = [FanoutBlock(pos, m, ns) for pos, m, ns in reversed(per_layer)]
    if plans:
        for blk in blocks[0 if slot_plans else 1:]:
            blk.plan = tree_scatter_plan(blk.mask, slots=slot_plans)
    return blocks, f


def sample_fanout_tree(indptr: torch.Tensor, indices: torch.Tensor,
                       seeds: torch.Tensor, fanouts: Sequence[int],
                       key: IntLike, plans: bool = False
                       ) -> Tuple[List[FanoutBlock], torch.Tensor]:
    """:func:`sample_fanout_tree_from_draws` with the draws of ``key``
    (:func:`tree_draws`)."""
    counters = draw_counters(seeds.shape[0], fanouts, seeds.device)
    return sample_fanout_tree_from_draws(
        indptr, indices, seeds, fanouts, tree_draws(key, counters, fanouts),
        plans=plans)


class TreeSampler:
    """The device sampler at one batch size and fanouts: the constant
    positions and draw counters on ``device``, and :meth:`sample` for a
    CSR, a step's seeds and a key. ``slot_plans`` (the model's) says
    which plans the blocks carry."""

    def __init__(self, batch_size: int, fanouts: Sequence[int], device,
                 slot_plans: bool = False):
        self.slot_plans = bool(slot_plans)
        self.fanouts = tuple(int(f) for f in fanouts)
        self.caps = tree_caps(batch_size, self.fanouts)
        self.positions = tree_positions(batch_size, self.fanouts, device)
        self.counters = draw_counters(batch_size, self.fanouts, device)

    def sample(self, indptr: torch.Tensor, indices: torch.Tensor,
               seeds: torch.Tensor, key: IntLike
               ) -> Tuple[List[FanoutBlock], torch.Tensor]:
        """The tree blocks (plans attached) and input ids of ``seeds``
        over the CSR ``(indptr, indices)`` under the draws of ``key``."""
        return sample_fanout_tree_from_draws(
            indptr, indices, seeds, self.fanouts,
            tree_draws(key, self.counters, self.fanouts),
            positions=self.positions, plans=True,
            slot_plans=self.slot_plans)
