"""Static-shape sampled blocks and their padding.

A ``FanoutBlock`` is one message-passing layer's sampled neighborhood
as a dense ``[num_dst, fanout]`` neighbor table with a validity mask;
aggregation over it is a masked reduction over the fanout axis
(``ops/fanout.py``). Padding every batch to the same caps keeps the
shapes the card sees fixed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dgl_operator_tpu_torch.graph import _native


class FanoutBlock:
    """One layer's sampled neighborhood, dense form.

    nbr      [num_dst, fanout] int32 — positions (into the block's
             *source* node array) of sampled in-neighbors of dst node i;
             invalid slots hold index 0.
    mask     [num_dst, fanout] 0/1 validity — ``float32`` fresh from the
             sampler, ``uint8`` after ``pad_minibatch``. Compare ``> 0``;
             never do arithmetic on the raw mask.
    num_src  number of source nodes (seed prefix + sampled).
    plan     optional ``ops.scatter.ScatterPlan`` of ``nbr`` over
             ``num_src`` rows: the transpose that the aggregation's
             backward sums over on the card (``SampledTrainer`` attaches
             one to the blocks whose source rows need a gradient).

    ``nbr``, ``mask`` and the plan are numpy arrays on the host or
    tensors after :meth:`to`.
    """

    def __init__(self, nbr, mask, num_src: int, plan=None):
        self.nbr = nbr
        self.mask = mask
        self.num_src = int(num_src)
        self.plan = plan

    @property
    def num_dst(self) -> int:
        return self.nbr.shape[0]

    @property
    def fanout(self) -> int:
        return self.nbr.shape[1]

    def to(self, device) -> "FanoutBlock":
        """The block as tensors on ``device``: ``nbr`` int32 and ``mask``
        uint8, the encodings the aggregation kernel reads, and the plan
        when there is one."""
        nbr = torch.as_tensor(self.nbr).to(device=device, dtype=torch.int32)
        mask = torch.as_tensor(self.mask)
        if mask.dtype != torch.uint8:
            mask = (mask > 0).to(torch.uint8)
        return FanoutBlock(nbr.contiguous(), mask.to(device).contiguous(),
                           self.num_src,
                           None if self.plan is None
                           else self.plan.to(device))


class MiniBatch:
    """Host-side product of multi-layer sampling for one step:
    ``input_nodes`` are the ids whose features are gathered, ``seeds``
    the label rows, ``blocks`` outermost-first."""

    def __init__(self, input_nodes: np.ndarray, seeds: np.ndarray,
                 blocks: List[FanoutBlock]):
        self.input_nodes = input_nodes
        self.seeds = seeds
        self.blocks = blocks


def stack_minibatches(mbs: Sequence[MiniBatch]) -> MiniBatch:
    """K padded minibatches of one shape stacked along a new leading
    axis (the JAX package's ``stack_minibatches``): every array gains a
    ``[K]`` axis and each block keeps the first batch's ``num_src``. The
    blocks' plans, which differ in size from batch to batch, are not
    stacked: the stacked blocks carry none."""
    first = mbs[0]
    blocks = [FanoutBlock(np.stack([mb.blocks[l].nbr for mb in mbs]),
                          np.stack([mb.blocks[l].mask for mb in mbs]),
                          first.blocks[l].num_src)
              for l in range(len(first.blocks))]
    return MiniBatch(np.stack([mb.input_nodes for mb in mbs]),
                     np.stack([mb.seeds for mb in mbs]), blocks)


def fanout_caps(seed_cap: int, fanouts: Sequence[int],
                num_nodes: Optional[int] = None) -> List[int]:
    """Static per-layer node caps, innermost (seeds) outward:
    ``cap_{l+1} = cap_l * (fanout_l + 1)``, clamped to the graph size."""
    bound = None if num_nodes is None else max(int(num_nodes), seed_cap)
    caps = [seed_cap]
    for f in reversed(list(fanouts)):   # innermost layer samples last fanout
        c = caps[-1] * (int(f) + 1)
        if bound is not None:
            c = min(c, bound)
        caps.append(c)
    return caps


def calibrate_caps(csc, train_ids: np.ndarray, batch_size: int,
                   fanouts: Sequence[int],
                   num_nodes: Optional[int] = None,
                   n_probe: int = 12, margin: float = 1.08,
                   round_to: int = 64, seed: int = 0) -> List[int]:
    """Measured per-layer caps: sample ``n_probe`` full batches, take
    the largest realized frontier per layer times ``margin``, round up
    to ``round_to`` and clamp to the worst-case bound. Batches that
    overflow a cap later are respilled by ``build_fanout_blocks``."""
    rng = np.random.default_rng(seed)
    train_ids = np.asarray(train_ids)
    worst = fanout_caps(batch_size, fanouts, num_nodes)
    if len(train_ids) == 0:
        return worst
    maxima = np.zeros(len(list(fanouts)), dtype=np.int64)
    for p in range(n_probe):
        seeds = rng.choice(train_ids, size=batch_size,
                           replace=len(train_ids) < batch_size)
        mb = build_fanout_blocks(csc, seeds.astype(np.int64), fanouts,
                                 seed=seed + 7919 * (p + 1))
        sizes = [blk.num_src for blk in reversed(mb.blocks)]
        maxima = np.maximum(maxima, np.asarray(sizes))
    caps = [batch_size]
    for l, m in enumerate(maxima):
        c = int(-(-int(m * margin) // round_to) * round_to)
        c = max(c, caps[-1])          # frontier ⊇ previous layer
        caps.append(min(c, worst[l + 1]))
    return caps


def pad_minibatch(mb: MiniBatch, seed_cap: int, fanouts: Sequence[int],
                  num_nodes: Optional[int] = None,
                  caps: Optional[Sequence[int]] = None) -> MiniBatch:
    """Pad a sampled minibatch to the static caps.

    Padded dst rows get mask 0 and neighbor position 0; padded seeds are
    id -1; padded input nodes are id 0. Masks ship as ``uint8`` and node
    ids as ``int32`` when the graph size allows.
    """
    if caps is None:
        caps = fanout_caps(seed_cap, fanouts, num_nodes)
    # blocks are outermost-first; block i has dst cap caps[L-1-i],
    # src cap caps[L-i]
    L = len(mb.blocks)
    new_blocks = []
    for i, blk in enumerate(mb.blocks):
        dst_cap, src_cap = caps[L - 1 - i], caps[L - i]
        if blk.num_dst > dst_cap or blk.num_src > src_cap:
            raise ValueError(f"block {i} ({blk.num_dst},{blk.num_src}) "
                             f"exceeds caps ({dst_cap},{src_cap})")
        pad_rows = dst_cap - blk.num_dst
        nbr = np.concatenate(
            [np.asarray(blk.nbr),
             np.zeros((pad_rows, blk.fanout), np.int32)])
        mask = np.concatenate(
            [np.asarray(blk.mask, dtype=np.uint8),
             np.zeros((pad_rows, blk.fanout), np.uint8)])
        new_blocks.append(FanoutBlock(nbr, mask, src_cap))
    in_cap = caps[-1]
    if len(mb.input_nodes) > in_cap:
        raise ValueError("input nodes exceed cap")
    id_dtype = (np.int32 if num_nodes is not None and num_nodes < 2**31
                else np.int64)
    inputs = np.concatenate(
        [np.asarray(mb.input_nodes, id_dtype),
         np.zeros(in_cap - len(mb.input_nodes), id_dtype)])
    seeds = np.concatenate(
        [np.asarray(mb.seeds, id_dtype),
         np.full(seed_cap - len(mb.seeds), -1, id_dtype)])
    return MiniBatch(inputs, seeds, new_blocks)


def build_fanout_blocks(csc: Tuple[np.ndarray, np.ndarray, np.ndarray],
                        seeds: np.ndarray,
                        fanouts: Sequence[int],
                        seed: int = 0,
                        src_caps: Optional[Sequence[int]] = None,
                        plain: bool = False,
                        ) -> MiniBatch:
    """Multi-layer fixed-fanout sampling outward from ``seeds``; the dst
    nodes of each block are a prefix of its src nodes. Each layer is
    one call of the graph core's ``sample_fanout`` and one of its
    ``compact_frontier``.

    ``src_caps`` (innermost-out) bounds each layer's unique frontier:
    overflow *new* neighbors are dropped at random (deterministic in
    ``seed``) and their fanout slots masked invalid.

    ``plain`` samples with the numpy plain versions instead (another
    random stream where a degree exceeds its fanout or a cap
    respills), to hold the library against; the main path never sets
    it.
    """
    if plain:
        sample, compact = (_native.sample_fanout_plain,
                           _native.compact_frontier_plain)
    else:
        sample, compact = _native.sample_fanout, _native.compact_frontier
    indptr, indices, eids = csc
    seeds = np.asarray(seeds, dtype=np.int64)
    frontier = seeds  # global ids, current dst set
    per_layer = []
    for l, fan in enumerate(reversed(list(fanouts))):
        nbr, _ = sample(indptr, indices, eids, frontier, int(fan),
                        seed + 1315423911 * (l + 1))
        cap = None if src_caps is None else int(src_caps[l])
        src_nodes, pos, valid_f = compact(frontier, nbr, cap,
                                          seed + 2654435761 * (l + 1))
        per_layer.append((pos, valid_f, len(src_nodes)))
        frontier = src_nodes
    blocks = [FanoutBlock(pos, mask, num_src)
              for pos, mask, num_src in per_layer]
    blocks.reverse()  # outermost first, reference order
    return MiniBatch(frontier, seeds, blocks)
