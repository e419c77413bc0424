"""The sample → gather → forward path, shared by serving and the
partition-parallel trainer.

Seed ids are routed to their owner partition (:func:`route_by_owner`),
sampled and padded on the host (:func:`sample_padded`), their input rows
gathered (:func:`gather_host_rows`, the engine's owner-sharded gather,
or on the card :func:`gather_input_rows`) and run through the model
(:func:`build_predict_fn`, or :func:`seed_loss` in training). A store
holds its storage dtype (float32, bfloat16, or the int8 and uint8
codes of ``graph/quant.py``); rows are merged in that dtype and
reconstructed to float32 once, by :func:`dequant_rows`. The
sampling stream of every chunk derives from one formula
(:func:`part_sample_seed`), so the same request and seed draw the same
neighborhoods in this package and in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dgl_operator_tpu_torch.graph import quant
from dgl_operator_tpu_torch.graph.blocks import (FanoutBlock, MiniBatch,
                                                 build_fanout_blocks,
                                                 pad_minibatch)
from dgl_operator_tpu_torch.ops.gather import gather_rows


def part_sample_seed(step_seed: int, part_id: int) -> int:
    """Sampling stream of partition ``part_id`` for logical step (or
    request chunk) ``step_seed``."""
    return int(step_seed) * 1000003 + int(part_id)


def sample_padded(csc, seeds: np.ndarray, fanouts, caps, n_pad: int,
                  batch_size: int, sample_seed: int) -> MiniBatch:
    """Host fanout sampling + static-shape padding for ONE partition's
    seed batch: every batch lands on the same padded shapes."""
    mb = build_fanout_blocks(csc, np.asarray(seeds, np.int64), fanouts,
                             seed=sample_seed, src_caps=caps[1:])
    return pad_minibatch(mb, batch_size, fanouts, n_pad, caps=caps)


def seed_logits(model: torch.nn.Module, params: Dict[str, torch.Tensor],
                blocks, h: torch.Tensor) -> torch.Tensor:
    """The padded layer-stack forward with ``params`` (a state dict on
    the model's device) in place of the module's own weights."""
    return torch.func.functional_call(model, params, (blocks, h),
                                      strict=True)


def masked_loss(logits: torch.Tensor, labels: torch.Tensor,
                seeds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy and accuracy over the valid seed rows
    (``seeds >= 0``; padded seeds are -1)."""
    valid = (seeds >= 0).float()
    lab = labels[seeds.clamp_min(0).long()]
    ll = F.cross_entropy(logits, lab, reduction="none")
    n = valid.sum().clamp_min(1.0)
    loss = (ll * valid).sum() / n
    acc = ((logits.argmax(-1) == lab).float() * valid).sum() / n
    return loss, acc


def seed_loss(model: torch.nn.Module, blocks: Sequence[FanoutBlock],
              h: torch.Tensor, seeds: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Seed-masked cross-entropy of one padded minibatch, the loss the
    partition-parallel trainer optimizes: the model runs in ``eval()``
    mode (no dropout, as the JAX ``seed_logits`` applies it with
    ``train=False``) with gradients on. ``labels`` is the slot's
    ``[n_pad]`` label row; a slot of padding only gives 0."""
    model.eval()
    return masked_loss(model(blocks, h), labels, seeds)[0]


def dequant_rows(rows: torch.Tensor, scale: Optional[torch.Tensor] = None,
                 zero: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The one point where the storage dtype becomes float32: codes
    with their per-column sidecar ``scale`` and ``zero`` (``[D]``
    float32 tensors) give ``(rows.float() - zero) * scale``, the
    algebra of ``graph/quant.py::dequantize``, so an int8 store and a
    float32 store filled with the host-dequantized codes give the same
    bits (a subtraction and a product: nothing to contract into a
    multiply-add); float rows are upcast."""
    if scale is not None:
        return (rows.float() - zero) * scale
    return rows if rows.dtype == torch.float32 else rows.float()


def apply_exchanged_rows(rows: torch.Tensor, recv: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """The local half of the owner-layout gather: ``rows`` ``[n, D]``
    holds the slot's core rows and cache hits (a miss holds a junk row),
    and every answered halo row ``recv[o, j]`` lands at ``pos[o, j]``.
    Positions are unique; a pad points past the buffer (at ``n``) and
    is dropped: it lands in a spare row that is cut off. The merge runs
    in the storage dtype (an owner's codes arrive raw); the caller
    reconstructs once after it."""
    n, d = rows.shape
    buf = torch.cat([rows, rows.new_zeros(1, d)])
    buf.index_copy_(0, pos.reshape(-1).long().clamp_max(n),
                    recv.reshape(-1, d))
    return buf[:n]


def gather_input_rows(store: torch.Tensor, batch: Dict[str, torch.Tensor],
                      owner_layout: bool,
                      scale: Optional[torch.Tensor] = None,
                      zero: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One slot's float32 input rows on its device — the feature-layout
    seam. Replicated: ``gather_rows`` of ``batch["inputs"]`` from the
    slot's ``[n_pad, D]`` store. Owner: ``gather_rows`` of
    ``batch["exch_loc"]`` from its ``[c_pad + H, D]`` core and
    hot-cache store, then the halo rows the exchange answered
    (``batch["recv"]``, ``[P, pair_cap, D]``) scattered to
    ``batch["exch_pos"]``. Either way the rows are reconstructed once,
    after the merge (:func:`dequant_rows`; ``scale`` and ``zero`` for a
    store of codes)."""
    if not owner_layout:
        rows = gather_rows(store, batch["inputs"])
    else:
        rows = apply_exchanged_rows(gather_rows(store, batch["exch_loc"]),
                                    batch["recv"], batch["exch_pos"])
    return dequant_rows(rows, scale, zero)


def build_predict_fn(model: torch.nn.Module):
    """The request-time program ``(params, blocks, h) -> [seed_cap, C]
    logits``, run under ``torch.inference_mode`` with the model in
    ``eval()`` mode (no dropout), as the JAX engine applies it with
    ``train=False``."""
    model.eval()

    def predict(params, blocks, h):
        with torch.inference_mode():
            return seed_logits(model, params, blocks, h)

    return predict


def ensure_full_params(plan) -> None:
    """The prediction plane's adapter for ZeRO-3 (``parallel/dp.py``): a
    ``zero_stage=3`` plan keeps its selected parameters as resident
    shards between steps, while every prediction program
    (:func:`seed_logits`, layer-wise inference, ``export_for_serving``
    of the state dict) reads full ones. Gather them back into the model
    (they stay full until the next step frees them). A plan of
    ``zero_stage=1``, or None, holds full parameters already."""
    if plan is not None:
        plan.materialize()


def route_by_owner(node_ids: np.ndarray, node_map: np.ndarray,
                   batch_size: int):
    """Group request positions by owner partition (ascending part
    order), then chunk each group into ``batch_size`` seed batches in
    request order. Returns ``[(part, chunk_idx, positions), ...]`` where
    ``positions`` index into ``node_ids``."""
    node_ids = np.asarray(node_ids, np.int64)
    if node_ids.ndim != 1:
        raise ValueError("node_ids must be a 1-D id vector")
    if len(node_ids) and (node_ids.min() < 0
                          or node_ids.max() >= len(node_map)):
        raise ValueError(
            f"node id out of range [0, {len(node_map)}): "
            f"[{node_ids.min()}, {node_ids.max()}]")
    owners = node_map[node_ids]
    out = []
    for p in np.unique(owners):
        pos = np.nonzero(owners == p)[0]
        for ci, c in enumerate(range(0, len(pos), batch_size)):
            out.append((int(p), ci, pos[c:c + batch_size]))
    return out


def gather_host_rows(feats: np.ndarray, mb: MiniBatch,
                     scale: Optional[np.ndarray] = None,
                     zero: Optional[np.ndarray] = None) -> np.ndarray:
    """The padded minibatch's input rows from a [N, D] feature table, as
    float32. A table of codes passes its sidecar ``(scale, zero)`` and
    only the gathered rows are dequantized (the table may be a
    demand-paged mmap)."""
    rows = np.asarray(feats[np.asarray(mb.input_nodes)])
    if scale is not None:
        return quant.dequantize(rows, scale, zero)
    return rows.astype(np.float32, copy=False)
