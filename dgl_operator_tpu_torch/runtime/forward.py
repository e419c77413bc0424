"""The sample → gather → forward path of a request.

Seed ids are routed to their owner partition (:func:`route_by_owner`),
sampled and padded on the host (:func:`sample_padded`), their input rows
gathered (:func:`gather_host_rows`, or the engine's owner-sharded
gather) and run through the model (:func:`build_predict_fn`). The
sampling stream of every chunk derives from one formula
(:func:`part_sample_seed`), so the same request and seed draw the same
neighborhoods in this package and in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dgl_operator_tpu_torch.graph.blocks import (MiniBatch,
                                                 build_fanout_blocks,
                                                 pad_minibatch)


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


def build_predict_fn(model: torch.nn.Module):
    """The request-time program ``(params, blocks, h) -> [seed_cap, C]
    logits``, run under ``torch.inference_mode``."""

    def predict(params, blocks, h):
        with torch.inference_mode():
            return seed_logits(model, params, blocks, h)

    return predict


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


def gather_host_rows(feats: np.ndarray, mb: MiniBatch) -> np.ndarray:
    """The padded minibatch's input rows from a [N, D] feature table, as
    float32."""
    rows = np.asarray(feats[np.asarray(mb.input_nodes)])
    return rows.astype(np.float32, copy=False)
