"""GAT and GATv2 stacks: sampled (``DistGAT``, ``DistGATv2``), full
graph (``GAT``), and full-graph inference with sampled weights.

The counterparts of ``dgl_operator_tpu/models/gat.py``. ``DistGAT`` is
an L-layer stack of ``FanoutGATConv`` (``DistGATv2``: of
``FanoutGATv2Conv``) consuming sampled blocks outermost-first, ELU and,
in ``train()`` mode, dropout between layers; the last layer has one
head and averages it. :func:`gat_inference` runs the same weights layer
by layer over every in-edge of the whole graph (evaluation), through
``nn/conv.py::sparse_edge_attention``, which holds no ``[E, H * D]``
table. Weights cross in the flax layout (``FanoutGATConv_<i>``:
``fc/kernel``, ``attn_l``, ``attn_r``; ``FanoutGATv2Conv_<i>``:
``fc_src/kernel``, ``fc_dst/kernel``, ``attn``), through
``models/flax_layout.py``.

:func:`gat_hub_attention` computes one attention layer's output for hub
nodes over their whole in-neighborhoods with the neighbor axis cut into
shards (``parallel/ring_attention.py::gathered_gat_attention``), and
:func:`bucket_by_degree` batches nodes by degree band for it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.graph.blocks import FanoutBlock
from dgl_operator_tpu_torch.graph.graph import DeviceGraph, Graph
from dgl_operator_tpu_torch.models.sage import (call_layer,
                                                compute_dtype_of)
from dgl_operator_tpu_torch.models.sage import dropout as drop
from dgl_operator_tpu_torch.nn.conv import (FanoutGATConv, FanoutGATv2Conv,
                                            GATConv, gat_projection_raw,
                                            gatv2_projection_raw,
                                            sparse_edge_attention)


def _attention_stack(conv_cls, in_feats: int, hidden_feats: int,
                     out_feats: int, num_heads: int, num_layers: int,
                     negative_slope: float,
                     generator: Optional[torch.Generator],
                     dtype: Optional[torch.dtype] = None) -> nn.ModuleList:
    """``num_layers`` attention layers: ``num_heads`` concatenated heads
    of ``hidden_feats`` each but the last, which has one averaged head
    of ``out_feats``; drawn on the CPU from ``generator``, computing in
    ``dtype``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    layers = []
    for i in range(num_layers):
        last = i == num_layers - 1
        layers.append(conv_cls(
            in_feats if i == 0 else hidden_feats * num_heads,
            out_feats if last else hidden_feats,
            num_heads=1 if last else num_heads,
            negative_slope=negative_slope, concat_heads=not last,
            device="cpu", generator=generator, dtype=dtype))
    return nn.ModuleList(layers)


class DistGAT(nn.Module):
    """Sampled-path GAT stack; ``forward`` returns float32 logits for
    the seed rows of the innermost block. ``dropout`` is the rate
    applied after each inner ELU in ``train()`` mode (the trainer sets
    it).

    ``slot_plans = True``: every block's backward gathers need their
    transposes on the card (the attention logits of block 0 depend on
    the weights), and each gather is per slot. ``compute_dtype`` and
    ``remat`` are ``DistSAGE``'s."""

    conv_cls = FanoutGATConv
    flax_prefix = "FanoutGATConv"
    slot_plans = True

    def __init__(self, in_feats: int, hidden_feats: int, out_feats: int,
                 num_heads: int = 4, num_layers: int = 2,
                 dropout: float = 0.5, negative_slope: float = 0.2,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[str] = None, remat: bool = False):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        device = resolve_device(device)
        self.num_heads = int(num_heads)
        self.negative_slope = float(negative_slope)
        self.dropout = float(dropout)
        self.compute_dtype = compute_dtype
        self.remat = bool(remat)
        self.layers = _attention_stack(
            type(self).conv_cls, in_feats, hidden_feats, out_feats,
            num_heads, num_layers, negative_slope, generator,
            compute_dtype_of(compute_dtype))
        self.to(device)

    def forward(self, blocks: Sequence[FanoutBlock], x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` draws the dropout masks (on ``x``'s device); it
        is read only in ``train()`` mode with a nonzero rate."""
        if len(blocks) != len(self.layers):
            raise ValueError(f"{len(self.layers)} layers need as many "
                             f"blocks, got {len(blocks)}")
        h = x
        for i, (layer, blk) in enumerate(zip(self.layers, blocks)):
            h = call_layer(layer, blk, h, self.remat)
            if i < len(self.layers) - 1:
                h = F.elu(h)
                if self.training and self.dropout > 0:
                    h = drop(h, self.dropout, generator)
        return h.float()


class DistGATv2(DistGAT):
    """:class:`DistGAT` with ``FanoutGATv2Conv`` layers (dynamic
    attention); parameter subtrees ``FanoutGATv2Conv_<i>``."""

    conv_cls = FanoutGATv2Conv
    flax_prefix = "FanoutGATv2Conv"


class GAT(nn.Module):
    """Full-graph GAT over a ``DeviceGraph`` (the JAX ``GAT``):
    ``num_layers - 1`` ``GATConv`` layers of ``num_heads`` concatenated
    heads with ELU, then one averaged head of ``num_classes``."""

    flax_prefix = "GATConv"

    def __init__(self, in_feats: int, hidden_feats: int, num_classes: int,
                 num_heads: int = 4, num_layers: int = 2,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.layers = _attention_stack(GATConv, in_feats, hidden_feats,
                                       num_classes, num_heads, num_layers,
                                       0.2, generator)
        self.to(device)

    def forward(self, g: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, layer in enumerate(self.layers):
            h = layer(g, h)
            if i < len(self.layers) - 1:
                h = F.elu(h)
        return h


def gat_layer(model: DistGAT, i: int, g: Graph, h: torch.Tensor
              ) -> torch.Tensor:
    """Layer ``i`` of layer-wise inference over every in-edge of ``g``
    with the sampled layer's weights, in its own form (GAT or GATv2),
    ELU after every layer but the last. Exact for a node whose in-edges
    are all in ``g`` (a partition's core node)."""
    layer = model.layers[i]
    leaky = layer.act
    if isinstance(layer, FanoutGATv2Conv):
        feat, fd, attn = gatv2_projection_raw(layer, h)

        def logits_of(u, v):
            return torch.einsum("ehd,hd->eh", leaky(feat[u] + fd[v]),
                                attn[0])
    else:
        feat, el, er = gat_projection_raw(layer, h)

        def logits_of(u, v):
            return leaky(el[u] + er[v])
    out = sparse_edge_attention(g, feat, logits_of, layer.concat_heads)
    return F.elu(out) if i < len(model.layers) - 1 else out


def gat_inference(model: DistGAT, g: Graph, x: torch.Tensor
                  ) -> torch.Tensor:
    """Layer-wise full-graph inference with a ``DistGAT`` or
    ``DistGATv2``'s weights (the JAX package's ``gat_inference`` and
    ``gatv2_inference``): each layer attends over every in-neighbor of
    every node (:func:`gat_layer`), no dropout. ``x`` is ``[num_nodes,
    in_feats]`` on the model's device; returns float32 logits for every
    node."""
    h = x.float()
    for i in range(len(model.layers)):
        h = gat_layer(model, i, g, h)
    return h


# the layers carry their form, so one function serves both stacks
gatv2_inference = gat_inference


def bucket_by_degree(g: Graph, dst_ids, growth: float = 4.0,
                     max_batch: int = 4096) -> List[np.ndarray]:
    """Split ``dst_ids`` into degree-homogeneous buckets for
    :func:`gat_hub_attention`, whose rows pad to the batch's largest
    degree: each bucket holds nodes whose in-degree lies within one
    ``growth``-factor band (low to high), at most ``max_batch`` of them,
    so a bucket's padded work is within ``growth`` times its own."""
    if growth < 1.0:
        raise ValueError(f"growth must be >= 1, got {growth}")
    indptr = g.csc()[0]
    dst_ids = np.asarray(dst_ids, dtype=np.int64)
    degs = np.maximum(
        (indptr[dst_ids + 1] - indptr[dst_ids]).astype(np.int64), 1)
    order = np.argsort(degs, kind="stable")
    sdegs = degs[order]
    buckets, start = [], 0
    while start < len(order):
        end = int(np.searchsorted(sdegs, sdegs[start] * growth,
                                  side="right"))
        for lo in range(start, end, max_batch):
            buckets.append(dst_ids[order[lo: min(lo + max_batch, end)]])
        start = end
    return buckets


def _hub_projection(layer, x: torch.Tensor):
    """``(feat [N, H, D], el [N, H], er [N, H])`` of a ``GATConv`` or
    ``FanoutGATConv``, or of its flax-layout params (``fc/kernel``,
    ``attn_l``, ``attn_r``)."""
    if isinstance(layer, nn.Module):
        return gat_projection_raw(layer, x)

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=x.device)

    al, ar = t(layer["attn_l"]), t(layer["attn_r"])
    H, D = al.shape[-2], al.shape[-1]
    feat = (x @ t(layer["fc"]["kernel"])).view(-1, H, D)
    return feat, (feat * al).sum(-1), (feat * ar).sum(-1)


@torch.no_grad()
def gat_hub_attention(layer, g: Graph, x: torch.Tensor, dst_ids,
                      num_shards: int, negative_slope: float = 0.2,
                      concat_heads: bool = True, rank: int = 0,
                      world: int = 1) -> torch.Tensor:
    """One GAT layer's output for ``dst_ids`` over their whole
    in-neighborhoods in ``g``, with the neighbor axis cut into
    ``num_shards`` shards: the index lists are padded to a multiple of
    ``num_shards`` and each shard gathers only its ``[B, S/n]`` slice of
    the node table (``gathered_gat_attention``), so no ``[B, S, H, D]``
    tensor and no ``[B, S]`` score matrix exists in one piece. The same
    attention as ``GATConv``'s edge softmax. ``layer`` is a
    ``GATConv``/``FanoutGATConv`` or its flax-layout params; ``x`` ``[N,
    in]`` on the device. In a group, this process's shards' columns.
    Batch nodes of similar degree (:func:`bucket_by_degree`): every row
    pads to the batch's largest degree."""
    from dgl_operator_tpu_torch.parallel.ring_attention import \
        gathered_gat_attention
    indptr, indices, _ = g.csc()
    dst_ids = np.asarray(dst_ids, dtype=np.int64)
    degs = indptr[dst_ids + 1] - indptr[dst_ids]
    S = max(int(degs.max()) if len(degs) else 1, 1)
    S = -(-S // num_shards) * num_shards
    B = len(dst_ids)
    nbr = np.zeros((B, S), np.int32)
    mask = np.zeros((B, S), np.float32)
    for i, d in enumerate(dst_ids):
        lo, hi = int(indptr[d]), int(indptr[d + 1])
        nbr[i, :hi - lo] = indices[lo:hi]
        mask[i, :hi - lo] = 1.0
    cols = slice(rank * S // world, (rank + 1) * S // world)
    feat, el, er = _hub_projection(layer, x.float())
    dev = x.device
    out = gathered_gat_attention(
        el, er[torch.from_numpy(dst_ids).to(dev)], feat,
        torch.from_numpy(nbr[:, cols]).to(dev),
        torch.from_numpy(mask[:, cols]).to(dev), num_shards,
        negative_slope, rank, world)
    return out.reshape(B, -1) if concat_heads else out.mean(1)
