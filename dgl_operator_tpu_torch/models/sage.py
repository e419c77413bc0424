"""GraphSAGE — the sampled stack ``DistSAGE``, its full-graph
inference, and the full-graph stacks ``GraphSAGE`` and ``WeightedSAGE``.

``DistSAGE`` is an L-layer stack of ``FanoutSAGEConv`` with ReLU and,
in ``train()`` mode, dropout between layers, consuming sampled blocks
outermost-first. :func:`sage_inference` applies the same weights layer
by layer over the whole graph with full neighborhoods (evaluation),
for every aggregator. ``GraphSAGE`` (``SAGEConv`` layers, the JAX
package's standalone model: the link predictor's encoder) and
``WeightedSAGE`` (``WeightedSAGEConv`` layers, the message-passing
example's weighted model) train over a ``DeviceGraph``.

Weights cross between the packages in the flax layout
(``{"params": {"FanoutSAGEConv_i": {"self": {"kernel", "bias"},
"neigh": {"kernel"}, "pool": {"kernel", "bias"}}}}``):
:func:`state_dict_from_flax` and :func:`state_dict_to_flax` convert.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.graph.blocks import FanoutBlock
from dgl_operator_tpu_torch.graph.graph import DeviceGraph, Graph
from dgl_operator_tpu_torch.models import flax_layout
from dgl_operator_tpu_torch.nn.conv import (FanoutSAGEConv, SAGEConv,
                                            WeightedSAGEConv)
from dgl_operator_tpu_torch.ops.spmm import gspmm


# the compute dtypes of the sampled stacks (``compute_dtype``)
COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def compute_dtype_of(name: Optional[str]) -> Optional[torch.dtype]:
    """The layers' compute dtype for a stack's ``compute_dtype``: None
    (or ``"float32"``) keeps float32, ``"bfloat16"`` is mixed
    precision."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of "
                         f"{sorted(k for k in COMPUTE_DTYPES if k)} or None, "
                         f"got {name!r}")
    return COMPUTE_DTYPES[name]


def call_layer(layer: nn.Module, blk, h: torch.Tensor,
               remat: bool) -> torch.Tensor:
    """``layer(blk, h)``; with ``remat`` and gradients on, under
    ``torch.utils.checkpoint`` (``use_reentrant=False``), so the
    layer's activations are recomputed in the backward instead of
    kept (``nn.remat`` around the JAX layer). The layer draws no random
    numbers (dropout runs between layers, from an explicit generator),
    so no RNG state is stashed: the recompute is the forward, also
    inside a captured CUDA graph, where reading the RNG state is not
    allowed."""
    if remat and torch.is_grad_enabled():
        return checkpoint(layer, blk, h, use_reentrant=False,
                          preserve_rng_state=False)
    return layer(blk, h)


def dropout(h: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Zero each element with probability ``p`` and scale the kept ones
    by ``1 / (1 - p)`` (flax's ``nn.Dropout``); the keep mask is drawn
    with ``bernoulli_`` from ``generator`` (the device's default
    generator when None)."""
    keep = torch.empty_like(h).bernoulli_(1.0 - p, generator=generator)
    return h * keep / (1.0 - p)


class DistSAGE(nn.Module):
    """Sampled-path SAGE stack; ``forward`` returns float32 logits for
    the seed rows of the innermost block. ``dropout`` is the rate
    applied after each inner ReLU in ``train()`` mode.
    ``compute_dtype="bfloat16"`` runs the layers in bfloat16 with
    float32 parameters (:func:`compute_dtype_of`); ``remat`` recomputes
    each layer in the backward (:func:`call_layer`). Neither changes
    the parameters or their names.

    ``slot_plans`` tells the trainers which blocks' backward needs a
    transpose plan on the card. For the mean and sum (False): every
    block but the first (its source rows are the input features), of
    the rows (``fanout_agg``'s backward). For the pool (True): every
    block, per slot (``fanout_max`` gathers its slots with
    ``gather_rows``, and block 0's rows are ``relu(pool(x))``, which
    carries a gradient into ``pool``)."""

    flax_prefix = "FanoutSAGEConv"

    def __init__(self, in_feats: int, hidden_feats: int, out_feats: int,
                 num_layers: int = 2, aggregator: str = "mean",
                 dropout: float = 0.5, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[str] = None, remat: bool = False):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.aggregator = aggregator
        self.slot_plans = aggregator == "pool"
        self.dropout = float(dropout)
        self.compute_dtype = compute_dtype
        self.remat = bool(remat)
        dtype = compute_dtype_of(compute_dtype)
        dims = [in_feats] + [hidden_feats] * (num_layers - 1) + [out_feats]
        self.layers = nn.ModuleList(
            FanoutSAGEConv(dims[i], dims[i + 1], aggregator, device="cpu",
                           generator=generator, dtype=dtype)
            for i in range(num_layers))
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
                h = torch.relu(h)
                if self.training and self.dropout > 0:
                    h = dropout(h, self.dropout, generator)
        return h.float()


def sage_inference(model: DistSAGE, g: Graph, x: torch.Tensor
                   ) -> torch.Tensor:
    """Layer-wise full-graph inference with the sampled model's weights
    (the JAX package's ``sage_inference``): each layer aggregates over
    every in-neighbor of every node (``gspmm``) instead of a sampled
    fanout, then applies ``self(h) + neigh(agg)``, ReLU between
    layers, no dropout. ``x`` is ``[num_nodes, in_feats]`` on the
    model's device; returns float32 logits for every node. The pool
    aggregator takes the max of ``relu(pool(h))`` over every
    in-neighbour, destination chunk by destination chunk (``gspmm`` over
    a host ``Graph``), so no ``[E, D]`` table is built."""
    h = x.float()
    for i in range(len(model.layers)):
        h = sage_layer(model, i, g, h)
    return h


def sage_layer(model: DistSAGE, i: int, g: Graph, h: torch.Tensor
               ) -> torch.Tensor:
    """Layer ``i`` of layer-wise inference over every in-edge of ``g``:
    ``self(h) + neigh(gspmm(h))``, ReLU after every layer but the last.
    Exact for a node whose in-edges are all in ``g`` (a partition's core
    node)."""
    layer = model.layers[i]
    if model.aggregator == "pool":
        agg = gspmm(g, "copy_u", "max", torch.relu(layer.pool(h)))
    else:
        agg = gspmm(g, "copy_u", model.aggregator, h)
    out = layer.self(h) + layer.neigh(agg)
    return torch.relu(out) if i < len(model.layers) - 1 else out


class _FullGraphStack(nn.Module):
    """An L-layer stack of full-graph layers ``layer(in, out)`` with
    ReLU between them, drawn on the CPU from ``generator`` (a fresh
    generator seeded 0 when None) and moved to ``device``."""

    def __init__(self, make, in_feats: int, hidden_feats: int,
                 out_feats: int, num_layers: int, device: DeviceLike,
                 generator: Optional[torch.Generator]):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dims = [in_feats] + [hidden_feats] * (num_layers - 1) + [out_feats]
        self.layers = nn.ModuleList(
            make(dims[i], dims[i + 1], generator)
            for i in range(num_layers))
        self.to(device)

    def _stack(self, g: DeviceGraph, h: torch.Tensor, *extra):
        for i, layer in enumerate(self.layers):
            h = layer(g, h, *extra)
            if i < len(self.layers) - 1:
                h = torch.relu(h)
        return h


class GraphSAGE(_FullGraphStack):
    """The full-graph GraphSAGE stack (the JAX package's ``GraphSAGE``):
    ``SAGEConv`` layers ``in -> hidden -> ... -> out`` with ``aggregator``
    (mean, sum or pool), ReLU between layers, over a ``DeviceGraph``.
    Nested in ``LinkPredModel`` its flax name is ``GraphSAGE_0``."""

    flax_prefix = "SAGEConv"
    flax_name = "GraphSAGE_0"

    def __init__(self, in_feats: int, hidden_feats: int, out_feats: int,
                 num_layers: int = 2, aggregator: str = "mean",
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(
            lambda i, o, gen: SAGEConv(i, o, aggregator, device="cpu",
                                       generator=gen),
            in_feats, hidden_feats, out_feats, num_layers, device, generator)
        self.aggregator = aggregator

    def forward(self, g: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
        return self._stack(g, x)


class WeightedSAGE(_FullGraphStack):
    """A stack of ``WeightedSAGEConv`` layers with ReLU between them
    (the message-passing example's weighted model): every layer scales
    each message by its edge's weight ``ew`` ``[E, 1]`` (ones when None,
    as the example passes) before the mean."""

    flax_prefix = "WeightedSAGEConv"

    def __init__(self, in_feats: int, hidden_feats: int, out_feats: int,
                 num_layers: int = 2, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(
            lambda i, o, gen: WeightedSAGEConv(i, o, device="cpu",
                                               generator=gen),
            in_feats, hidden_feats, out_feats, num_layers, device, generator)

    def forward(self, g: DeviceGraph, x: torch.Tensor,
                ew: Optional[torch.Tensor] = None) -> torch.Tensor:
        if ew is None:
            ew = x.new_ones(g.num_edges, 1)
        return self._stack(g, x, ew)


def state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The ``DistSAGE`` state dict for a flax params tree (numpy leaves,
    with or without the top-level ``"params"`` key) of
    ``FanoutSAGEConv_<i>`` entries (``models/flax_layout.py``)."""
    return flax_layout.state_dict_from_flax(tree, DistSAGE.flax_prefix)


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The flax params tree (numpy leaves, under ``"params"``) of a
    ``DistSAGE`` state dict — the inverse of
    :func:`state_dict_from_flax`."""
    return flax_layout.state_dict_to_flax(state_dict, DistSAGE.flax_prefix)
