"""Graph convolution layers (``torch.nn``).

The sampled path's layers consume a ``FanoutBlock``:
``FanoutSAGEConv`` aggregates with the dense masked reductions of
``ops/fanout.py``; ``FanoutGATConv`` and ``FanoutGATv2Conv`` gather
their neighbours' rows with ``ops/gather.py::gather_rows`` over the
block's per-slot plan (``ops/scatter.py::slot_plan``), so their
backward is the port's deterministic ``scatter_add_rows``, and softmax
over the fanout axis. The full-graph layers (``GraphConv``,
``GATConv``, ``GATv2Conv``, ``SAGEConv``, ``WeightedSAGEConv``) consume
a ``DeviceGraph``: they gather its edges' ends with ``gather_rows`` over
the graph's transpose plans (``ops/sddmm.py``) and reduce with the
segment ops of ``ops/segment.py`` and ``gspmm``, so their backward is
``scatter_add_rows`` too; :func:`sparse_edge_attention` is
the attention's full-graph inference over a ``Graph``'s sparse
adjacency, which holds no ``[E, H * D]`` message table.

The sampled layers take a compute ``dtype`` (None: float32; bfloat16:
mixed precision, the JAX layers' ``dtype``): the parameters stay
float32 and are cast for the compute, ``fanout_agg`` and ``gather_rows``
move bfloat16 rows (the aggregation sums in float32), the GEMMs run in
bfloat16, and the attention logits and their softmax stay float32.

Submodule and parameter names follow the flax layers' (``self``,
``neigh``, ``pool``; ``fc``, ``attn_l``, ``attn_r``; ``fc_src``,
``fc_dst``, ``attn``; ``weight``, ``bias``), so weights map one to one,
and a sampled layer's weights drive its full-graph twin.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.graph.blocks import FanoutBlock
from dgl_operator_tpu_torch.graph.graph import (DeviceGraph, EdgeTypes, Graph,
                                                sparse_csr)
from dgl_operator_tpu_torch.ops import fanout
from dgl_operator_tpu_torch.ops.gather import gather_rows
from dgl_operator_tpu_torch.ops.sddmm import gather_dst, gather_src
from dgl_operator_tpu_torch.ops.segment import (segment_max, segment_mean,
                                                segment_softmax, segment_sum)
from dgl_operator_tpu_torch.ops.spmm import gspmm

AGGREGATORS = ("mean", "sum", "pool")


def init_linear_(layer: nn.Linear, generator: torch.Generator) -> None:
    """Variance-1/fan_in uniform weights (the variance of flax's
    ``lecun_normal`` default) and zero bias, drawn from ``generator``."""
    bound = math.sqrt(3.0 / layer.in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if layer.bias is not None:
            layer.bias.zero_()


def glorot_(param: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``glorot_uniform`` bound for a parameter ``[..., I, O]``
    (an ``[1, H, D]`` attention vector, a ``[B, I, O]`` basis, an
    ``[N, D]`` table): fan in ``I`` and fan out ``O``, each times the
    product of the leading axes (the receptive field), drawn from
    ``generator``."""
    field = math.prod(param.shape[:-2])
    bound = math.sqrt(6.0 / ((param.shape[-2] + param.shape[-1]) * field))
    with torch.no_grad():
        param.uniform_(-bound, bound, generator=generator)


def _materialize(module: nn.Module, device: DeviceLike,
                 generator: Optional[torch.Generator]) -> None:
    """Materialize ``module``'s meta parameters on the CPU, draw them from
    ``generator`` (a fresh generator seeded 0 when None): each Linear by
    :func:`init_linear_`, then each parameter of its own, in
    registration order, by :func:`glorot_` (an attention vector) or
    zeros (a bias vector); then move to ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    module.to_empty(device="cpu")
    for child in module.children():
        init_linear_(child, generator)
    for param in module.parameters(recurse=False):
        if param.dim() == 1:
            with torch.no_grad():
                param.zero_()
        else:
            glorot_(param, generator)
    module.to(device)


class _SAGE(nn.Module):
    """The parameters of a GraphSAGE layer, sampled or full-graph:
    ``pool`` (``in -> in``, the pool aggregator only), ``self`` and the
    bias-free ``neigh`` (``in -> out``). They are drawn on the CPU from
    ``generator`` (a fresh generator seeded 0 when none is given), so a
    seed gives the same weights on every device, then moved to
    ``device``."""

    def __init__(self, in_feats: int, out_feats: int,
                 aggregator: str = "mean", device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if aggregator not in AGGREGATORS:
            raise ValueError(f"aggregator must be one of {AGGREGATORS}, "
                             f"got {aggregator!r}")
        self.aggregator = aggregator
        meta = torch.device("meta")
        if aggregator == "pool":
            self.pool = nn.Linear(in_feats, in_feats, device=meta)
        self.self = nn.Linear(in_feats, out_feats, device=meta)
        self.neigh = nn.Linear(in_feats, out_feats, bias=False, device=meta)
        _materialize(self, device, generator)


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (flax's ``Dense(dtype=...)``):
    the input and the float32 weight and bias cast to it; ``layer(x)``
    itself when ``dtype`` is None."""
    if dtype is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class FanoutSAGEConv(_SAGE):
    """GraphSAGE layer on a sampled ``FanoutBlock``:
    ``self(h_dst) + neigh(agg)`` with ``h_dst = h_src[:num_dst]`` (the
    dst nodes are a prefix of the src nodes). ``dtype`` is the compute
    dtype (None: float32)."""

    def __init__(self, in_feats: int, out_feats: int,
                 aggregator: str = "mean", device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_feats, out_feats, aggregator, device, generator)
        self.dtype = dtype

    def forward(self, block: FanoutBlock, h_src: torch.Tensor
                ) -> torch.Tensor:
        dt = self.dtype
        if dt is not None:
            h_src = h_src.to(dt)
        h_dst = h_src[: block.num_dst]
        if self.aggregator == "mean":
            agg = fanout.fanout_mean(block, h_src)
        elif self.aggregator == "sum":
            agg = fanout.fanout_sum(block, h_src)
        else:
            agg = fanout.fanout_max(block,
                                    torch.relu(dense(self.pool, h_src, dt)))
        if dt is None:
            return self.self(h_dst) + self.neigh(agg)
        return dense(self.self, h_dst, dt) + dense(self.neigh, agg.to(dt),
                                                   dt)


# ----------------------------------------------------------------------
# Graph attention


def masked_fanout_softmax(logits: torch.Tensor, mask: torch.Tensor
                          ) -> torch.Tensor:
    """Softmax of ``logits`` ``[nd, F, H]`` over the fanout axis, over
    the valid slots (``mask > 0``); a masked slot gets 0, and so does
    every slot of a row with no valid slot (JAX zeroes the NaN there;
    here none is made, forward or backward). The max shift carries no
    gradient, as in ``jax.nn.softmax``."""
    valid = (mask > 0).unsqueeze(-1)
    logits = logits.masked_fill(~valid, float("-inf"))
    top = logits.detach().amax(1, keepdim=True)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    ex = torch.exp(logits - top)
    den = ex.sum(1, keepdim=True)
    return ex / den.masked_fill(den == 0, 1.0)


def _heads_out(out: torch.Tensor, concat: bool) -> torch.Tensor:
    """``[n, H, D]`` per-head outputs concatenated or averaged."""
    return out.reshape(out.shape[0], -1) if concat else out.mean(1)


class _Attention(nn.Module):
    """The parameters an attention layer shares with its full-graph
    twin: ``linears`` (names of bias-free Linears ``in -> H * D``) and
    ``vectors`` (names of ``[1, H, D]`` parameters), drawn on the CPU
    from ``generator`` and moved to ``device``. Its LeakyReLU is the
    module ``act``, so a forward hook can read or replace it."""

    linears: Tuple[str, ...] = ()
    vectors: Tuple[str, ...] = ()

    def __init__(self, in_feats: int, out_feats: int, num_heads: int = 1,
                 negative_slope: float = 0.2, concat_heads: bool = True,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        # the sampled layers' compute dtype (the full-graph layers run
        # in float32)
        self.dtype = dtype
        self.num_heads = int(num_heads)
        self.out_feats = int(out_feats)
        self.negative_slope = float(negative_slope)
        self.concat_heads = bool(concat_heads)
        meta = torch.device("meta")
        for name in self.linears:
            setattr(self, name, nn.Linear(in_feats, num_heads * out_feats,
                                          bias=False, device=meta))
        for name in self.vectors:
            setattr(self, name, nn.Parameter(torch.empty(
                1, num_heads, out_feats, device=meta)))
        _materialize(self, device, generator)
        self.act = nn.LeakyReLU(self.negative_slope)


def gat_projection_raw(layer: nn.Module, h: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A GAT layer's (``fc``, ``attn_l``, ``attn_r``) projections of
    ``h``: ``(feat [N, H, D], el [N, H], er [N, H])``."""
    al, ar = layer.attn_l, layer.attn_r
    feat = layer.fc(h).view(h.shape[0], al.shape[-2], al.shape[-1])
    return feat, (feat * al).sum(-1), (feat * ar).sum(-1)


def gatv2_projection_raw(layer: nn.Module, h: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """A GATv2 layer's (``fc_src``, ``fc_dst``, ``attn``) projections of
    ``h``: ``(fs [N, H, D], fd [N, H, D], attn [1, H, D])``."""
    attn = layer.attn
    shape = (h.shape[0], attn.shape[-2], attn.shape[-1])
    return (layer.fc_src(h).view(shape), layer.fc_dst(h).view(shape),
            attn)


def edge_softmax_aggregate(g: DeviceGraph, logits: torch.Tensor,
                           feat_src: torch.Tensor, concat: bool
                           ) -> torch.Tensor:
    """The full-graph attention's tail: per-destination softmax of
    ``logits`` ``[E, H]`` over the valid edges (a padded edge is masked
    to ``-inf`` and points at the spare segment), then the α-weighted
    sum of ``feat_src[src]`` ``[E, H, D]`` messages; a node with no
    in-edge gets 0. The gathers and sums run over the graph's plans."""
    n = g.num_nodes
    logits = logits.masked_fill((g.edge_mask <= 0).unsqueeze(-1),
                                float("-inf"))
    alpha = segment_softmax(logits, g.dst, n + 1, g.dst_plan)
    msg = gather_src(g, feat_src) * alpha.unsqueeze(-1)
    return _heads_out(segment_sum(msg, g.dst, n + 1, g.dst_plan)[:n],
                      concat)


class GATConv(_Attention):
    """Graph attention over a ``DeviceGraph``: LeakyReLU of ``el[u] +
    er[v]`` logits, per-destination softmax, α-weighted sum of the
    projected sources; heads concatenated or averaged."""

    linears = ("fc",)
    vectors = ("attn_l", "attn_r")

    def forward(self, g: DeviceGraph, h: torch.Tensor) -> torch.Tensor:
        feat, el, er = gat_projection_raw(self, h)
        logits = self.act(gather_src(g, el) + gather_dst(g, er))
        return edge_softmax_aggregate(g, logits, feat, self.concat_heads)


class GATv2Conv(_Attention):
    """GATv2 (dynamic attention) over a ``DeviceGraph``: the attention
    vector applies after the LeakyReLU of ``fs[u] + fd[v]``, separate
    source and destination projections."""

    linears = ("fc_src", "fc_dst")
    vectors = ("attn",)

    def forward(self, g: DeviceGraph, h: torch.Tensor) -> torch.Tensor:
        fs, fd, attn = gatv2_projection_raw(self, h)
        e = self.act(gather_src(g, fs) + gather_dst(g, fd))
        return edge_softmax_aggregate(g, (e * attn).sum(-1), fs,
                                      self.concat_heads)


class FanoutGATConv(_Attention):
    """GAT on a sampled ``FanoutBlock``: the masked softmax over the
    fanout axis of LeakyReLU(``el[nbr] + er``), then the α-weighted sum
    of the neighbours. Two exact reassociations keep the layer's
    fanout-sized terms narrow (the JAX layer's): the source logits are
    ``x @ cl`` with ``cl = sum_D(W ⊙ a_l)`` (no source projection), and
    the α-weighted sum runs over the raw neighbour rows, projected once
    per head. Both neighbour gathers (``el[nbr]``, ``x[nbr]``) go
    through ``gather_rows`` with the block's per-slot plan. Parameters
    as :class:`GATConv`'s, so its weights drive full-graph inference.
    In bfloat16 (``dtype``) ``cl`` is summed from the float32 weights,
    the logits ``el`` and ``er`` are summed in float32 and the softmax
    runs in float32; α, the gathered rows and the two products are
    bfloat16."""

    linears = ("fc",)
    vectors = ("attn_l", "attn_r")

    def forward(self, block: FanoutBlock, h_src: torch.Tensor
                ) -> torch.Tensor:
        H, D = self.num_heads, self.out_feats
        b = block.to(h_src.device)
        nd, f = b.nbr.shape
        dt = self.dtype
        x = (h_src if dt is None else h_src.to(dt)).contiguous()
        k3 = self.fc.weight.t().reshape(-1, H, D)            # [Din, H, D]
        feat_dst = dense(self.fc, x[:nd], dt).view(nd, H, D)
        cl = (k3 * self.attn_l[0]).sum(-1)                    # [Din, H]
        if dt is None:
            el = x @ cl                                       # [N, H]
            er = (feat_dst * self.attn_r).sum(-1)             # [nd, H]
        else:
            el = x.float() @ cl
            er = (feat_dst * self.attn_r.to(dt)).float().sum(-1)
            k3 = k3.to(dt)
        idx = b.nbr.view(-1)
        el_n = gather_rows(el, idx, b.plan).view(nd, f, H)
        alpha = masked_fanout_softmax(
            self.act(el_n + er.unsqueeze(1)), b.mask)        # [nd, F, H]
        if dt is not None:
            alpha = alpha.to(dt)
        g = gather_rows(x, idx, b.plan).view(nd, f, -1)       # [nd, F, Din]
        z = torch.bmm(alpha.transpose(1, 2), g)               # [nd, H, Din]
        out = torch.bmm(z.transpose(0, 1), k3.transpose(0, 1))  # [H, nd, D]
        return _heads_out(out.transpose(0, 1), self.concat_heads)


class FanoutGATv2Conv(_Attention):
    """GATv2 on a sampled ``FanoutBlock``, the parameters of
    :class:`GATv2Conv`. The score is not linear in the projections, so
    the ``[nd, F, H, D]`` combine of the gathered ``fs[nbr]`` (one
    ``gather_rows`` over the block's per-slot plan) is the model's. In
    bfloat16 (``dtype``) the projections, the combine and the
    α-weighted sum are bfloat16; the logits are summed and the softmax
    taken in float32."""

    linears = ("fc_src", "fc_dst")
    vectors = ("attn",)

    def forward(self, block: FanoutBlock, h_src: torch.Tensor
                ) -> torch.Tensor:
        H, D = self.num_heads, self.out_feats
        b = block.to(h_src.device)
        nd, f = b.nbr.shape
        dt = self.dtype
        x = (h_src if dt is None else h_src.to(dt)).contiguous()
        fs = dense(self.fc_src, x, dt)                        # [N, H * D]
        fd = dense(self.fc_dst, x[:nd], dt).view(nd, 1, H, D)
        fs_n = gather_rows(fs, b.nbr.view(-1), b.plan).view(nd, f, H, D)
        e = self.act(fs_n + fd)
        if dt is None:
            logits = torch.einsum("nfhd,hd->nfh", e, self.attn[0])
        else:
            logits = torch.einsum("nfhd,hd->nfh", e.float(),
                                  self.attn[0].to(dt).float())
        alpha = masked_fanout_softmax(logits, b.mask)         # [nd, F, H]
        if dt is not None:
            alpha = alpha.to(dt)
        out = torch.einsum("nfh,nfhd->nhd", alpha, fs_n)
        return _heads_out(out, self.concat_heads)


# elements of a GATv2 [C, H, D] combine at a time in full-graph
# inference (256 MB of float32)
ATTENTION_CHUNK_ELEMS = 1 << 26


def sparse_edge_attention(g: Graph, feat_src: torch.Tensor,
                          logits_of: Callable[[torch.Tensor, torch.Tensor],
                                              torch.Tensor],
                          concat: bool) -> torch.Tensor:
    """Full-graph attention inference over ``g``'s in-edges without an
    ``[E, H * D]`` message table: the edges are the sparse adjacency's
    entries (``Graph.adjacency``: repeated edges merged, with counts),
    ``logits_of(u, v)`` gives the ``[C, H]`` logits of a chunk of them
    (chunks of at most ``ATTENTION_CHUNK_ELEMS`` / (H * D) entries, so a
    GATv2 combine stays bounded), and each head's weighted sum is one
    sparse-CSR product whose values are ``count * exp(logit - max)``,
    with a column of ones beside the features for the denominator.
    Exactly the segment-softmax form's value (the denominator clamped at
    1e-16, 0 for a node with no in-edge), summed in another order.
    ``feat_src`` is ``[N, H, D]``; returns ``[N, H * D]`` or, unless
    ``concat``, the heads' mean ``[N, D]``."""
    n, H, D = feat_src.shape
    dev = feat_src.device
    adj = g.adjacency(dev)
    crow, col, cnt = adj.crow_indices(), adj.col_indices(), adj.values()
    rows = torch.repeat_interleave(
        torch.arange(n, device=dev), (crow[1:] - crow[:-1]).long())
    step = max(1, ATTENTION_CHUNK_ELEMS // (H * D))
    cols = col.long()
    logits = torch.cat([logits_of(cols[s:s + step], rows[s:s + step])
                        for s in range(0, cols.shape[0], step)]
                       or [feat_src.new_zeros(0, H)])
    top = segment_max(logits, rows, n)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(logits - top[rows]) * cnt.unsqueeze(1)
    ones = feat_src.new_ones(n, 1)
    heads = []
    for h in range(H):
        a = sparse_csr(crow, col, w[:, h].contiguous(), n)
        num = a @ torch.cat([feat_src[:, h], ones], 1)        # [N, D + 1]
        heads.append(num[:, :D] / num[:, D:].clamp_min(1e-16))
    return _heads_out(torch.stack(heads, 1), concat)


class GraphConv(nn.Module):
    """Kipf-Welling GCN layer over a ``DeviceGraph``: ``D^-1/2 A D^-1/2
    H W`` (norm ``both``), ``D^-1 A H W`` (``right``) or ``A H W``
    (``none``), degrees the graph's counts of valid edges; it projects
    first when that shrinks the message width (``gspmm``'s sum over the
    graph's plans). ``weight`` is a bias-free Linear, ``bias`` a vector
    (the flax layer's names)."""

    NORMS = ("both", "right", "none")

    def __init__(self, in_feats: int, out_feats: int, norm: str = "both",
                 use_bias: bool = True, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if norm not in self.NORMS:
            raise ValueError(f"norm must be one of {self.NORMS}, got "
                             f"{norm!r}")
        self.norm = norm
        self.out_feats = int(out_feats)
        meta = torch.device("meta")
        self.weight = nn.Linear(in_feats, out_feats, bias=False,
                                device=meta)
        self.bias = (nn.Parameter(torch.empty(out_feats, device=meta))
                     if use_bias else None)
        _materialize(self, device, generator)

    def forward(self, g: DeviceGraph, h: torch.Tensor) -> torch.Tensor:
        in_deg, out_deg = g.in_deg.float(), g.out_deg.float()
        if self.norm == "both":
            h = h * out_deg.clamp_min(1.0).pow(-0.5).unsqueeze(1)
        if h.shape[-1] > self.out_feats:
            agg = gspmm(g, "copy_u", "sum", self.weight(h))
        else:
            agg = self.weight(gspmm(g, "copy_u", "sum", h))
        if self.norm != "none":
            p = -0.5 if self.norm == "both" else -1.0
            agg = agg * in_deg.clamp_min(1.0).pow(p).unsqueeze(1)
        return agg if self.bias is None else agg + self.bias


class SAGEConv(_SAGE):
    """GraphSAGE layer over a ``DeviceGraph`` (the flax ``SAGEConv``):
    ``self(h) + neigh(agg)``, ``agg`` the mean or sum of the in-neighbours'
    rows, or with ``pool`` the max of ``relu(pool(h))`` over them
    (``gspmm`` over the graph's plans)."""

    def forward(self, g: DeviceGraph, h: torch.Tensor) -> torch.Tensor:
        if self.aggregator == "pool":
            agg = gspmm(g, "copy_u", "max", torch.relu(self.pool(h)))
        else:
            agg = gspmm(g, "copy_u", self.aggregator, h)
        return self.self(h) + self.neigh(agg)


class WeightedSAGEConv(nn.Module):
    """SAGE with a scalar weight per edge (the flax
    ``WeightedSAGEConv``): ``self(h) + neigh(mean of h[u] * w_uv)``,
    ``w`` ``[E, 1]`` in the graph's edge order."""

    def __init__(self, in_feats: int, out_feats: int,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        meta = torch.device("meta")
        self.self = nn.Linear(in_feats, out_feats, device=meta)
        self.neigh = nn.Linear(in_feats, out_feats, bias=False, device=meta)
        _materialize(self, device, generator)

    def forward(self, g: DeviceGraph, h: torch.Tensor, ew: torch.Tensor
                ) -> torch.Tensor:
        agg = gspmm(g, "u_mul_e", "mean", h, ew)
        return self.self(h) + self.neigh(agg)


class GINConv(nn.Module):
    """Graph isomorphism layer over a ``DeviceGraph`` (the flax
    ``GINConv``): ``mlp((1 + eps) * h + sum of the in-neighbours' rows)``
    (``gspmm``'s sum over the graph's plans), ``eps`` a learned scalar
    (0-d, starting at 0, on the CPU until the owning model moves it).
    ``mlp`` is the caller's module."""

    def __init__(self, mlp: nn.Module):
        super().__init__()
        self.mlp = mlp
        self.eps = nn.Parameter(torch.zeros(()))

    def forward(self, g: DeviceGraph, h: torch.Tensor) -> torch.Tensor:
        agg = gspmm(g, "copy_u", "sum", h)
        return self.mlp((1.0 + self.eps) * h + agg)


# elements of a table-form RelGraphConv's [C, I * O] per-edge weights at
# a time (256 MB of float32)
REL_CHUNK_ELEMS = 1 << 26


class RelGraphConv(nn.Module):
    """Relational GCN layer over a ``DeviceGraph`` (the flax
    ``RelGraphConv``): each edge's message is ``h[u] @ W[r]``, ``r`` the
    edge's type, mean-aggregated per destination over the graph's plans,
    plus ``loop(h)`` (a bias-free Linear).

    With ``num_bases`` > 0, ``W[r] = sum_b coef[r, b] * basis[b]``; the
    layer computes the same sum without the JAX layer's ``[E, I, O]``
    table: ``HB = h @ basis`` (``[N, B * O]``), its rows gathered at the
    sources (``gather_rows`` over ``g.src_plan``), the coefficients at
    the edge types (``gather_rows`` over ``EdgeTypes.plan``), combined
    over ``B`` per edge. With ``num_bases`` = 0, ``W = basis`` ``[R, I,
    O]`` and each edge's ``[I, O]`` weight is gathered by type, in runs
    of edges of at most ``REL_CHUNK_ELEMS`` elements, each over its own
    plan (``EdgeTypes.chunks``). Both are the JAX layer's function in
    another order of sums. ``basis`` and ``coef`` are drawn by flax's
    ``glorot_uniform`` (the basis' fans taken times ``B``)."""

    def __init__(self, in_feats: int, out_feats: int, num_rels: int,
                 num_bases: int = 0, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_rels = int(num_rels)
        self.num_bases = int(num_bases)
        self.out_feats = int(out_feats)
        bases = self.num_bases if self.num_bases > 0 else self.num_rels
        meta = torch.device("meta")
        self.basis = nn.Parameter(torch.empty(bases, in_feats, out_feats,
                                              device=meta))
        self.coef = (nn.Parameter(torch.empty(self.num_rels, bases,
                                              device=meta))
                     if self.num_bases > 0 else None)
        self.loop = nn.Linear(in_feats, out_feats, bias=False, device=meta)
        _materialize(self, device, generator)

    def messages(self, g: DeviceGraph, h: torch.Tensor, etypes: EdgeTypes
                 ) -> torch.Tensor:
        """``[E, O]``: each edge's ``h[src] @ W[type]``."""
        bases, i, o = self.basis.shape
        if self.num_bases > 0:
            hb = h @ self.basis.permute(1, 0, 2).reshape(i, bases * o)
            hb_e = gather_src(g, hb).view(-1, bases, o)        # [E, B, O]
            c_e = gather_rows(self.coef, etypes.ids, etypes.plan)
            return torch.bmm(c_e.unsqueeze(1), hb_e).squeeze(1)
        h_e = gather_src(g, h)                                 # [E, I]
        table = self.basis.reshape(bases, i * o)
        out = []
        for a, b, ids, plan in etypes.chunks(
                max(1, REL_CHUNK_ELEMS // max(i * o, 1))):
            w_e = gather_rows(table, ids, plan).view(b - a, i, o)
            out.append(torch.bmm(h_e[a:b].unsqueeze(1), w_e).squeeze(1))
        return torch.cat(out) if out else h.new_zeros(0, o)

    def forward(self, g: DeviceGraph, h: torch.Tensor, etypes: EdgeTypes
                ) -> torch.Tensor:
        msg = self.messages(g, h, etypes) * g.edge_mask.unsqueeze(1)
        n = g.num_nodes
        agg = segment_mean(msg, g.dst, n + 1, g.dst_plan)[:n]
        return agg + self.loop(h)
