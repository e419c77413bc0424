"""Ring attention over a sharded neighbor (or sequence) axis.

The counterpart of the JAX package's ``parallel/ring_attention.py``:
exact softmax attention over an axis cut into ``num_shards`` blocks,
computed block by block with the flash-attention streaming recurrence
(running max, denominator and numerator in log-sum-exp form), one ring
hop a block, so no shard ever holds the whole ``[N, S]`` score matrix:
a shard's live scores are ``O(N * S / num_shards)``. A hub node's whole
in-neighborhood is the graph's long sequence (``models/gat.py::
gat_hub_attention``).

The blocks are a list in shard order. In one process every shard is
here and a hop rotates the list; in a ``torch.distributed`` group each
process holds ``num_shards / W`` consecutive blocks of the axis and a
hop sends its last block to the next rank and receives the previous
rank's (``parallel/collectives.py::send_recv``; the hop's backward sends the gradient the other way, so the ring
form differentiates through autograd in both).

- :func:`ring_dot_attention`: scaled dot product; the queries stay, the
  key and value blocks ride the ring.
- :func:`ring_gat_attention`: GAT's additive scorer ``leaky_relu(el[u]
  + er[v])`` with the neighbor terms sharded.
- :func:`gathered_gat_attention`: sharded index lists into a replicated
  node table; each shard gathers only its ``[B, S/n]`` slice through
  ``gather_rows`` and the shards combine their partial stats in
  log-sum-exp form (one max and two sums; ``all_reduce`` in a group).

Masked slots score ``-1e30`` (finite, so the max and the correction
never meet ``inf - inf``) and the probabilities are also multiplied by
the mask; a row with no valid slot gives 0, the zero-in-degree
convention of ``ops/fanout.py``. The dense forms are the parity targets
and the small-input path of :func:`make_ring_attention`'s ``auto`` mode,
whose rule (:func:`use_ring`) is the memory rule: ring when the dense
form's footprint exceeds half the card's free memory
(``torch.cuda.mem_get_info``; 4 GiB on the CPU;
``DGL_TPU_ATTN_BUDGET_BYTES`` overrides), or when a latency crossover
measured on this platform by the port's own smoke says so
(:func:`recorded_crossover`). The JAX package's record of TPU
crossovers is not read.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dgl_operator_tpu_torch.ops.gather import gather_rows
from dgl_operator_tpu_torch.parallel.collectives import send_recv

_NEG = -1e30

# where chip_smoke.py records the measured ring/dense crossover of the
# card it ran on (a build output, like the kernels)
RING_RECORD_ENV = "TPU_OPERATOR_RING_RECORD"
_RING_RECORD = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "ring_crossover.json")


def dense_attention_bytes(N: int, S: int, H: int, Dk: int, Dv: int,
                          itemsize: int = 4) -> int:
    """The dense form's live footprint on one device: K and V resident
    plus the ``[N, S, H]`` logits and probabilities. A ring shard's is
    ``1 / num_shards`` of it."""
    return N * S * H * (Dk + Dv + 2) * itemsize


def ring_record_path() -> str:
    return os.environ.get(RING_RECORD_ENV) or _RING_RECORD


def recorded_crossover(platform: Optional[str] = None) -> Optional[dict]:
    """The ring/dense latency crossover the port's smoke measured on
    ``platform`` (``{"crossover_s": S, "shape": {...}}``), or None when
    no such record exists (the memory rule alone then decides)."""
    try:
        with open(ring_record_path()) as f:
            entry = json.load(f).get("platforms", {}).get(platform or "")
    except (OSError, ValueError):
        return None
    if entry and entry.get("crossover_s") is not None:
        return {"crossover_s": entry["crossover_s"],
                "shape": entry.get("shape", {})}
    return None


def write_crossover(platform: str, crossover_s: Optional[int],
                    shape: dict, path: Optional[str] = None) -> str:
    """Record a measured crossover for ``platform`` (the smoke's writer
    of what :func:`recorded_crossover` reads), keeping other platforms'
    entries."""
    path = path or ring_record_path()
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        rec = {}
    rec.setdefault("platforms", {})[platform] = {
        "crossover_s": crossover_s, "shape": shape}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def _device_budget_bytes(device: Optional[torch.device] = None) -> int:
    """The memory the dense form may spend: ``DGL_TPU_ATTN_BUDGET_BYTES``,
    else half the card's free memory, else 4 GiB (the CPU)."""
    env = os.environ.get("DGL_TPU_ATTN_BUDGET_BYTES")
    if env:
        return int(env)
    if device is not None and device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return max(free // 2, 1)
    return 4 << 30


def use_ring(N: int, S: int, H: int, Dk: int, Dv: int, itemsize: int = 4,
             budget_bytes: Optional[int] = None,
             crossover: Optional[dict] = None,
             nshard: Optional[int] = None,
             device: Optional[torch.device] = None) -> bool:
    """``auto`` mode's rule: ring when a crossover measured on this
    platform (``crossover``, default :func:`recorded_crossover` of the
    device's type) says ring is faster at this much work (``N * S * H``
    against the record's shape, only for a record of the same shard
    count), or when the dense footprint exceeds the memory budget. Small
    inputs stay dense."""
    if crossover is None:
        crossover = recorded_crossover(
            device.type if device is not None else "cpu")
    if crossover and crossover.get("crossover_s") is not None:
        shp = crossover.get("shape", {})
        rec_shards = shp.get("shards")
        if nshard is None or rec_shards is None or rec_shards == nshard:
            work = (shp.get("N", 1) * crossover["crossover_s"]
                    * shp.get("H", 1))
            if N * S * H >= work:
                return True
    if budget_bytes is None:
        budget_bytes = _device_budget_bytes(device)
    return dense_attention_bytes(N, S, H, Dk, Dv, itemsize) > budget_bytes


class _Shift(torch.autograd.Function):
    """A group's ring hop of one block: forward to rank + 1, the
    gradient back to rank - 1."""

    @staticmethod
    def forward(ctx, x, rank: int, world: int):
        ctx.rank, ctx.world = rank, world
        return send_recv(x, rank, world, +1)

    @staticmethod
    def backward(ctx, g):
        return send_recv(g, ctx.rank, ctx.world, -1), None, None


def _hop(blocks: List[torch.Tensor], rank: int, world: int
         ) -> List[torch.Tensor]:
    """One hop: every block moves to the next shard."""
    if world == 1:
        return blocks[-1:] + blocks[:-1]
    return [_Shift.apply(blocks[-1], rank, world)] + blocks[:-1]


def _stream_block(carry, logits, mask, v):
    """One blockwise update of the streaming softmax: ``carry`` = (m
    ``[N, H]`` running max, d ``[N, H]`` denominator, o ``[N, H, D]``
    numerator); ``logits`` ``[N, S, H]``, ``mask`` ``[N, S]``, ``v``
    ``[N, S, H, D]``."""
    m, d, o = carry
    valid = mask[:, :, None] > 0
    logits = torch.where(valid, logits, logits.new_full((), _NEG))
    m_new = torch.maximum(m, logits.amax(1))
    corr = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[:, None, :]) * mask[:, :, None].to(
        logits.dtype)
    d = d * corr + p.sum(1)
    o = o * corr[..., None] + torch.einsum("nsh,nshd->nhd", p, v)
    return m_new, d, o


def _split(t: torch.Tensor, num_blocks: int) -> List[torch.Tensor]:
    if t.shape[1] % num_blocks:
        raise ValueError(f"an axis of {t.shape[1]} does not split into "
                         f"{num_blocks} blocks")
    return list(torch.chunk(t, num_blocks, 1))


def _ring_stream(score: Callable, fixed, blk, mask, v, num_shards: int,
                 rank: int = 0, world: int = 1) -> torch.Tensor:
    """The streaming recurrence over every shard's block, the blocks of
    ``(blk, mask, v)`` (this process's part of the axis, in shard order)
    rotated one hop a step; returns ``[N, H, D]``. In a group each rank
    streams its first shard's view of the ring."""
    L = num_shards // world
    blks, masks, vs = _split(blk, L), _split(mask, L), _split(v, L)
    N, H, D = v.shape[0], v.shape[2], v.shape[3]
    carry = (v.new_full((N, H), _NEG, dtype=torch.float32),
             v.new_zeros((N, H), dtype=torch.float32),
             v.new_zeros((N, H, D), dtype=torch.float32))
    carry = _stream_block(carry, score(fixed, blks[0]), masks[0], vs[0])
    for _ in range(1, num_shards):
        blks, masks, vs = (_hop(blks, rank, world),
                           _hop(masks, rank, world), _hop(vs, rank, world))
        carry = _stream_block(carry, score(fixed, blks[0]), masks[0],
                              vs[0])
    _, d, o = carry
    return o / torch.clamp_min(d, 1e-20)[..., None]


def _dot_score(q, k):
    return torch.einsum("nhd,nshd->nsh", q, k) / torch.sqrt(
        torch.tensor(float(q.shape[-1]), dtype=q.dtype, device=q.device))


def ring_dot_attention(q, k, v, mask, num_shards: int, rank: int = 0,
                       world: int = 1) -> torch.Tensor:
    """Exact softmax attention with the key axis cut into ``num_shards``
    blocks: ``q`` ``[N, H, Dk]``; ``k`` ``[N, S, H, Dk]``, ``v`` ``[N, S,
    H, Dv]`` and ``mask`` ``[N, S]`` this process's part of the axis (all
    of it in one process). Returns ``[N, H, Dv]``."""
    return _ring_stream(_dot_score, q, k, mask, v, num_shards, rank, world)


def ring_gat_attention(el, er, v, mask, num_shards: int,
                       negative_slope: float = 0.2, rank: int = 0,
                       world: int = 1) -> torch.Tensor:
    """GAT's additive-attention aggregation with the neighbor axis cut
    into ``num_shards`` blocks: ``er`` ``[N, H]`` (the destination term);
    ``el`` ``[N, S, H]``, ``v`` ``[N, S, H, D]``, ``mask`` ``[N, S]``
    (the neighbor terms). ``leaky_relu(el + er)`` then the masked softmax
    over the whole axis, as ``FanoutGATConv`` scores."""
    def score(er_, el_):
        return F.leaky_relu(el_ + er_[:, None, :], negative_slope)

    return _ring_stream(score, er, el, mask, v, num_shards, rank, world)


# ----------------------------------------------------------------------
# dense references (parity targets and the small-input path)
def _dense_tail(logits, mask, v):
    logits = torch.where(mask[:, :, None] > 0, logits,
                         logits.new_full((), _NEG))
    p = torch.softmax(logits, 1) * mask[:, :, None]
    d = torch.clamp_min(p.sum(1), 1e-20)
    return torch.einsum("nsh,nshd->nhd", p, v) / d[..., None]


def dense_dot_attention(q, k, v, mask) -> torch.Tensor:
    return _dense_tail(_dot_score(q, k), mask, v)


def dense_gat_attention(el, er, v, mask,
                        negative_slope: float = 0.2) -> torch.Tensor:
    return _dense_tail(F.leaky_relu(el + er[:, None, :], negative_slope),
                       mask, v)


def gathered_gat_attention(el_full, er_dst, feat, nbr, mask,
                           num_shards: int, negative_slope: float = 0.2,
                           rank: int = 0, world: int = 1) -> torch.Tensor:
    """GAT attention over whole neighbor lists whose index arrays are
    cut into ``num_shards`` blocks, the node table replicated (the hub
    layout of ``models/gat.py::gat_hub_attention``): ``el_full`` ``[N,
    H]``, ``feat`` ``[N, H, D]``, ``er_dst`` ``[B, H]``; ``nbr`` (node
    ids) and ``mask`` ``[B, S]`` this process's part of the axis. Each
    shard gathers only its ``[B, S/n]`` slice (``gather_rows``) and its
    partial stats; the shards combine them with one max and two sums
    (``all_reduce`` in a group) in log-sum-exp form, so no ``[B, S, H,
    D]`` gather exists anywhere. Returns ``[B, H, D]``."""
    L = num_shards // world
    N, H, D = feat.shape
    B = er_dst.shape[0]
    el2, feat2 = el_full.reshape(N, H), feat.reshape(N, H * D)
    stats = []
    for nb, mk in zip(_split(nbr, L), _split(mask, L)):
        idx = nb.reshape(-1)
        s = nb.shape[1]
        el_loc = gather_rows(el2, idx).view(B, s, H)
        v_loc = gather_rows(feat2, idx).view(B, s, H, D)
        logits = F.leaky_relu(el_loc + er_dst[:, None, :], negative_slope)
        stats.append(_stream_block(
            (er_dst.new_full((B, H), _NEG), er_dst.new_zeros((B, H)),
             er_dst.new_zeros((B, H, D))), logits, mk, v_loc))
    m_l = torch.stack([m for m, _, _ in stats])
    m_g = m_l.amax(0)
    if world > 1:
        dist.all_reduce(m_g, op=dist.ReduceOp.MAX)
    d = sum(dd * torch.exp(m - m_g) for m, dd, _ in stats)
    o = sum(oo * torch.exp(m - m_g)[..., None] for m, _, oo in stats)
    if world > 1:
        dist.all_reduce(d)
        dist.all_reduce(o)
    return o / torch.clamp_min(d, 1e-20)[..., None]


def make_ring_attention(num_shards: int, mode: str = "dot", rank: int = 0,
                        world: int = 1, **kw) -> Callable:
    """A callable of the ring form for ``mode``:

    - ``"dot"``: ``(q, k, v, mask)``;
    - ``"gat"``: ``(el, er, v, mask)``;
    - ``"gat-gathered"``: ``(el_full, er_dst, feat, nbr, mask)``;
    - ``"auto"`` / ``"auto-gat"``: per call the dense form or the ring,
      by :func:`use_ring` (the dense parity is exact up to float order:
      both share the scorer and the masking).

    ``kw`` are the scorer's (``negative_slope``)."""
    if mode in ("auto", "auto-gat"):
        gat = mode == "auto-gat"
        ring = make_ring_attention(num_shards, "gat" if gat else "dot",
                                   rank, world, **kw)

        def auto(a, b, v, mask):
            N, S = mask.shape[0], mask.shape[1] * world
            H, Dv = v.shape[-2], v.shape[-1]
            Dk = 1 if gat else a.shape[-1]
            if world == 1 and not use_ring(
                    N, S, H, Dk, Dv, itemsize=v.element_size(),
                    nshard=num_shards, device=v.device):
                return (dense_gat_attention(a, b, v, mask, **kw) if gat
                        else dense_dot_attention(a, b, v, mask))
            return ring(a, b, v, mask)

        return auto
    if mode == "dot":
        if kw:
            raise TypeError(f"mode='dot' takes no extra kwargs: {kw}")
        return lambda q, k, v, mask: ring_dot_attention(
            q, k, v, mask, num_shards, rank, world)
    if mode == "gat":
        return lambda el, er, v, mask: ring_gat_attention(
            el, er, v, mask, num_shards, rank=rank, world=world, **kw)
    if mode == "gat-gathered":
        return lambda el_full, er_dst, feat, nbr, mask: \
            gathered_gat_attention(el_full, er_dst, feat, nbr, mask,
                                   num_shards, rank=rank, world=world,
                                   **kw)
    raise ValueError(f"unknown mode {mode!r}")
