"""The reference's neighbour sampling: uniform draws with replacement,
tree-form blocks, from a counter-based hash.

A frozen copy of the device sampler's contract
(``dgl_operator_tpu_torch/ops/device_sample.py``): layer by layer from
the seeds outward, slot ``(i, k)`` of node ``v`` takes in-neighbour
``indices[indptr[v] + draw % deg(v)]``, where ``draw`` is a 31-bit
murmur3-finalizer hash of the key, the layer and the slot's flat index,
and the key hashes the run's seed and the global step. Nothing is
deduplicated: a layer of ``n`` nodes gives ``n * (F + 1)`` sources (its
``n`` nodes first, then slot ``(i, k)`` at ``n + i * F + k``). A padded
seed (``-1``) or a node without in-edges masks its whole row, and a
masked slot's id is 0.

The in-edge lists (:func:`in_csr`) are built here from the edge list:
each node's in-edges in edge order. Plain torch integer ops; nothing of
the program is imported.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

_M32 = 0xFFFFFFFF
_C1, _C2 = 0x85EBCA6B, 0xC2B2AE35
_KEY_BASIS = 0x9E3779B9


def _mul32(x, c: int):
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def mix32(x):
    """murmur3's 32-bit finalizer on a Python int or an int64 tensor of
    values in ``[0, 2^32)``."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def draw_key(*parts: int) -> int:
    """The key of a tuple of integers in ``[0, 2^63)``."""
    key = _KEY_BASIS
    for part in parts:
        key = mix32(key ^ ((part & _M32) ^ ((part >> 32) & _M32)))
    return key


def in_csr(src: torch.Tensor, dst: torch.Tensor, num_nodes: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(indptr [N + 1], indices [E])`` (int64) of the in-edges: node
    ``v``'s sources in ``indices[indptr[v]:indptr[v + 1]]``, in edge
    order."""
    order = torch.sort(dst.long(), stable=True).indices
    indices = src.long()[order]
    counts = torch.bincount(dst.long(), minlength=num_nodes)
    indptr = torch.zeros(num_nodes + 1, dtype=torch.int64,
                         device=src.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr, indices


def sample_tree(indptr: torch.Tensor, indices: torch.Tensor,
                seeds: torch.Tensor, fanouts: Sequence[int], key: int
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``(masks, ids)``: each block's ``[n, F]`` bool validity,
    outermost block first, and the ``[n_0]`` int64 ids of the outermost
    sources (the rows the first layer reads). ``seeds`` ``[B]``, ``-1``
    pads; ``fanouts`` outermost first."""
    dev = seeds.device
    f = seeds.long().clamp_min(0)
    valid = seeds >= 0
    masks = []
    for layer, fan in enumerate(reversed([int(x) for x in fanouts])):
        n = f.shape[0]
        start = indptr[f]
        deg = indptr[f + 1] - start
        lkey = mix32(key ^ mix32(layer + 1))
        count = mix32(torch.arange(n * fan, dtype=torch.int64, device=dev))
        draws = (mix32(count ^ lkey) >> 1).view(n, fan)
        slot = draws % deg.clamp_min(1).unsqueeze(1)
        at = (start.unsqueeze(1) + slot).clamp(0, indices.numel() - 1)
        mask = ((deg > 0) & valid).unsqueeze(1).expand(n, fan)
        nbr = torch.where(mask, indices[at], torch.zeros((), dtype=torch.int64,
                                                         device=dev))
        masks.append(mask.contiguous())
        f = torch.cat([f, nbr.reshape(-1)])
        valid = torch.cat([valid, mask.reshape(-1)])
    return masks[::-1], f
