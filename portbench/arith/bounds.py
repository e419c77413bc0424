"""The least time of the port's kernels' work: the bytes and operations
that a call's data needs, over the card's peaks.

Copied from ``chip_smoke.py`` (``bound_ms``, ``fanout_bound``,
``gather_bound``, ``scatter_bound``): each input byte read once, each
output byte written once, whatever a kernel reads again; the operations
are the adds the data needs. The time is the larger of bytes over HBM
bandwidth and operations over the float32 rate.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from portbench.arith import peaks

Work = Tuple[int, int]      # (bytes, operations)


def least_seconds(work: Work) -> float:
    nbytes, ops = work
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.FLOPS["float32"])


def _distinct(x: torch.Tensor) -> int:
    return int(torch.unique(x).numel()) if x.numel() else 0


def gather_work(idx: torch.Tensor, d: int, itemsize: int,
                idx_itemsize: int = 4) -> Work:
    """``table[idx]``: each distinct row read once, the output written
    once, ``idx`` read once; no arithmetic."""
    m = idx.numel()
    return (_distinct(idx) + m) * d * itemsize + m * idx_itemsize, 0


def fanout_work(nbr: torch.Tensor, mask: torch.Tensor, d: int,
                itemsize: int) -> Work:
    """The masked fanout sum (or mean): each distinct valid source row
    read once, the output written once, ``nbr`` (int32) and ``mask``
    (uint8) read once; an add per valid slot element."""
    nd, f = nbr.shape
    valid = mask > 0
    nbytes = (_distinct(nbr[valid]) * d * itemsize + nd * d * itemsize
              + nd * f * 5)
    return nbytes, int(valid.sum()) * d


def scatter_work(idx: torch.Tensor, mask: Optional[torch.Tensor], n: int,
                 d: int, itemsize: int, idx_itemsize: int = 4,
                 padded: bool = False) -> Work:
    """The scatter-add of ``g`` ``[nd, d]`` over ``idx`` ``[nd, f]`` into
    an ``[n, d]`` float32 table: the table written once (only its
    distinct targets where ``padded``), ``g``, ``idx`` and ``mask`` read
    once; an add per valid slot element and one per ``g`` element."""
    nd, f = idx.shape
    valid = (mask > 0) if mask is not None else idx >= 0
    rows = _distinct(idx[valid]) if padded else n
    nbytes = (rows * d * 4 + nd * d * itemsize
              + nd * f * (idx_itemsize + (mask is not None)))
    return nbytes, int(valid.sum()) * d + nd * d
