"""Dense fixed-fanout aggregation — the sampled path's hot loop.

Neighbors live in a dense ``[num_dst, fanout]`` table with a validity
mask (``FanoutBlock``), so aggregation is a masked reduction over the
fanout axis. :func:`fanout_agg` is the one primitive: on a CUDA tensor
it launches the hand-written kernel ``csrc/fanout_agg.cu`` (gather,
masked sum and the mean's division fused, each valid row read once);
on a CPU tensor it runs :func:`fanout_agg_plain`, the same function in
plain torch, which is also what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from dgl_operator_tpu_torch.graph.blocks import FanoutBlock
from dgl_operator_tpu_torch.ops import _build

_SOURCE = "fanout_agg.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fanout_agg_plain(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
                     mean: bool) -> torch.Tensor:
    """Plain-torch reference: masked gather and sum of ``h[nbr]`` over
    the fanout axis in float32, divided by ``max(count, 1)`` when
    ``mean``, returned in ``h``'s dtype."""
    valid = (mask > 0).unsqueeze(-1)
    rows = h[nbr.long()].float()
    out = torch.where(valid, rows, torch.zeros((), device=h.device)).sum(1)
    if mean:
        out = out / valid.sum(1).clamp_min(1).float()
    return out.to(h.dtype)


def _launcher():
    lib = _build.load(_SOURCE)
    fn = lib.fanout_agg_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fanout_agg(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
               mean: bool) -> torch.Tensor:
    """``out[i] = sum_{k: mask[i,k] > 0} h[nbr[i,k]]``, divided by
    ``max(count_i, 1)`` when ``mean``; fp32 accumulation, ``h``'s dtype
    out, 0 for a row with no valid slot.

    h    [N, D] float32 or bfloat16, contiguous.
    nbr  [ND, F] int32; every valid slot indexes a row of ``h``.
    mask [ND, F] uint8.

    On a CUDA tensor this launches the kernel (counted in
    ``fanout_agg.launches``) or raises; on a CPU tensor it runs
    :func:`fanout_agg_plain`. The kernel has no backward yet: no
    gradient flows through the CUDA path (inference only).
    """
    if h.dim() != 2 or nbr.dim() != 2 or mask.shape != nbr.shape:
        raise ValueError(
            f"fanout_agg takes h [N, D] and nbr/mask [ND, F] of one "
            f"shape; got h {tuple(h.shape)}, nbr {tuple(nbr.shape)}, "
            f"mask {tuple(mask.shape)}")
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"h must be float32 or bfloat16, got {h.dtype}")
    if nbr.dtype != torch.int32 or mask.dtype != torch.uint8:
        raise TypeError(f"nbr must be int32 and mask uint8, got "
                        f"{nbr.dtype} and {mask.dtype}")
    if not (h.device == nbr.device == mask.device):
        raise ValueError(f"h, nbr and mask must share a device; got "
                         f"{h.device}, {nbr.device}, {mask.device}")
    if h.device.type == "cpu":
        return fanout_agg_plain(h, nbr, mask, mean)
    if h.device.type != "cuda":
        raise ValueError(f"fanout_agg runs on cuda or cpu, not {h.device}")
    if not (h.is_contiguous() and nbr.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError("h, nbr and mask must be contiguous")
    nd, f = nbr.shape
    out = torch.empty((nd, h.shape[1]), dtype=h.dtype, device=h.device)
    if nd == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = launch(h.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                     out.data_ptr(), nd, f, h.shape[1], _DTYPE_CODE[h.dtype],
                     int(mean), stream)
    if err != 0:
        raise RuntimeError(f"fanout_agg kernel launch failed: CUDA error "
                           f"{err}")
    fanout_agg.launches += 1
    return out


fanout_agg.launches = 0


def _block_tensors(block: FanoutBlock, h_src: torch.Tensor):
    """The block's ``nbr``/``mask`` as int32/uint8 tensors on ``h_src``'s
    device (no copy for a block already shipped there)."""
    shipped = block.to(h_src.device)
    return shipped.nbr, shipped.mask


def fanout_sum(block: FanoutBlock, h_src: torch.Tensor) -> torch.Tensor:
    nbr, mask = _block_tensors(block, h_src)
    return fanout_agg(h_src.contiguous(), nbr, mask, mean=False)


def fanout_mean(block: FanoutBlock, h_src: torch.Tensor) -> torch.Tensor:
    nbr, mask = _block_tensors(block, h_src)
    return fanout_agg(h_src.contiguous(), nbr, mask, mean=True)


def fanout_max(block: FanoutBlock, h_src: torch.Tensor) -> torch.Tensor:
    """Masked max over the fanout axis; a row with no valid slot gives 0
    (the zero-in-degree convention). Plain torch: its JAX counterpart
    is XLA, not a hand-written kernel."""
    nbr, mask = _block_tensors(block, h_src)
    valid = (mask > 0).unsqueeze(-1)
    x = torch.where(valid, h_src[nbr.long()],
                    torch.tensor(float("-inf"), dtype=h_src.dtype,
                                 device=h_src.device))
    out = x.max(dim=1).values
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
