"""Masked row scatter-add — the backward of the row gathers.

:func:`scatter_add_rows` computes ``dst[idx[i, k]] += g[i] / denom_i``
over the valid slots of a ``[ND, F]`` index table into a zero-filled
``[num_rows, D]`` table. It is the transpose of both forward kernels:
of ``fanout_agg`` (``denom_i`` is the row's valid count for the mean,
1 for the sum) and of ``gather_rows`` (F = 1, no mask). On a CUDA
tensor it launches the hand-written kernel ``csrc/scatter_add_rows.cu``
(fp32 atomics; the order of the adds, and so the last bits of the sum,
vary from run to run); on a CPU tensor it runs
:func:`scatter_add_rows_plain`, which is also what the kernel is held
against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dgl_operator_tpu_torch.ops import _build

_SOURCE = "scatter_add_rows.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INDEX_DTYPES = (torch.int32, torch.int64)


def scatter_add_rows_plain(g: torch.Tensor, idx: torch.Tensor,
                           mask: Optional[torch.Tensor], num_rows: int,
                           mean: bool) -> torch.Tensor:
    """Plain-torch reference, accumulating in float32 (float64 for a
    float64 ``g``, so ``gradcheck`` can run on it) and returning that
    type."""
    acc = torch.promote_types(g.dtype, torch.float32)
    nd, f = idx.shape
    valid = (torch.ones(nd, f, dtype=torch.bool, device=g.device)
             if mask is None else mask > 0)
    rows = g.to(acc)
    if mean:
        rows = rows / valid.sum(1, keepdim=True).clamp_min(1).to(acc)
    out = torch.zeros(num_rows, g.shape[1], dtype=acc, device=g.device)
    src = rows.unsqueeze(1).expand(nd, f, g.shape[1])[valid]
    return out.index_add_(0, idx[valid].long(), src)


def _launcher():
    lib = _build.load(_SOURCE)
    fn = lib.scatter_add_rows_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def scatter_add_rows(g: torch.Tensor, idx: torch.Tensor,
                     mask: Optional[torch.Tensor], num_rows: int,
                     mean: bool) -> torch.Tensor:
    """``dst[idx[i, k]] += g[i] / (max(cnt_i, 1) if mean else 1)`` for
    every slot with ``mask[i, k] > 0`` (every slot when ``mask`` is
    None), into a zero-filled float32 ``[num_rows, D]`` that is
    returned.

    g    [ND, D] float32 or bfloat16, contiguous.
    idx  [ND, F] int32 or int64; every valid slot indexes a row of dst.
    mask [ND, F] uint8, or None.

    On a CUDA tensor this zero-fills and launches the kernel (counted in
    ``scatter_add_rows.launches``) or raises; on a CPU tensor it runs
    :func:`scatter_add_rows_plain`.
    """
    if g.dim() != 2 or idx.dim() != 2 or idx.shape[0] != g.shape[0] or (
            mask is not None and mask.shape != idx.shape):
        raise ValueError(
            f"scatter_add_rows takes g [ND, D], idx [ND, F] and mask "
            f"[ND, F] or None; got g {tuple(g.shape)}, idx "
            f"{tuple(idx.shape)}, mask "
            f"{None if mask is None else tuple(mask.shape)}")
    if g.dtype not in _DTYPE_CODE:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if idx.dtype not in _INDEX_DTYPES or (
            mask is not None and mask.dtype != torch.uint8):
        raise TypeError(f"idx must be int32 or int64 and mask uint8, got "
                        f"{idx.dtype} and "
                        f"{None if mask is None else mask.dtype}")
    devices = {g.device, idx.device} | (
        set() if mask is None else {mask.device})
    if len(devices) != 1:
        raise ValueError(f"g, idx and mask must share a device; got "
                         f"{sorted(map(str, devices))}")
    if g.device.type == "cpu":
        return scatter_add_rows_plain(g, idx, mask, num_rows, mean)
    if g.device.type != "cuda":
        raise ValueError(f"scatter_add_rows runs on cuda or cpu, not "
                         f"{g.device}")
    if not (g.is_contiguous() and idx.is_contiguous() and (
            mask is None or mask.is_contiguous())):
        raise ValueError("g, idx and mask must be contiguous")
    nd, f = idx.shape
    out = torch.empty((num_rows, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    launch = _launcher()
    with torch.cuda.device(g.device):
        # read here, not cached: autograd calls a backward on its own
        # thread, with the forward's stream made current
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = launch(g.data_ptr(), idx.data_ptr(),
                     None if mask is None else mask.data_ptr(),
                     out.data_ptr(), nd, f, g.shape[1], num_rows,
                     _DTYPE_CODE[g.dtype], idx.element_size(), int(mean),
                     stream)
    if err != 0:
        raise RuntimeError(f"scatter_add_rows kernel launch failed: CUDA "
                           f"error {err}")
    if nd and f and g.shape[1]:     # else only the zero fill ran
        scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0
