"""Row gather — the trainer's input-feature load (``load_subtensor``).

:func:`gather_rows` is ``table[idx]`` with a gradient: on a CUDA tensor
it launches the hand-written kernel ``csrc/gather_rows.cu`` and its
backward the segmented-sum kernel (``ops/scatter.py``, over the plan
``scatter_plan(idx[:, None], None, N)``); on a CPU tensor
both run their plain torch versions (:func:`gather_rows_plain`,
``scatter_add_rows_plain``), which are also what the kernels are held
against on the card. Unlike the JAX package's Pallas gather, it takes
every row width. Like it, it moves rows of any dtype: a float32 or
bfloat16 table, or the int8 and uint8 codes of a quantized feature
store (``graph/quant.py``), which carry no gradient.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from dgl_operator_tpu_torch.ops import _build
from dgl_operator_tpu_torch.ops.scatter import ScatterPlan, scatter_add_rows

_SOURCE = "gather_rows.cu"
# the kernel's element size codes: 4-byte, 2-byte and 1-byte rows
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.uint8: 2}
_INDEX_DTYPES = (torch.int32, torch.int64)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """Plain-torch reference: ``table[idx]``."""
    return table[idx.long()]


def _launcher():
    lib = _build.load(_SOURCE)
    fn = lib.gather_rows_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu, not "
                         f"{table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    m, d = idx.shape[0], table.shape[1]
    out = torch.empty((m, d), dtype=table.dtype, device=table.device)
    if m == 0 or d == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = launch(table.data_ptr(), idx.data_ptr(), out.data_ptr(), m, d,
                     _DTYPE_CODE[table.dtype], idx.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error "
                           f"{err}")
    gather_rows.launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    """Forward: the row gather. Backward: the transpose, a scatter-add
    of the cotangent over ``plan`` into a float32 table (every index
    counts, repeated and padded ones included), cast to the table's
    dtype. The rows of an integer table (codes) are marked
    non-differentiable, and a backward through them raises."""

    @staticmethod
    def forward(ctx, table, idx, plan):
        ctx.save_for_backward(idx)
        ctx.plan = plan
        ctx.num_rows = table.shape[0]
        ctx.codes = not table.is_floating_point()
        out = _gather(table, idx)
        if ctx.codes:
            ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        if ctx.codes:
            raise TypeError("gather_rows: an integer table (codes) has "
                            "no gradient")
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (idx,) = ctx.saved_tensors
        dt = scatter_add_rows(grad.contiguous(), idx.view(-1, 1), None,
                              ctx.num_rows, mean=False, plan=ctx.plan)
        return dt.to(grad.dtype), None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                plan: Optional[ScatterPlan] = None) -> torch.Tensor:
    """``out[i] = table[idx[i]]``, differentiable in ``table``.

    table [N, D] float32, bfloat16, int8 or uint8 (codes: no
          gradient), contiguous (a CPU tensor may also be float64: the
          plain version takes it, no kernel does).
    idx   [M] int32 or int64; every entry indexes a row of ``table``.
    plan  ``scatter_plan(idx[:, None], None, N)``, read only by the
          backward on the card (which raises without it).

    On a CUDA tensor this launches the kernel (counted in
    ``gather_rows.launches``) or raises; on a CPU tensor it runs
    :func:`gather_rows_plain`.
    """
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows takes table [N, D] and idx [M]; got "
                         f"table {tuple(table.shape)}, idx "
                         f"{tuple(idx.shape)}")
    if table.dtype not in _DTYPE_CODE and not (
            table.dtype == torch.float64 and table.device.type == "cpu"):
        raise TypeError(f"table must be float32, bfloat16, int8 or uint8 "
                        f"(or float64 on the CPU), got {table.dtype}")
    if idx.dtype not in _INDEX_DTYPES:
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    if table.device != idx.device:
        raise ValueError(f"table and idx must share a device; got "
                         f"{table.device} and {idx.device}")
    return _GatherRows.apply(table, idx, plan)


gather_rows.launches = 0


def gather_edges(table: torch.Tensor, idx: torch.Tensor,
                 plan: Optional[ScatterPlan] = None) -> torch.Tensor:
    """:func:`gather_rows` of a table of any trailing shape, ``[N, ...]``
    to ``[M, ...]`` (the rows flattened for the kernel and shaped
    back). An integer table carries no gradient and is indexed."""
    if not table.is_floating_point():
        return table[idx.long()]
    rows = table.reshape(table.shape[0], -1).contiguous()
    return gather_rows(rows, idx, plan).view(
        (idx.shape[0],) + tuple(table.shape[1:]))
