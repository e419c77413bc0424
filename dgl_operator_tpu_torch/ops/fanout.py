"""Dense fixed-fanout aggregation — the sampled path's hot loop.

Neighbors live in a dense ``[num_dst, fanout]`` table with a validity
mask (``FanoutBlock``), so aggregation is a masked reduction over the
fanout axis. :func:`fanout_agg` is the one primitive: on a CUDA tensor
it launches the hand-written kernel ``csrc/fanout_agg.cu`` (rows of
512 bytes or more copied into shared memory by TMA bulk copies,
narrower ones loaded into registers; masked sum and the mean's
division fused), and its backward the segmented-sum kernel
``csrc/scatter_add_rows.cu`` over the block's ``plan`` (the transpose
of ``nbr``, built on the host by ``scatter_plan``); on a CPU tensor
both run their plain torch versions (:func:`fanout_agg_plain`,
``scatter_add_rows_plain``), which are also what the kernels are held
against on the card. The pool aggregator's :func:`fanout_max` gathers
its slots with ``gather_rows`` over the block's per-slot plan, so its
backward is the same deterministic segmented sum.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from dgl_operator_tpu_torch.graph.blocks import FanoutBlock
from dgl_operator_tpu_torch.obs import prof
from dgl_operator_tpu_torch.ops import _build
from dgl_operator_tpu_torch.ops.gather import gather_rows
from dgl_operator_tpu_torch.ops.scatter import ScatterPlan, scatter_add_rows

_SOURCE = "fanout_agg.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fanout_agg_plain(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
                     mean: bool) -> torch.Tensor:
    """Plain-torch reference: masked gather and sum of ``h[nbr]`` over
    the fanout axis in float32 (float64 for a float64 ``h``, so
    ``gradcheck`` can run on it), divided by ``max(count, 1)`` when
    ``mean``, returned in ``h``'s dtype."""
    acc = torch.promote_types(h.dtype, torch.float32)
    valid = (mask > 0).unsqueeze(-1)
    rows = h[nbr.long()].to(acc)
    out = torch.where(valid, rows,
                      torch.zeros((), dtype=acc, device=h.device)).sum(1)
    if mean:
        out = out / valid.sum(1).clamp_min(1).to(acc)
    return out.to(h.dtype)


def _launcher():
    lib = _build.load(_SOURCE)
    fn = lib.fanout_agg_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _aggregate(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
               mean: bool) -> torch.Tensor:
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
    # the launch's work for a step's cost count (no sync: every slot's
    # add, and each source row read at most once)
    size = h.element_size()
    prof.note_kernel(nd * f * h.shape[1],
                     (min(h.shape[0], nd * f) + nd) * h.shape[1] * size
                     + nd * f * (nbr.element_size() + mask.element_size()))
    return out


class _FanoutAgg(torch.autograd.Function):
    """Forward: the masked aggregation. Backward: its transpose, the
    scatter-add of the cotangent (divided by each row's valid count for
    the mean) over ``plan`` into a float32 table, cast to ``h``'s dtype;
    skipped when ``h`` needs no gradient."""

    @staticmethod
    def forward(ctx, h, nbr, mask, mean, plan):
        ctx.save_for_backward(nbr, mask)
        ctx.mean = mean
        ctx.plan = plan
        ctx.num_rows = h.shape[0]
        return _aggregate(h, nbr, mask, mean)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        nbr, mask = ctx.saved_tensors
        dh = scatter_add_rows(grad.contiguous(), nbr, mask, ctx.num_rows,
                              ctx.mean, plan=ctx.plan)
        return dh.to(grad.dtype), None, None, None, None


def fanout_agg(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
               mean: bool, plan: Optional[ScatterPlan] = None
               ) -> torch.Tensor:
    """``out[i] = sum_{k: mask[i,k] > 0} h[nbr[i,k]]``, divided by
    ``max(count_i, 1)`` when ``mean``; fp32 accumulation, ``h``'s dtype
    out, 0 for a row with no valid slot. Differentiable in ``h``.

    h    [N, D] float32 or bfloat16, contiguous.
    nbr  [ND, F] int32; every valid slot indexes a row of ``h``.
    mask [ND, F] uint8.
    plan ``scatter_plan(nbr, mask, N)``, read only by the backward on
         the card (which raises without it).

    On a CUDA tensor this launches the kernel (counted in
    ``fanout_agg.launches``) or raises, and its backward launches
    ``scatter_add_rows``; on a CPU tensor both run their plain torch
    versions. Either way the result carries the same ``grad_fn``.
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
    return _FanoutAgg.apply(h, nbr, mask, mean, plan)


fanout_agg.launches = 0


def fanout_sum(block: FanoutBlock, h_src: torch.Tensor) -> torch.Tensor:
    b = block.to(h_src.device)   # no copy for a block shipped there
    return fanout_agg(h_src.contiguous(), b.nbr, b.mask, False, b.plan)


def fanout_mean(block: FanoutBlock, h_src: torch.Tensor) -> torch.Tensor:
    b = block.to(h_src.device)
    return fanout_agg(h_src.contiguous(), b.nbr, b.mask, True, b.plan)


def fanout_max(block: FanoutBlock, h_src: torch.Tensor) -> torch.Tensor:
    """Masked max over the fanout axis; a row with no valid slot gives 0
    (the zero-in-degree convention). The slots' rows are gathered with
    ``gather_rows`` over the block's per-slot plan
    (``ops/scatter.py::slot_plan``), so the backward is the port's
    deterministic ``scatter_add_rows`` (a CUDA tensor that needs a
    gradient and has no plan raises there); the mask and the max are
    plain torch, as their JAX counterpart is XLA."""
    b = block.to(h_src.device)
    nd, f = b.nbr.shape
    x = gather_rows(h_src.contiguous(), b.nbr.view(-1), b.plan)
    # a fill value, not a tensor made on the host: the step may be
    # captured into a CUDA graph
    x = x.view(nd, f, -1).masked_fill((b.mask <= 0).unsqueeze(-1),
                                      float("-inf"))
    out = x.max(dim=1).values
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
