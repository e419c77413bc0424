"""Masked row scatter-add — the backward of the row gathers.

:func:`scatter_add_rows` computes ``dst[idx[i, k]] += g[i] / denom_i``
over the valid slots of a ``[ND, F]`` index table into a zero-filled
``[num_rows, D]`` table. It is the transpose of both forward kernels:
of ``fanout_agg`` (``denom_i`` is the row's valid count for the mean,
1 for the sum) and of ``gather_rows`` (F = 1, no mask).

On a CUDA tensor it launches the hand-written kernel
``csrc/scatter_add_rows.cu``: a segmented sum over a transpose of the
index table that the host builds once per batch (:func:`scatter_plan`).
Each target row adds its entries in a fixed order and is written once,
so the result does not change from launch to launch. On a CPU tensor
it runs :func:`scatter_add_rows_plain`, which is also what the kernel
is held against on the card.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dgl_operator_tpu_torch.ops import _build

_SOURCE = "scatter_add_rows.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INDEX_DTYPES = (torch.int32, torch.int64)
# a target of up to CHUNK entries is summed by one warp in entry order;
# a longer one is cut into pieces of CHUNK entries, summed apart and
# added in a fixed order (kChunk in the .cu)
CHUNK = 32


def pack_int32(arrays: Sequence[np.ndarray]):
    """Integer host arrays as one int32 buffer and their shapes (for
    :func:`unpack`)."""
    flat = [np.asarray(a).reshape(-1).astype(np.int32, copy=False)
            for a in arrays]
    buf = np.concatenate(flat) if flat else np.zeros(0, np.int32)
    return buf, [np.shape(a) for a in arrays]


def unpack(packed: torch.Tensor, shapes) -> List[torch.Tensor]:
    """The arrays of a :func:`pack_int32` buffer, as views of ``packed``
    (the buffer, on any device)."""
    out, at = [], 0
    for shape in shapes:
        n = int(np.prod(shape, dtype=np.int64))
        out.append(packed[at:at + n].view(shape))
        at += n
    return out


def ship_int32(arrays: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """Integer host arrays as int32 tensors on ``device``, in one copy of
    their concatenation; each comes back with its own shape."""
    buf, shapes = pack_int32(arrays)
    return unpack(torch.from_numpy(buf).to(device), shapes)


class ScatterPlan:
    """The transpose of one ``[ND, F]`` index table, built on the host
    by :func:`scatter_plan`; every array is int32.

    offsets   [num_rows + 1]  target ``t``'s entries are
              ``src[offsets[t]:offsets[t + 1]]``.
    src       [nnz]  the source row ``i`` of every valid slot, sorted by
              target, then ``i``, then slot ``k``.
    cnt       [ND]   each source row's valid count (the mean's divisor
              before ``max(., 1)``).
    chunks    [n_chunks, 2]  ``(begin, end)``: the CHUNK-entry pieces
              of the targets with more than CHUNK entries, in target and
              entry order.
    long_rows [n_long]  those targets.
    long_part [n_long + 1]  target ``q``'s pieces are chunks
              ``long_part[q]:long_part[q + 1]``.

    The arrays are numpy on the host and tensors after :meth:`to`. The
    kernel only reads them, so launches may share a plan.
    """

    FIELDS = ("offsets", "src", "cnt", "chunks", "long_rows", "long_part")

    def __init__(self, offsets, src, cnt, chunks, long_rows, long_part):
        self.offsets = offsets
        self.src = src
        self.cnt = cnt
        self.chunks = chunks
        self.long_rows = long_rows
        self.long_part = long_part

    @property
    def num_rows(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def num_chunks(self) -> int:
        return self.chunks.shape[0]

    def nbytes(self) -> int:
        return sum(int(getattr(self, k).nbytes) for k in self.FIELDS)

    def to(self, device) -> "ScatterPlan":
        """The plan as int32 tensors on ``device``: a host plan goes in
        one copy of its arrays packed together; a plan already on
        ``device`` is returned as it is."""
        arrays = [getattr(self, k) for k in self.FIELDS]
        if isinstance(arrays[0], torch.Tensor):
            want = torch.device(device)
            have = arrays[0].device
            if have.type != want.type or want.index not in (None,
                                                            have.index):
                raise ValueError(f"a plan on {have} is not moved to "
                                 f"{want}; ship the host plan")
            return self
        return ScatterPlan(*ship_int32(arrays, device))


def scatter_plan(idx, mask, num_rows: int) -> ScatterPlan:
    """The transpose of ``idx`` ``[ND, F]`` over its valid slots
    (``mask > 0``; every slot when ``mask`` is None) into ``num_rows``
    targets, as numpy int32 arrays (:class:`ScatterPlan`)."""
    idx = np.asarray(idx)
    if idx.ndim != 2:
        raise ValueError(f"idx must be [ND, F], got shape {idx.shape}")
    nd, f = idx.shape
    valid = (np.ones((nd, f), bool) if mask is None
             else np.asarray(mask).reshape(nd, f) > 0)
    slots = np.flatnonzero(valid)               # (i, k) order
    tgt = idx.reshape(-1)[slots].astype(np.int64)
    if tgt.size and (tgt.min() < 0 or tgt.max() >= num_rows):
        raise ValueError(f"a valid slot names a row outside [0, "
                         f"{num_rows})")
    if max(tgt.size, num_rows) >= 2 ** 31:
        raise ValueError("scatter_plan takes fewer than 2^31 entries "
                         "and rows")
    order = np.argsort(tgt, kind="stable")
    counts = np.bincount(tgt, minlength=num_rows)
    offsets = np.zeros(num_rows + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    long_rows = np.flatnonzero(counts > CHUNK)
    pieces = -(-counts[long_rows] // CHUNK)
    long_part = np.zeros(len(long_rows) + 1, np.int64)
    np.cumsum(pieces, out=long_part[1:])
    q = np.repeat(np.arange(len(long_rows)), pieces)
    begin = (offsets[long_rows][q]
             + CHUNK * (np.arange(len(q)) - long_part[:-1][q]))
    end = np.minimum(begin + CHUNK, offsets[long_rows + 1][q])
    i32 = np.int32
    return ScatterPlan(
        offsets.astype(i32), (slots[order] // f).astype(i32),
        valid.sum(1).astype(i32),
        np.stack([begin, end], 1).astype(i32).reshape(-1, 2),
        long_rows.astype(i32), long_part.astype(i32))


def ship_ids_and_plans(ids_list: Sequence[np.ndarray],
                       rows_list: Sequence[int], device
                       ) -> Tuple[List[torch.Tensor], List[ScatterPlan]]:
    """Host id arrays ``[M]`` as int32 tensors on ``device`` and, for
    each, the plan of a gather of its ids from a table of as many rows
    as ``rows_list`` says (``scatter_plan(ids[:, None], None, rows)``),
    all in one copy."""
    ids_list = [np.asarray(a) for a in ids_list]
    plans = [scatter_plan(a[:, None], None, rows)
             for a, rows in zip(ids_list, rows_list, strict=True)]
    n, k = len(ids_list), len(ScatterPlan.FIELDS)
    shipped = ship_int32(ids_list + [getattr(p, f) for p in plans
                                     for f in ScatterPlan.FIELDS], device)
    return shipped[:n], [ScatterPlan(*shipped[n + j * k:n + (j + 1) * k])
                         for j in range(n)]


def slot_plan(idx, mask, num_rows: int) -> ScatterPlan:
    """The plan of a gather of every slot of ``idx`` ``[ND, F]``
    (``gather_rows(table, idx.reshape(-1))``, as the attention layers
    gather their neighbours): :func:`scatter_plan` of the flattened
    table, one source row per slot, over the valid slots only. A masked
    slot is left out of the transpose; the layers that gather this way
    weigh it by exactly 0, so its cotangent row is 0."""
    idx = np.asarray(idx).reshape(-1, 1)
    return scatter_plan(idx, None if mask is None
                        else np.asarray(mask).reshape(-1, 1), num_rows)


def attach_plans(blocks, slots: bool) -> None:
    """Give each host block the plan its layer's backward sums over on
    the card, as a model's ``slot_plans`` says: without ``slots``, the
    transpose of the rows of every block but the first
    (:func:`scatter_plan`, for ``fanout_agg``; the first block's source
    rows are the input features, which need no gradient); with
    ``slots``, the transpose of the slots of every block
    (:func:`slot_plan`, for per-slot gathers)."""
    make = slot_plan if slots else scatter_plan
    for blk in blocks[0 if slots else 1:]:
        blk.plan = make(blk.nbr, blk.mask, blk.num_src)


def tree_scatter_plan(mask: torch.Tensor, slots: bool = False
                      ) -> ScatterPlan:
    """The :func:`scatter_plan` (or, with ``slots``, the
    :func:`slot_plan`) of a device-sampled tree block, built on
    ``mask``'s device with static shapes and no host sync.

    A tree block ``[n, F]`` names source row ``n + i * F + k`` from slot
    ``(i, k)`` (``ops/device_sample.py``), so each target has at most one
    entry: ``offsets`` is zeros up to ``n``, then the running count of
    valid slots; ``src`` holds the valid slots' rows ``i`` (with
    ``slots``: the slots ``i * F + k``) in slot order, scattered to the
    front (its entries past the valid count are never read: they hold
    the masked slots' rows); ``cnt`` is each row's (each slot's) valid
    count; there are no long targets. Equal to ``scatter_plan(pos, mask,
    n * (F + 1))`` (``slot_plan(pos, mask, n * (F + 1))``) field for
    field, ``src`` on its first ``nnz`` entries."""
    n, f = mask.shape
    dev = mask.device
    i32 = torch.int32
    valid = (mask > 0).reshape(-1)
    run = torch.cumsum(valid.to(i32), 0, dtype=i32)
    nnz = valid.sum(dtype=i32)
    slot = torch.arange(n * f, dtype=i32, device=dev)
    # a permutation: the valid slots first, then the masked ones, each
    # in slot order
    dest = torch.where(valid, run - 1, nnz + slot - run)
    row = slot if slots else torch.div(slot, f, rounding_mode="floor")
    src = torch.empty_like(slot).scatter_(0, dest.long(), row)
    cnt = valid.to(i32) if slots else (mask > 0).sum(1, dtype=i32)
    return ScatterPlan(
        torch.cat([torch.zeros(n + 1, dtype=i32, device=dev), run]), src,
        cnt, torch.zeros((0, 2), dtype=i32, device=dev),
        torch.zeros(0, dtype=i32, device=dev),
        torch.zeros(1, dtype=i32, device=dev))


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
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def scatter_add_rows(g: torch.Tensor, idx: torch.Tensor,
                     mask: Optional[torch.Tensor], num_rows: int,
                     mean: bool, plan: Optional[ScatterPlan] = None
                     ) -> torch.Tensor:
    """``dst[idx[i, k]] += g[i] / (max(cnt_i, 1) if mean else 1)`` for
    every slot with ``mask[i, k] > 0`` (every slot when ``mask`` is
    None), into a zero-filled float32 ``[num_rows, D]`` that is
    returned.

    g    [ND, D] float32 or bfloat16, contiguous (a CPU tensor may also
         be float64, summed and returned in float64 by the plain version).
    idx  [ND, F] int32 or int64; every valid slot indexes a row of dst.
    mask [ND, F] uint8, or None.
    plan ``scatter_plan(idx, mask, num_rows)``, on the host or on g's
         device.

    On a CUDA tensor this launches the kernel over ``plan`` (counted
    once a call in ``scatter_add_rows.launches``; a plan with long
    targets adds their partial sums in a second launch), and raises
    without one; on a CPU tensor it runs :func:`scatter_add_rows_plain`
    and does not read ``plan``.
    """
    if g.dim() != 2 or idx.dim() != 2 or idx.shape[0] != g.shape[0] or (
            mask is not None and mask.shape != idx.shape):
        raise ValueError(
            f"scatter_add_rows takes g [ND, D], idx [ND, F] and mask "
            f"[ND, F] or None; got g {tuple(g.shape)}, idx "
            f"{tuple(idx.shape)}, mask "
            f"{None if mask is None else tuple(mask.shape)}")
    if g.dtype not in _DTYPE_CODE and not (
            g.dtype == torch.float64 and g.device.type == "cpu"):
        raise TypeError(f"g must be float32 or bfloat16 (or float64 on the "
                        f"CPU), got {g.dtype}")
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
    if plan is None:
        raise ValueError(
            "scatter_add_rows on a CUDA tensor needs the index table's "
            "scatter_plan(idx, mask, num_rows); attach it to the "
            "FanoutBlock (block.plan) or pass it to gather_rows")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    plan = plan.to(g.device)
    if not all(t.dtype == torch.int32 and t.is_contiguous()
               for t in (getattr(plan, k) for k in ScatterPlan.FIELDS)):
        raise TypeError("the plan's arrays must be contiguous int32")
    if plan.num_rows != num_rows or plan.cnt.shape[0] != g.shape[0]:
        raise ValueError(f"the plan is for {plan.num_rows} rows and "
                         f"{plan.cnt.shape[0]} source rows, not "
                         f"{num_rows} and {g.shape[0]}")
    d = g.shape[1]
    out = torch.empty((num_rows, d), dtype=torch.float32, device=g.device)
    if num_rows == 0 or d == 0:
        return out
    partial = torch.empty((plan.num_chunks, d), dtype=torch.float32,
                          device=g.device)
    launch = _launcher()
    with torch.cuda.device(g.device):
        # read here, not cached: autograd calls a backward on its own
        # thread, with the forward's stream made current
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = launch(g.data_ptr(), *(getattr(plan, k).data_ptr()
                                     for k in ScatterPlan.FIELDS),
                     partial.data_ptr(), out.data_ptr(), num_rows,
                     plan.num_chunks, plan.long_rows.shape[0], d,
                     _DTYPE_CODE[g.dtype], int(mean), stream)
    if err != 0:
        raise RuntimeError(f"scatter_add_rows kernel launch failed: CUDA "
                           f"error {err}")
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0
