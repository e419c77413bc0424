"""Neighbor sampling on the card — the device sampler.

The counterpart of ``dgl_operator_tpu/ops/device_sample.py``. The graph's
CSR (``indptr`` and ``indices``) lives on the device, each step draws
uniform with-replacement neighbors (the reference's ``replace=True``),
and the only per-step input is the ``[batch]`` seed ids. Nothing syncs
the host and every shape is fixed by the batch size and the fanouts, so
a step that samples this way can be captured in a CUDA graph
(``runtime/graphs.py``). On a CUDA tensor :func:`sample_fanout_tree`
launches the hand-written kernel ``csrc/tree_sample.cu`` once a layer
(:func:`tree_sample`: the draws, the tree's ids and masks and the
backward plans in one pass, the key hashed in the kernel); on a CPU
tensor it runs the plain torch path (:func:`tree_draws`, then
:func:`sample_fanout_tree_from_draws`), which gives the same bits and
is what the kernel is held against.

Tree-form blocks, no frontier compaction: every dst-node occurrence
samples its own fanout slots and nothing is deduplicated, so layer
sizes are ``n_{l+1} = n_l * (fanout_l + 1)`` (:func:`tree_caps`). For
the mean and sum aggregators the tree is distribution-identical to the
host sampler's compacted blocks; it costs duplicate gathers and
aggregations. Blocks come outermost-first with the dst-prefix invariant
(dst node ``i`` at source position ``i``, its slot ``k`` at ``n + i * F
+ k``), so ``FanoutSAGEConv`` consumes them unchanged.

The draws. JAX draws each layer's ``[n, F]`` slot numbers with
``jax.random.randint`` from a split key; this module draws them from a
counter-based hash instead (:func:`draw_key`, :func:`tree_draws`): a
31-bit value per ``(key, layer, flat index)``, where the key hashes the
caller's integers (``SampledTrainer``: the run's seed and the global
step; ``DistTrainer``: the step seed and the part). The values are not ``jax.random``'s, but they are the same on
the CPU and on the card, the same whether a step runs alone or inside a
captured K-step call, and a device tensor can carry the step, so no
generator is reseeded inside a graph. :func:`sample_fanout_tree_from_draws`
takes the draws from outside, so a test can hand it JAX's.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dgl_operator_tpu_torch.graph.blocks import FanoutBlock
from dgl_operator_tpu_torch.obs import prof
from dgl_operator_tpu_torch.ops import _build
from dgl_operator_tpu_torch.ops.scatter import ScatterPlan, tree_scatter_plan

IntLike = Union[int, torch.Tensor]
_SOURCE = "tree_sample.cu"
_INDEX_DTYPES = (torch.int32, torch.int64)
# key parts from the first tensor part on (kMaxParts in the .cu)
_MAX_PARTS = 4
_M32 = 0xFFFFFFFF
# murmur3's 32-bit finalizer constants
_C1, _C2 = 0x85EBCA6B, 0xC2B2AE35
_KEY_BASIS = 0x9E3779B9


def tree_caps(seed_cap: int, fanouts: Sequence[int]) -> List[int]:
    """Tree layer sizes, innermost (seeds) outward: ``n_{l+1} = n_l *
    (fanout_l + 1)``, with no clamp to the graph size (the tree keeps
    duplicates)."""
    caps = [int(seed_cap)]
    for f in reversed(list(fanouts)):
        caps.append(caps[-1] * (int(f) + 1))
    return caps


def csr_index_dtype(num_nodes: int, num_edges: int) -> np.dtype:
    """The device CSR's index type: int32 when both counts are below
    2^31, else int64."""
    return np.dtype(np.int32 if max(int(num_nodes), int(num_edges)) < 2**31
                    else np.int64)


def device_csr(csc: Tuple[np.ndarray, np.ndarray, np.ndarray],
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A host CSC ``(indptr, indices, eids)`` as ``(indptr, indices)`` on
    ``device`` in :func:`csr_index_dtype` (``indptr`` holds offsets,
    ``indices`` node ids; either past int32 widens both). An edgeless
    graph gets one sentinel index, which every draw masks (each node has
    degree 0)."""
    indptr, indices, _ = csc
    dt = csr_index_dtype(len(indptr) - 1, len(indices))
    if len(indices) == 0:
        indices = np.zeros(1, dt)
    return (torch.from_numpy(np.asarray(indptr, dt)).to(device),
            torch.from_numpy(np.asarray(indices, dt)).to(device))


def _mul32(x, c: int):
    """``x * c mod 2^32`` for ``0 <= x < 2^32``, in products below 2^49
    (no int64 overflow): the high and low 16 bits of ``x`` apart."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def mix32(x):
    """murmur3's 32-bit finalizer, a bijection of ``[0, 2^32)``, on a
    Python int or an int64 tensor of such values."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def _fold(part: IntLike):
    """A non-negative integer below 2^63 as 32 bits."""
    return (part & _M32) ^ ((part >> 32) & _M32)


def _hash_parts(parts) -> IntLike:
    key = _KEY_BASIS
    for part in parts:
        key = mix32(key ^ _fold(part))
    return key


class DrawKey:
    """A key with a tensor among its parts (a device step counter), kept
    as its parts: the tree-sampling kernel hashes them when it runs, so
    no tensor op computes the key. :meth:`value` is the key as an int64
    tensor, computed with :func:`mix32`'s tensor ops (the plain
    path's)."""

    __slots__ = ("parts",)

    def __init__(self, parts: Sequence[IntLike]):
        self.parts = tuple(parts)

    def value(self) -> torch.Tensor:
        return _hash_parts(self.parts)


Key = Union[int, DrawKey]


def draw_key(*parts: IntLike) -> Key:
    """The draws' key of a tuple of integers (Python ints, or int64
    scalar tensors on the sampler's device, such as a device step
    counter), each in ``[0, 2^63)``: one :func:`mix32` round per part. A
    Python int when every part is one, else a :class:`DrawKey`."""
    if any(isinstance(p, torch.Tensor) for p in parts):
        return DrawKey(parts)
    return _hash_parts(parts)


def kernel_key(key: Key, device) -> Tuple[int, List[IntLike]]:
    """``key`` as the kernel takes it: the hash of its leading Python-int
    parts, then each later part, a tensor (read on the device) or a
    Python int folded to 32 bits. Hashing those parts in turn from the
    first gives :func:`draw_key`'s value. A tensor part must be an int64
    scalar on ``device``; at most ``_MAX_PARTS`` parts follow the
    first tensor."""
    if isinstance(key, int):
        if not 0 <= key < 2**32:
            raise ValueError(f"a key is draw_key's, in [0, 2^32); got {key}")
        return key, []
    if not isinstance(key, DrawKey):
        raise TypeError(f"a key is draw_key's (an int or a DrawKey), not "
                        f"{type(key).__name__}")
    start, rest = _KEY_BASIS, []
    for part in key.parts:
        if isinstance(part, torch.Tensor):
            if part.dtype != torch.int64 or part.numel() != 1:
                raise TypeError(f"a tensor part of a key is an int64 scalar; "
                                f"got {part.dtype} of {part.numel()} elements")
            if part.device != torch.device(device):
                raise ValueError(f"a tensor part of a key on {part.device} "
                                 f"for a sampler on {device}")
            rest.append(part)
        elif rest:
            rest.append(_fold(int(part)))
        else:
            start = mix32(start ^ _fold(int(part)))
    if len(rest) > _MAX_PARTS:
        raise ValueError(f"at most {_MAX_PARTS} key parts from the first "
                         f"tensor on; got {len(rest)}")
    return start, rest


def draw_counters(seed_cap: int, fanouts: Sequence[int], device
                  ) -> List[torch.Tensor]:
    """Per layer in sampling order (the seeds' layer first), the
    :func:`mix32` of every flat slot index ``[n * F]`` (int64): the part
    of each draw that no step changes."""
    out = []
    n = int(seed_cap)
    for fan in reversed(list(fanouts)):
        out.append(mix32(torch.arange(n * int(fan), dtype=torch.int64,
                                      device=device)))
        n *= int(fan) + 1
    return out


def tree_draws(key: Key, counters: Sequence[torch.Tensor],
               fanouts: Sequence[int]) -> List[torch.Tensor]:
    """Each layer's ``[n, F]`` int32 draws in ``[0, 2^31)``, in sampling
    order: ``mix32(counter ^ mix32(key ^ mix32(layer + 1))) >> 1`` over
    :func:`draw_counters`' ``counters``."""
    if isinstance(key, DrawKey):
        key = key.value()
    out = []
    for layer, (cnt, fan) in enumerate(zip(counters,
                                           reversed(list(fanouts)))):
        k = mix32(key ^ mix32(layer + 1))
        bits = mix32(cnt ^ k) >> 1
        out.append(bits.to(torch.int32).view(-1, int(fan)))
    return out


def tree_positions(seed_cap: int, fanouts: Sequence[int], device
                   ) -> List[torch.Tensor]:
    """Per layer in sampling order, the tree block's neighbor table
    ``pos[i, k] = n + i * F + k`` (int32 ``[n, F]``): the same every
    step."""
    out = []
    n = int(seed_cap)
    for fan in reversed(list(fanouts)):
        out.append((n + torch.arange(n * int(fan), dtype=torch.int32,
                                     device=device)).view(n, int(fan)))
        n *= int(fan) + 1
    return out


def sample_fanout_tree_from_draws(
        indptr: torch.Tensor, indices: torch.Tensor, seeds: torch.Tensor,
        fanouts: Sequence[int], draws: Sequence[torch.Tensor],
        positions: Optional[Sequence[torch.Tensor]] = None,
        plans: bool = False, slot_plans: bool = False
        ) -> Tuple[List[FanoutBlock], torch.Tensor]:
    """Multi-layer uniform with-replacement fanout sampling from given
    draws; returns ``(blocks, input_ids)``, blocks outermost-first and
    ``input_ids`` the global ids whose rows the first layer reads.

    indptr, indices  the CSR on the device (:func:`device_csr`).
    seeds            ``[B]`` integer seed ids; ``-1`` pads.
    draws            per layer in sampling order (the seeds' layer
                     first), ``[n, F]`` non-negative integers; slot
                     ``(i, k)`` takes in-neighbor ``draws[i, k] % deg``
                     of its node.
    positions        :func:`tree_positions` of these shapes, to reuse
                     (built here when None).
    plans            attach :func:`~ops.scatter.tree_scatter_plan` (the
                     transposes the card's backward sums over) as
                     :func:`~ops.scatter.attach_plans` does:
                     ``slot_plans`` (the model's) gives every block
                     the plan of its slots, else every block but the
                     first gets the plan of its rows.

    A padded seed and a node of degree 0 mask their whole fanout row; a
    masked slot's source id is 0. Out-of-range reads are clamped, as
    JAX's ``mode="clip"`` takes are, so no index leaves its array."""
    if positions is None:
        positions = tree_positions(seeds.shape[0], fanouts, seeds.device)
    idt = indptr.dtype
    last_ptr = indptr.numel() - 1
    last_idx = indices.numel() - 1
    f = seeds.to(idt).clamp_min(0)
    valid = seeds >= 0
    per_layer = []
    for layer, (fan, r) in enumerate(zip(reversed(list(fanouts)), draws)):
        fan = int(fan)
        n = f.shape[0]
        start = indptr.index_select(0, f.clamp_max(last_ptr))
        deg = indptr.index_select(0, (f + 1).clamp_max(last_ptr)) - start
        slot = r.to(idt) % deg.clamp_min(1).unsqueeze(1)
        at = (start.unsqueeze(1) + slot).clamp(0, last_idx)
        nbr = indices.index_select(0, at.view(-1)).view(n, fan)
        mask = ((deg > 0) & valid).unsqueeze(1).expand(n, fan)
        per_layer.append((positions[layer], mask.to(torch.uint8).contiguous(),
                          n * (fan + 1)))
        f = torch.cat([f, torch.where(mask, nbr,
                                      torch.zeros((), dtype=idt,
                                                  device=f.device))
                       .view(-1)])
        valid = torch.cat([valid, mask.reshape(-1)])
    blocks = [FanoutBlock(pos, m, ns) for pos, m, ns in reversed(per_layer)]
    if plans:
        for blk in blocks[0 if slot_plans else 1:]:
            blk.plan = tree_scatter_plan(blk.mask, slots=slot_plans)
    return blocks, f


def _launcher():
    lib = _build.load(_SOURCE)
    fn = lib.tree_sample_layer_launch
    if fn.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = ([ptr] * 2 + [i64] * 3 + [ptr, i64] + [ptr] * 4
                       + [i64] * 4 + [ctypes.POINTER(ctypes.c_void_p),
                                      ctypes.POINTER(ctypes.c_uint32), i64]
                       + [ptr] * 6 + [i64] * 3 + [ptr])
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def tree_sample(indptr: torch.Tensor, indices: torch.Tensor,
                seeds: torch.Tensor, fanouts: Sequence[int], key: Key,
                plans: bool = False, slot_plans: bool = False,
                positions: Optional[Sequence[torch.Tensor]] = None
                ) -> Tuple[List[FanoutBlock], torch.Tensor]:
    """:func:`sample_fanout_tree` on the card: the hand-written kernel
    ``csrc/tree_sample.cu``, one launch a layer (the plan of a layer's
    block built by the next launch, and the last block's, with
    ``slot_plans``, by one launch more), counted in
    ``tree_sample.launches``. Gives what the plain path gives from
    :func:`tree_draws` of ``key``, bit for bit: blocks, input ids and
    plans (``src`` with its masked tail). CUDA tensors only."""
    dev = seeds.device
    if dev.type != "cuda":
        raise ValueError(f"tree_sample runs on cuda, not {dev}")
    if indptr.device != dev or indices.device != dev:
        raise ValueError(f"indptr, indices and seeds must share a device; "
                         f"got {indptr.device}, {indices.device}, {dev}")
    if indptr.dtype not in _INDEX_DTYPES or indices.dtype != indptr.dtype \
            or seeds.dtype not in _INDEX_DTYPES:
        raise TypeError(f"indptr and indices must be one of int32 and int64 "
                        f"and seeds either; got {indptr.dtype}, "
                        f"{indices.dtype}, {seeds.dtype}")
    if seeds.dim() != 1 or seeds.numel() < 1 or indptr.numel() < 1 \
            or indices.numel() < 1:
        raise ValueError("seeds must be [B], B >= 1, and the CSR "
                         "non-empty (device_csr)")
    fans = [int(f) for f in reversed(list(fanouts))]   # sampling order
    if not fans or min(fans) < 1:
        raise ValueError(f"fanouts must be positive, got {list(fanouts)}")
    caps = tree_caps(seeds.shape[0], fanouts)
    if caps[-1] >= 2**31:
        raise ValueError(f"a tree of {caps[-1]} nodes is past int32")
    if positions is None:
        positions = tree_positions(seeds.shape[0], fanouts, dev)
    start, rest = kernel_key(key, dev)
    part_ptrs = (ctypes.c_void_p * _MAX_PARTS)(
        *(p.data_ptr() if isinstance(p, torch.Tensor) else None
          for p in rest))
    part_vals = (ctypes.c_uint32 * _MAX_PARTS)(
        *(0 if isinstance(p, torch.Tensor) else p for p in rest))
    seeds = seeds.contiguous()
    isz, i32, u8 = indptr.element_size(), torch.int32, torch.uint8
    ids = torch.empty(caps[-1], dtype=indptr.dtype, device=dev)
    valid = torch.empty(caps[-1], dtype=u8, device=dev)
    nlayers = len(fans)
    masks, plan_list = [], []
    pending = None    # (mask, counts, plan) of a layer whose plan is due
    launch = _launcher()
    for layer in range(nlayers + 1):
        n = caps[layer] if layer < nlayers else 0
        fan = fans[layer] if layer < nlayers else 0
        mask = counts = plan = None
        if n:   # a layer to sample
            mask = torch.empty((n, fan), dtype=u8, device=dev)
            masks.append(mask)
            if plans and (slot_plans or layer < nlayers - 1):
                # each thread block's valid rows, which the plan's scan
                # reads (fewer thread blocks than rows)
                counts = torch.empty(n, dtype=i32, device=dev)
                plan = ScatterPlan(
                    torch.empty(n * (fan + 1) + 1, dtype=i32, device=dev),
                    torch.empty(n * fan, dtype=i32, device=dev),
                    torch.empty(n * fan if slot_plans else n, dtype=i32,
                                device=dev),
                    torch.empty((0, 2), dtype=i32, device=dev),
                    torch.empty(0, dtype=i32, device=dev),
                    torch.empty(1, dtype=i32, device=dev))
        if not n and pending is None:
            break
        p_mask, p_counts, p_plan = pending or (None, None, None)
        p_n, p_fan = (0, 0) if p_mask is None else p_mask.shape
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = launch(
                indptr.data_ptr(), indices.data_ptr(), indptr.numel(),
                indices.numel(), isz,
                seeds.data_ptr() if layer == 0 else None,
                seeds.element_size(), ids.data_ptr(), valid.data_ptr(),
                _ptr(mask), _ptr(counts), n, fan, layer, start, part_ptrs,
                part_vals, len(rest), _ptr(p_mask), _ptr(p_counts),
                *(_ptr(getattr(p_plan, k, None)) for k in
                  ("offsets", "src", "cnt", "long_part")),
                p_n, p_fan, int(slot_plans), stream)
        if err != 0:
            raise RuntimeError(f"tree_sample kernel launch failed: CUDA "
                               f"error {err}")
        tree_sample.launches += 1
        # the launch's least bytes for a step's cost count: each row's
        # indptr pair read, each slot's indices entry read and its id
        # and mask written, the seeds read and written as the first
        # ids, and a plan's arrays written
        prof.note_kernel(0, n * 2 * isz + n * fan * (2 * isz + 1)
                         + (n * (seeds.element_size() + isz)
                            if layer == 0 else 0)
                         + (0 if p_plan is None else p_plan.nbytes()))
        if p_plan is not None:
            plan_list.append(p_plan)
        pending = None if plan is None else (mask, counts, plan)
    blocks = [FanoutBlock(positions[layer], mask, caps[layer + 1])
              for layer, mask in enumerate(masks)]
    for blk, plan in zip(blocks, plan_list):
        blk.plan = plan
    return blocks[::-1], ids


tree_sample.launches = 0


def sample_fanout_tree(indptr: torch.Tensor, indices: torch.Tensor,
                       seeds: torch.Tensor, fanouts: Sequence[int],
                       key: Key, plans: bool = False,
                       slot_plans: bool = False,
                       positions: Optional[Sequence[torch.Tensor]] = None
                       ) -> Tuple[List[FanoutBlock], torch.Tensor]:
    """The tree blocks and input ids of ``seeds`` under the draws of
    ``key`` (:func:`draw_key`'s), plans attached as
    :func:`sample_fanout_tree_from_draws` says: on a CUDA tensor the
    kernel (:func:`tree_sample`), on a CPU tensor the plain path,
    :func:`sample_fanout_tree_from_draws` of :func:`tree_draws`; any
    other device raises. Both give the same blocks, ids and plans bit
    for bit."""
    if seeds.device.type == "cuda":
        return tree_sample(indptr, indices, seeds, fanouts, key, plans,
                           slot_plans, positions)
    if seeds.device.type != "cpu":
        raise ValueError(f"the tree sampler runs on cuda or cpu, not "
                         f"{seeds.device}")
    counters = draw_counters(seeds.shape[0], fanouts, seeds.device)
    return sample_fanout_tree_from_draws(
        indptr, indices, seeds, fanouts, tree_draws(key, counters, fanouts),
        positions=positions, plans=plans, slot_plans=slot_plans)


class TreeSampler:
    """The device sampler at one batch size and fanouts: the constant
    positions on ``device``, and :meth:`sample` for a CSR, a step's
    seeds and a key. ``slot_plans`` (the model's) says which plans the
    blocks carry."""

    def __init__(self, batch_size: int, fanouts: Sequence[int], device,
                 slot_plans: bool = False):
        self.slot_plans = bool(slot_plans)
        self.fanouts = tuple(int(f) for f in fanouts)
        self.caps = tree_caps(batch_size, self.fanouts)
        self.positions = tree_positions(batch_size, self.fanouts, device)

    def sample(self, indptr: torch.Tensor, indices: torch.Tensor,
               seeds: torch.Tensor, key: Key
               ) -> Tuple[List[FanoutBlock], torch.Tensor]:
        """The tree blocks (plans attached) and input ids of ``seeds``
        over the CSR ``(indptr, indices)`` under the draws of ``key``
        (:func:`sample_fanout_tree`)."""
        return sample_fanout_tree(
            indptr, indices, seeds, self.fanouts, key, plans=True,
            slot_plans=self.slot_plans, positions=self.positions)
