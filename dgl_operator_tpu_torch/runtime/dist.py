"""Partition-parallel GNN training — ``DistTrainer``.

The counterpart of ``dgl_operator_tpu/runtime/dist.py::DistTrainer``
(the reference's ``train_dist.py``): every partition of a book is one
slot with its own feature shard and its own sampler stream, each step
takes one padded minibatch per slot, and one Adam step applies the mean
of the slots' gradients (``parallel/dp.py``). This is the JAX trainer's
single-process form when no ``torch.distributed`` process group is
initialized: every slot is resident on one device (the card unless
``device="cpu"`` is asked for). With a group of ``W`` processes (opened
from the operator's hostfile by ``parallel/bootstrap.py``) each process
loads only its contiguous block ``my_parts`` of ``P / W`` parts, the
processes agree on caps, pair cap and steps per epoch
(``parallel/collectives.py::allreduce_host``), rank 0's weights are
broadcast at construction, and one ``all_reduce`` a step sums the
gradients (``parallel/dp.py``). The model is ``DistSAGE``, ``DistGAT``
or ``DistGATv2``. A slot's step runs through the same kernels as
``SampledTrainer``'s: ``gather_rows`` for its input rows; for SAGE two
``fanout_agg`` and one ``scatter_add_rows`` backward, for GAT two
``gather_rows`` a layer (GATv2: one) and their ``scatter_add_rows``
backward. The slots of a
batch are sampled in parallel on a pool of
``runtime/loop.py::resolve_num_samplers`` threads, each slot's task
doing all of its slot's host work.

Feature layouts (``TrainConfig.feats_layout``):

- ``"replicated"``: slot ``i`` stores its partition's core and halo rows
  (``[P, n_pad, D]``).
- ``"owner"``: slot ``i`` stores its core rows and a degree-ranked hot
  cache of ``halo_cache_frac`` of the halo (``[P, c_pad + H, D]``); the
  sampler translates each batch's input ids into local rows and
  per-owner requests for the cache misses, and one exchange a step
  answers them (``parallel/halo.py``: ``alltoall_serve_rows`` in one
  process, ``alltoall_request_rows`` across a group).

With the device sampler (``TrainConfig.sampler="device"``) each slot's
CSR lives on the device, padded to shapes common to every slot, and a
step samples each slot's tree-form blocks there
(``ops/device_sample.py``), its draws keyed on ``(step seed, part)``;
the epoch's seeds are staged once per slot into a device buffer that
the step indexes with a device counter. The replicated layout gathers
from the slot's own store. The owner layout translates the input ids
into ``(owner, local row)`` through the halo manifest on the device
(cached halo rows point at the slot's own cache): in one process one
``gather_rows`` over every slot's store answers them; in a group an
``all_gather`` ships the requests, each process answers all of them
from its store in one ``gather_rows`` (a zero row for what it does not
own) and one ``all_to_all_single`` returns the rows, each taken from
its owner's answer. ``steps_per_call = K > 1`` needs the device
sampler (as in JAX); on the card a call of K steps is one replay of a
CUDA graph (``runtime/graphs.py``), under a gloo group, which cannot be
captured, K eager steps.

Feature storage (``TrainConfig.feat_dtype``): the store holds float32,
bfloat16, or the int8 or uint8 codes of ``graph/quant.py``, in both
layouts; the exchange moves the store's own bytes, and the rows are
reconstructed to float32 once, after the gather and the merge
(``runtime/forward.py::dequant_rows``), with one global per-column
``scale`` and ``zero`` made on the device at construction. A quantized
book read into the same dtype passes its codes through; a float book
read into codes is calibrated on every rank's core rows; a quantized
book read into a float store is dequantized on the host; a quantized
book read into other codes raises (:meth:`DistTrainer._build_feat_codec`).

The loss runs the model in inference mode (no dropout), as the JAX
trainer's ``seed_loss`` does. Checkpoints and resume follow
``SampledTrainer`` (``runtime/loop.py::run_epochs``); in a group rank 0
publishes them (``RankZeroCheckpoints``). The numerics sentry
(``TrainConfig.sentry``) runs as in ``SampledTrainer``: each step's
``dp_slot_stats`` (norms and non-finite count of the mean gradient,
each slot's loss and non-finite count) from :func:`slot_mean_step`,
captured with the K-step graph, and a ``QualityMonitor`` over the slots'
global ids, so a fault names its partition. The live, chaos and
preemption planes are ``run_epochs``'s, as in ``SampledTrainer``.

The owner layout's exchange pipeline (host sampler; the JAX trainer's
overlap pipeline): each batch's exchange is enqueued ahead of its step
(:meth:`DistTrainer._staged_batches`). ``pipeline_mode="staged"``
enqueues batch t+1's right after step t is dispatched; ``"fused"`` (the
default) enqueues batch t+K's (``K = pipeline_depth``) before step t's
compute, K receive buffers in flight. In one process on the card the
exchange's ``gather_rows`` runs on a side CUDA stream whose event the
step waits on; in a group the request ``all_to_all_single`` runs with
``async_op=True`` until the step answers it. Each mode gives the
synchronous exchange's bits, since the stores the exchange reads never
change. The comm watcher (``obs/comm.py::CommWatcher``, one thread that
waits only on CUDA events recorded on the work's own stream) closes the
exchange's and the step's windows on the host clock and feeds them to
an :class:`~dgl_operator_tpu_torch.runtime.timers.OverlapTracker`; an
epoch's record carries its ``overlap_ratio``, and the heartbeat the
running one. The device sampler keeps its exchange in the step, as in
JAX.

The utilization and comm planes (``obs/prof.py``, ``obs/comm.py``):
each call is instrumented (``dp_train_step``, ``dp_train_step_multi``
for K > 1): its program's cost is counted on its first call, the
collective seams it runs (the gradient mean, the halo exchange) bill
their bytes to its ledger, and the watcher turns each call's window
into the ``comm_*`` metrics and spans. One process holds every local
slot, so the peaks are one card's and the counted cost already covers
every slot (``flops_scale`` 1).

``donate=True`` (the default) updates the parameters and Adam's state
in place; ``donate=False`` rebinds each to a fresh copy before every
call, so a tensor a caller took keeps its values, and runs the calls
eagerly (no CUDA graph), with the same trajectory. A tuned manifest
overlays the ``train``, ``quality`` and ``shard`` knobs
(``autotune/knobs.py::apply_tuned``).

State sharding (``shard_update``, ``shard_rules``, ``zero_stage``,
``tp_axis_size``, ``gather_depth``; the JAX trainer's sharding plane):
the step is :class:`~dgl_operator_tpu_torch.parallel.dp.ShardPlan`'s over
the trainer's mesh (``make_train_mesh(num_parts, tp_axis_size)``, or the
``mesh`` given, whose dp width is then the number of parts trained):
weight-update sharding, ZeRO-3's resident shards gathered at use, and
dim blocks over ``mp``. Every trajectory is the replicated one bit for
bit. Checkpoints hold the logical form (the replicated run's tree), so
they restore under any mesh shape; evaluation, prediction and the
returned weights gather the full parameters first
(``runtime/forward.py::ensure_full_params``). The byte model's
``sharding_summary`` is emitted as the ``train_state_*`` gauges and
bills the memory watermark, with ZeRO-3's ``gather_depth`` term. A
sharded step runs eagerly (no CUDA graph), K = 1 a call, as in JAX.
"""

from __future__ import annotations

import json
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.autotune.knobs import apply_tuned
from dgl_operator_tpu_torch.graph import quant
from dgl_operator_tpu_torch.graph.blocks import (FanoutBlock,
                                                 build_fanout_blocks,
                                                 calibrate_caps, fanout_caps)
from dgl_operator_tpu_torch.graph.featstore import emit_dataplane_gauges
from dgl_operator_tpu_torch.graph.partition import GraphPartition
from dgl_operator_tpu_torch.models import (inference_layer,
                                           state_dict_from_flax)
from dgl_operator_tpu_torch.obs import get_obs, prof
from dgl_operator_tpu_torch.obs import quality as Q
from dgl_operator_tpu_torch.obs.comm import (CommWatcher, call_scope,
                                             register_collective,
                                             reset_ledger)
from dgl_operator_tpu_torch.ops.device_sample import TreeSampler, draw_key
from dgl_operator_tpu_torch.ops.gather import gather_rows
from dgl_operator_tpu_torch.ops.scatter import attach_plans
from dgl_operator_tpu_torch.parallel import collectives
from dgl_operator_tpu_torch.parallel.dp import (ShardPlan,
                                                replicated_summary,
                                                slot_mean_step)
from dgl_operator_tpu_torch.parallel.mesh import (MP_AXIS, SlotMesh,
                                                  make_train_mesh)
from dgl_operator_tpu_torch.parallel.shardrules import emit_state_gauges
from dgl_operator_tpu_torch.parallel.halo import (alltoall_bytes_per_step,
                                                  alltoall_request_rows,
                                                  alltoall_serve_rows,
                                                  build_halo_cache,
                                                  exchange_bytes_per_step,
                                                  request_rows_finish,
                                                  request_rows_start,
                                                  staging_buffer_bytes)
from dgl_operator_tpu_torch.runtime import forward
from dgl_operator_tpu_torch.runtime.checkpoint import (RankZeroCheckpoints,
                                                       train_state)
from dgl_operator_tpu_torch.runtime.graphs import DeviceRun, graph_stats
from dgl_operator_tpu_torch.runtime.loop import (TrainConfig, _call_steps,
                                                 make_adam,
                                                 open_checkpoints,
                                                 resolve_num_samplers,
                                                 run_epochs)
from dgl_operator_tpu_torch.runtime.timers import OverlapTracker, PhaseTimer

# the store's torch dtype for each TrainConfig.feat_dtype
STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8, "uint8": torch.uint8}


class DistTrainer:
    """Partition-parallel trainer over the ``num_parts`` slots of the
    book ``part_cfg``: all of them on ``device``, or, in a process
    group, this process's ``my_parts``. The model must already be on
    ``device``; it trains without dropout. ``mesh`` (a
    :class:`~dgl_operator_tpu_torch.parallel.mesh.SlotMesh`) trains the
    first ``dp`` parts of the book, as the JAX trainer does with its
    mesh; by default ``make_train_mesh(num_parts, cfg.tp_axis_size)``."""

    def __init__(self, model, part_cfg: str, cfg: TrainConfig,
                 device: DeviceLike = None, feat_key: str = "feat",
                 label_key: str = "label",
                 mesh: Optional[SlotMesh] = None):
        self.device = resolve_device(device)
        param_devices = {p.device for p in model.parameters()}
        if param_devices != {self.device}:
            raise ValueError(f"the model's parameters are on "
                             f"{sorted(map(str, param_devices))}, the "
                             f"trainer's device is {self.device}")
        # the tuned manifest's train, quality and shard knobs, where cfg
        # keeps the default
        cfg = apply_tuned(apply_tuned(apply_tuned(cfg), layer="quality"),
                          layer="shard")
        self.model = model
        self.cfg = cfg
        self.feat_key = feat_key
        self.label_key = label_key
        self._owner_layout = cfg.feats_layout == "owner"
        self._device_mode = cfg.sampler == "device"
        # the exchange pipeline: the owner layout's host-sampled batches
        self._pipelined = self._owner_layout and not self._device_mode
        self._gather_depth = cfg.gather_depth
        # the sharding plane: the step is a ShardPlan's
        self._sharded = bool(cfg.shard_update or cfg.shard_rules is not None
                             or cfg.zero_stage == 3)
        self._plan: Optional[ShardPlan] = None
        if int(cfg.steps_per_call) > 1 and not self._device_mode:
            raise ValueError(
                "DistTrainer steps_per_call > 1 requires sampler='device' "
                "(host mode would stack K padded minibatches per slot, "
                "multiplying the staging payload the knob amortizes); use "
                "SampledTrainer for host-sampler calls of K steps")
        if int(cfg.steps_per_call) > 1 and self._sharded:
            raise ValueError("steps_per_call > 1 does not compose with "
                             "shard_update/shard_rules/zero_stage=3 "
                             "(the sharded-update reduce-scatter path "
                             "is per-dispatch)")
        with open(part_cfg) as f:
            meta = json.load(f)
        if mesh is None:
            mesh = make_train_mesh(int(meta["num_parts"]), cfg.tp_axis_size)
        tp = int(cfg.tp_axis_size)
        if tp > 1 and int(mesh.shape.get(MP_AXIS, 1)) != tp:
            raise ValueError(
                f"tp_axis_size={tp} needs a mesh with a {MP_AXIS!r} axis "
                f"of that size (got axes {mesh.shape}); build one with "
                f"make_mesh_2d(num_dp, {tp})")
        self.mesh = mesh
        P = self.num_parts = int(mesh.shape["dp"])
        if P > int(meta["num_parts"]):
            raise ValueError(f"a mesh of {P} dp slots over a book of "
                             f"{meta['num_parts']} parts")
        self._group = collectives.group_active()
        self.rank, self.world_size = collectives.world()
        if self._sharded and cfg.ckpt_dir and self._group:
            # the JAX trainer's guard, kept for parity
            raise ValueError(
                "shard_update checkpointing is single-controller-only:"
                " unset ckpt_dir or shard_update/shard_rules for"
                " multi-process runs")
        if P % self.world_size:
            raise ValueError(f"num_parts={P} is not divisible by the world "
                             f"size {self.world_size}")
        per = P // self.world_size
        # a contiguous block of parts a process, so rank order is part
        # order
        self.my_parts = list(range(self.rank * per, (self.rank + 1) * per))
        self.parts: List[GraphPartition] = [
            GraphPartition(part_cfg, p) for p in self.my_parts]
        L = len(self.parts)
        self.cscs = [p.graph.csc() for p in self.parts]
        self.num_nodes = int(meta["num_nodes"])
        # static shapes common to every slot, from the book's metadata
        info = [meta[f"part-{p}"] for p in range(P)]
        self.n_pad = max(m["num_local_nodes"] for m in info)
        self.c_pad = max(m["num_inner_nodes"] for m in info)
        self.h_pad = max(1, max(m["num_local_nodes"] - m["num_inner_nodes"]
                                for m in info))
        feat_dim = self.parts[0].graph.ndata[feat_key].shape[1]
        # the store's dtype, how a book row becomes a store row, and the
        # global sidecar of a store of codes
        fdt = cfg.feat_dtype
        self._feat_quantized = quant.is_quantized_dtype(fdt)
        self._store_dtype = STORE_DTYPES[fdt]
        host_dtype = np.dtype(fdt) if self._feat_quantized else np.float32
        store_rows, scale, zero = self._build_feat_codec(fdt, feat_dim)
        # made once, before any call: a captured graph reads them in place
        self._feat_scale, self._feat_zero = (
            (None, None) if scale is None else
            tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                  for a in (scale, zero)))
        labels = np.zeros((L, self.n_pad), np.int64)
        for i, p in enumerate(self.parts):
            labels[i, :p.graph.num_nodes] = p.graph.ndata[label_key]
        self.labels = torch.from_numpy(labels).to(self.device)
        self._n_inner = np.asarray([p.num_inner for p in self.parts])
        if self._owner_layout:
            # each slot's core rows, then H hot-cache rows; one spare
            # zero row after every slot answers a -1 exchange request
            H = self.cache_rows = int(round(cfg.halo_cache_frac * self.h_pad))
            R = self._rows_per_slot = self.c_pad + H
            flat = np.zeros((L * R + 1, feat_dim), host_dtype)
            store = flat[:-1].reshape(L, R, feat_dim)
            owner_m = np.full((L, self.h_pad), -1, np.int32)
            local_m = np.zeros((L, self.h_pad), np.int32)
            self._cache_slot: List[np.ndarray] = []
            for i, p in enumerate(self.parts):
                ni = p.num_inner
                feat = p.graph.ndata[feat_key]
                store[i, :ni] = store_rows(feat[:ni])
                nh = p.graph.num_nodes - ni
                owner_m[i, :nh] = p.halo_owner_part
                local_m[i, :nh] = p.halo_owner_local
                cache_idx, slot_of = build_halo_cache(
                    p.graph.src, p.graph.num_nodes, ni, H)
                if len(cache_idx):
                    store[i, self.c_pad:] = store_rows(feat[ni + cache_idx])
                self._cache_slot.append(slot_of)
            self._host_halo = (owner_m, local_m)
            if self._device_mode:
                # the on-device translation cannot read the host cache
                # map: a cached halo row's manifest entry points at this
                # slot's own cache row instead
                dev_owner, dev_local = owner_m.copy(), local_m.copy()
                for i, slot_of in enumerate(self._cache_slot):
                    sel = np.nonzero(slot_of >= 0)[0]
                    dev_owner[i, sel] = self.my_parts[i]
                    dev_local[i, sel] = self.c_pad + slot_of[sel]
                self._dev_halo = tuple(torch.from_numpy(m).to(self.device)
                                       for m in (dev_owner, dev_local))
                self._dev_n_inner = torch.from_numpy(np.asarray(
                    [[p.num_inner] for p in self.parts], np.int32)).to(
                        self.device)
                self._dev_parts = torch.tensor(
                    [[p] for p in self.my_parts], dtype=torch.int32,
                    device=self.device)
            self._flat = torch.from_numpy(flat).to(self.device,
                                                   self._store_dtype)
            self.feats = self._flat[:-1].view(L, R, feat_dim)
        else:
            self.cache_rows = 0
            feats = np.zeros((L, self.n_pad, feat_dim), host_dtype)
            for i, p in enumerate(self.parts):
                feats[i, :p.graph.num_nodes] = store_rows(
                    p.graph.ndata[feat_key])
            self.feats = torch.from_numpy(feats).to(self.device,
                                                    self._store_dtype)
        self.data_feat_mib_per_slot = (self.feats[0].numel()
                                       * self.feats.element_size() / 2**20)
        self.train_ids = [p.node_split("train_mask") for p in self.parts]
        # every part's train count, on every rank: the shuffle stream
        # runs over all of them (_permute)
        counts = np.zeros(P, np.int64)
        counts[self.my_parts] = [len(t) for t in self.train_ids]
        self._train_counts = collectives.allreduce_host(counts, np.sum)
        # every slot takes a step together: the shortest partition sets
        # the epoch
        self.steps_per_epoch = max(
            min(self._train_counts) // cfg.batch_size, 1)
        if self._device_mode:
            self._tree = TreeSampler(cfg.batch_size, cfg.fanouts,
                                     self.device, model.slot_plans)
            self.caps = self._tree.caps
            self._dev_csr = self._device_csrs()
        elif cfg.cap_policy == "auto":
            caps = np.zeros(len(cfg.fanouts) + 1, np.int64)
            for csc, ids in zip(self.cscs, self.train_ids):
                caps = np.maximum(caps, calibrate_caps(
                    csc, ids, cfg.batch_size, cfg.fanouts, self.n_pad,
                    margin=cfg.cap_margin, seed=cfg.seed))
            self.caps = collectives.allreduce_host(caps, np.max)
        else:
            self.caps = fanout_caps(cfg.batch_size, cfg.fanouts, self.n_pad)
        if self._owner_layout and self._device_mode:
            # every input row's request, answered by every owner
            self.pair_cap = 0
            self.exchange_bytes_per_step = exchange_bytes_per_step(
                P, int(self.caps[-1]), feat_dim, self.feats.element_size())
        elif self._owner_layout:
            self.pair_cap = self._calibrate_exchange_cap()
            self.exchange_bytes_per_step = alltoall_bytes_per_step(
                P, self.pair_cap, feat_dim, self.feats.element_size())
        else:
            self.pair_cap = 0
            self.exchange_bytes_per_step = 0
        if self._group:
            collectives.broadcast_params(model)
        self.timer = PhaseTimer()
        self.optimizer = make_adam(model.parameters(), cfg, self.device)
        # the sentry's view of each step's update, and the last call's
        # stats
        self._delta = (Q.ParamDelta(model.parameters()) if cfg.sentry
                       else None)
        self.last_stats: Optional[Dict[str, torch.Tensor]] = None
        # the owner layout's halo rows fetched from other parts, counted
        # on the device by the device sampler's steps (owner_rows)
        self._dev_halo_rows = torch.zeros((), dtype=torch.int64,
                                          device=self.device)
        self._reset_counts()
        # the device sampler's run state, while train() runs
        self._run: Optional[DeviceRun] = None
        self._eval_ctx = None
        self._predict_fn = None
        # the per-partition sampler pool (the reference's --num_samplers
        # processes): built at first use, joined at the end of train()
        self._n_samplers = resolve_num_samplers(cfg)
        self._pool: Optional[ThreadPoolExecutor] = None
        # the pipeline's side stream (one process on the card), the
        # tracker its windows resolve into, and the comm watcher that
        # closes them, while train() runs
        self._exch_stream = None
        self.overlap = OverlapTracker()
        self._watcher: Optional[CommWatcher] = None

    def _build_feat_codec(self, fdt: str, feat_dim: int):
        """How a book row becomes a store row, and the global sidecar
        ``(scale, zero)`` of a store of codes (None for a float store).
        Four cases: a float book into a float store (as it is; a
        bfloat16 store rounds when it is copied to the device); a float
        book into codes (calibrated on the global per-column extrema of
        every rank's core rows, then quantized); a quantized book into
        its own dtype (the codes pass through); a quantized book into a
        float store (dequantized on the host). A quantized book into
        another code dtype raises: re-coding stacks rounding error."""
        book = self.parts[0].feat_sidecar(self.feat_key)
        if book is not None:
            b_scale = np.asarray(book["scale"], np.float32)
            b_zero = np.asarray(book["zero"], np.float32)
            if self._feat_quantized:
                if str(book["dtype"]) != fdt:
                    raise ValueError(
                        f"feat_dtype={fdt!r} but the partition book "
                        f"stores {self.feat_key!r} as "
                        f"{book['dtype']!r} codes — match the book's "
                        "dtype (re-coding stacks rounding error)")
                return (lambda rows: rows), b_scale, b_zero
            return (lambda rows: quant.dequantize(
                rows, b_scale, b_zero)), None, None
        if not self._feat_quantized:
            return (lambda rows: rows), None, None
        # part cores tile the node set: every rank derives the same
        # sidecar from the gathered extrema
        lo = np.full(feat_dim, np.inf, np.float64)
        hi = np.full(feat_dim, -np.inf, np.float64)
        for p in self.parts:
            rows = np.asarray(p.graph.ndata[self.feat_key][:p.num_inner])
            if len(rows):
                lo = np.minimum(lo, rows.min(axis=0))
                hi = np.maximum(hi, rows.max(axis=0))
        lo_g = collectives.host_gather_rows(lo[None])
        hi_g = collectives.host_gather_rows(hi[None])
        scale, zero = quant.merge_column_stats(
            [(lo_g.min(axis=0), hi_g.max(axis=0))], fdt)
        return (lambda rows: quant.quantize(rows, scale, zero, fdt)), \
            scale, zero

    def _rows_f32(self, rows: torch.Tensor) -> torch.Tensor:
        """Store rows reconstructed to float32 with the store's
        sidecar (``runtime/forward.py::dequant_rows``)."""
        return forward.dequant_rows(rows, self._feat_scale, self._feat_zero)

    def _sampler_pool(self) -> Optional[ThreadPoolExecutor]:
        """The pool that samples a batch's slots, None at width 1
        (sampling inline needs no thread); rebuilt after a
        :meth:`_close_sampler_pool`."""
        if self._n_samplers > 1 and self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self._n_samplers,
                                            thread_name_prefix="slot-sampler")
        return self._pool

    def _close_sampler_pool(self) -> None:
        """Join the sampler threads (idempotent)."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    def _device_csrs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every local slot's CSR on the device, padded to shapes common
        to every slot of every process: ``indptr`` ``[L, n_pad + 1]``
        (padded rows of degree 0) and ``indices`` ``[L, E]``, ``E`` the
        largest local edge count (at least 1), int32."""
        e_local = collectives.allreduce_host(
            max(len(c[1]) for c in self.cscs), np.max)
        if max(self.n_pad + 1, e_local) >= 2**31:
            raise ValueError("the device sampler needs int32-addressable "
                             "per-partition CSRs")
        L = len(self.parts)
        indptr = np.zeros((L, self.n_pad + 1), np.int32)
        indices = np.zeros((L, max(e_local, 1)), np.int32)
        for i, (ip, ix, _) in enumerate(self.cscs):
            n = len(ip) - 1
            indptr[i, :n + 1] = ip
            indptr[i, n + 1:] = ip[n]
            indices[i, :len(ix)] = ix
        return (torch.from_numpy(indptr).to(self.device),
                torch.from_numpy(indices).to(self.device))

    # -- the halo exchange's request tables ------------------------------
    def _calibrate_exchange_cap(self, n_probe: int = 8) -> int:
        """Static per-(slot, owner) request cap: probe batches measure
        the largest count of uncached halo rows one slot asks of one
        owner; the cap is that times ``max(cap_margin, 1.25)`` rounded
        up to 64, and never above the rows that exist (the uncached
        rows of a pair, at most the input cap). A later batch above it
        raises in the sampler. In a group the cap is the largest of the
        processes' caps."""
        cfg = self.cfg
        owner_m, _ = self._host_halo
        hard = 0
        for i in range(len(self.parts)):
            nh = len(self._cache_slot[i])
            uncached = (owner_m[i, :nh] >= 0) & (self._cache_slot[i] < 0)
            if uncached.any():
                hard = max(hard, int(
                    np.bincount(owner_m[i, :nh][uncached]).max()))
        hard = min(hard, int(self.caps[-1]))
        measured = 0
        rng = np.random.default_rng(cfg.seed + 811)
        for i in range(len(self.parts)):
            ids = self.train_ids[i]
            if len(ids) == 0:
                continue
            ni = int(self._n_inner[i])
            for probe in range(n_probe):
                seeds = rng.choice(ids, size=min(cfg.batch_size, len(ids)),
                                   replace=False)
                mb = build_fanout_blocks(
                    self.cscs[i], seeds, cfg.fanouts,
                    seed=cfg.seed * 131071 + probe, src_caps=self.caps[1:])
                inp = mb.input_nodes
                halo = inp[inp >= ni] - ni
                halo = halo[self._cache_slot[i][halo] < 0]
                if len(halo):
                    counts = np.bincount(owner_m[i][halo],
                                         minlength=self.num_parts)
                    measured = max(measured, int(counts.max()))
        # a wider floor than the fanout margin: a pair's share of a
        # batch varies more than the frontier's size
        margin = max(float(cfg.cap_margin), 1.25)
        cap = max(-(-int(measured * margin) // 64) * 64, 64)
        return collectives.allreduce_host(min(cap, max(hard, 1)), np.max)

    def _exchange_requests(self, i: int, input_ids: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Local slot ``i``'s padded input ids as ``(loc, req, pos)``: the
        local store row of every position (core rows and cache hits;
        a miss takes row 0, which its answer overwrites), then per owner
        ``[P, pair_cap]`` the owner-local rows of the cache misses
        (``-1`` pads) and the positions their answers land at (pads
        ``len(input_ids)``, past the buffer)."""
        cap = self.pair_cap
        owner_m, local_m = self._host_halo
        ni = int(self._n_inner[i])
        loc = np.where(input_ids < ni, input_ids, 0).astype(np.int32)
        req = np.full((self.num_parts, cap), -1, np.int32)
        pos = np.full((self.num_parts, cap), len(input_ids), np.int32)
        hsel = np.nonzero(input_ids >= ni)[0]
        if len(hsel):
            hidx = input_ids[hsel] - ni
            slot = self._cache_slot[i][hidx]
            hit = slot >= 0
            loc[hsel[hit]] = self.c_pad + slot[hit]
            hsel, hidx = hsel[~hit], hidx[~hit]
            owners = owner_m[i, hidx]
            rows = local_m[i, hidx]
            for o in np.unique(owners):
                m = owners == o
                k = int(m.sum())
                if k > cap:
                    raise ValueError(
                        f"halo-exchange pair cap {cap} exceeded: partition "
                        f"{self.my_parts[i]} requests {k} rows from part "
                        f"{o} in one batch; raise cap_margin (exchange "
                        "caps are calibrated like fanout caps)")
                req[o, :k] = rows[m]
                pos[o, :k] = hsel[m]
        return loc, req, pos

    # -- batches --------------------------------------------------------
    def _permute(self, rng: np.random.Generator) -> List[np.ndarray]:
        """The epoch's shuffle of each local slot's train ids. One numpy
        stream runs over every part of the book in part order, so each
        process draws the shuffles the single process draws: a part held
        elsewhere advances the stream by a permutation of its train
        count (``rng.permutation(ids)`` is ``ids[rng.permutation(len(
        ids))]``, draw for draw)."""
        local = dict(zip(self.my_parts, self.train_ids))
        out = []
        for part, n in enumerate(self._train_counts):
            order = rng.permutation(n)
            if part in local:
                out.append(local[part][order])
        return out

    def _sample_one(self, ids: np.ndarray, i: int, batch_idx: int,
                    step_seed: int):
        """Local slot ``i``'s share of a batch: its padded minibatch of
        batch ``batch_idx`` of ``ids`` on the stream
        ``part_sample_seed(step_seed, part)`` of its global part, the
        transpose plans the model's backward sums over on the card
        (``ops/scatter.py::attach_plans``) and, in the owner layout, its
        exchange tables.
        Depends on ``(ids, batch_idx, step_seed, part)`` alone."""
        cfg = self.cfg
        B = cfg.batch_size
        seeds = ids[batch_idx * B:(batch_idx + 1) * B]
        if len(seeds) == 0 and len(ids):
            seeds = ids[:1]     # a short partition repeats a seed
        # a partition without train seeds gives a batch of padding:
        # zero loss, zero gradients, still one slot of the mean
        mb = forward.sample_padded(
            self.cscs[i], seeds, cfg.fanouts, self.caps, self.n_pad, B,
            forward.part_sample_seed(step_seed, self.my_parts[i]))
        attach_plans(mb.blocks, self.model.slot_plans)
        exch = (self._exchange_requests(i, mb.input_nodes)
                if self._owner_layout else None)
        return mb, len(seeds), exch

    def _sample_all(self, perm: List[np.ndarray], batch_idx: int,
                    step_seed: int) -> Tuple[Dict, int]:
        """Batch ``batch_idx`` of the epoch's permutations ``perm``: every
        local slot's :meth:`_sample_one`, mapped over the sampler pool.
        Returns the host batch and its seed count, scaled to the global
        slot count (exact when the parts are balanced)."""
        pool = self._sampler_pool()
        args = [(ids, i, batch_idx, step_seed) for i, ids in enumerate(perm)]
        if pool is None:
            out = [self._sample_one(*a) for a in args]
        else:
            out = list(pool.map(lambda a: self._sample_one(*a), args))
        mbs = [o[0] for o in out]
        n_seeds = sum(o[1] for o in out) * (self.num_parts // len(out))
        batch = {"mbs": mbs}
        if self._owner_layout:
            batch["exch_loc"] = np.stack([o[2][0] for o in out])
            batch["exch_pos"] = np.stack([o[2][2] for o in out])
            req = np.stack([o[2][1] for o in out])
            if self._group:
                # across processes every slot ships its own requests
                batch["exch_req"] = req
            else:
                # the serve view is the request stack transposed: owner
                # o serves requester r exactly r's request list to o
                batch["exch_serve"] = np.ascontiguousarray(
                    req.transpose(1, 0, 2))
        return batch, n_seeds

    def ship(self, batch: Dict) -> Tuple[List[Dict], Optional[torch.Tensor]]:
        """The host batch on the trainer's device: per slot its blocks,
        seeds and input ids (replicated) or exchange positions (owner),
        and the owner layout's exchange table (the serve tables in one
        process, the request tables in a group). Each array is stacked
        over the slots and copied once."""
        dev = self.device
        mbs = batch["mbs"]

        def put(arr):
            self._counts["h2d_bytes"] += arr.nbytes
            return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

        layers = []
        for l in range(len(mbs[0].blocks)):
            nbr = put(np.stack([mb.blocks[l].nbr for mb in mbs]))
            mask = put(np.stack([mb.blocks[l].mask for mb in mbs]))
            layers.append((nbr, mask))
        seeds = put(np.stack([mb.seeds for mb in mbs]))
        if self._owner_layout:
            per_slot = {"exch_loc": put(batch["exch_loc"]),
                        "exch_pos": put(batch["exch_pos"])}
            # a staged batch's table went with its exchange
            table = batch.get("exch_req" if self._group else "exch_serve")
            exch = None
            if table is not None:
                exch = put(table)
                self._counts["halo_rows"] += int((table >= 0).sum())
        else:
            per_slot = {"inputs": put(np.stack([mb.input_nodes
                                                for mb in mbs]))}
            exch = None
        slots = []
        for i, mb in enumerate(mbs):
            blocks = []
            for (nbr, mask), blk in zip(layers, mb.blocks):
                plan = None
                if blk.plan is not None:
                    self._counts["h2d_bytes"] += blk.plan.nbytes()
                    plan = blk.plan.to(dev)
                blocks.append(FanoutBlock(nbr[i], mask[i], blk.num_src,
                                          plan))
            slots.append({"blocks": blocks, "seeds": seeds[i],
                          **{k: v[i] for k, v in per_slot.items()}})
        return slots, exch

    # -- step -----------------------------------------------------------
    def train_step(self, batch: Dict) -> Tuple[torch.Tensor, None]:
        """One step on a host batch: :meth:`ship` it, then
        :meth:`device_step`, its exchange in the step or, for a batch of
        :meth:`_staged_batches`, the one enqueued ahead. Returns the
        mean slot loss as a device scalar (no sync) and None (no
        accuracy is taken); with the sentry the step's stats are left in
        :attr:`last_stats`."""
        staged = batch.pop("staged", None)
        slots, exch = self.ship(batch)
        if staged is None:
            loss, self.last_stats = self.device_step(slots, exch)
            return loss, None
        loss, self.last_stats = self.device_step(
            slots, None, recv=self._finish_exchange(staged))
        return loss, None

    def device_step(self, slots: List[Dict], exch: Optional[torch.Tensor],
                    recv: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """The step's device work on a shipped batch: the exchange
        (owner layout; ``recv``, its answer, when it was enqueued ahead),
        every local slot's loss and backward, and one Adam step on the
        mean gradient over every slot; returns the mean slot loss and,
        with the sentry, the step's stats (:func:`slot_mean_step`)."""
        if exch is not None:
            exchange = (alltoall_request_rows if self._group
                        else alltoall_serve_rows)
            recv = exchange(self._flat, exch, self._rows_per_slot)
        if recv is not None:
            for i, sb in enumerate(slots):
                sb["recv"] = recv[i]

        def loss_of(i):
            sb = slots[i]
            h = forward.gather_input_rows(self.feats[i], sb,
                                          self._owner_layout,
                                          self._feat_scale, self._feat_zero)
            return forward.seed_loss(self.model, sb["blocks"], h,
                                     sb["seeds"], self.labels[i])

        return slot_mean_step(self.optimizer, loss_of, len(self.parts),
                              self.num_parts, self._delta, self._plan)

    # -- the exchange pipeline ------------------------------------------
    def _watch(self, t0: float, **kw) -> None:
        """Hand the window from ``t0`` to now to the comm watcher: on the
        card it closes when the event recorded here on the current
        stream completes, elsewhere here (``obs/comm.py``)."""
        if self._watcher is None:
            return
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
        self._watcher.watch(ev, t0, **kw)

    def _start_exchange(self, batch: Dict) -> Dict:
        """Enqueue a host batch's exchange ahead of its step; the batch
        keeps the handle under ``"staged"``. In one process on the card
        the table's copy and the exchange's ``gather_rows`` run on the
        side stream; in a group the request ``all_to_all_single`` is
        left in flight (``async_op=True``). The exchange is the
        ``halo_exchange_stage`` program of the comm ledger, its bytes
        the profiler's comm work."""
        table = batch.pop("exch_req" if self._group else "exch_serve")
        self._counts["h2d_bytes"] += table.nbytes
        self._counts["halo_rows"] += int((table >= 0).sum())
        self.timer.add_bytes("exchange", self.exchange_bytes_per_step)
        table = torch.from_numpy(np.ascontiguousarray(table))
        profiler = prof.get_profiler()
        profiler.set_program_cost("halo_exchange_stage", "exchange", 0.0,
                                  self.exchange_bytes_per_step,
                                  source="byte_model")
        profiler.note_call("halo_exchange_stage")
        w0 = time.perf_counter()
        with call_scope("halo_exchange_stage"):
            if self._group:
                handle = request_rows_start(self._flat,
                                            table.to(self.device),
                                            self._rows_per_slot,
                                            async_op=True)
                batch["staged"] = ("group", handle, w0)
                return batch
            if self._exch_stream is None:
                recv = alltoall_serve_rows(self._flat, table.to(self.device),
                                           self._rows_per_slot)
                batch["staged"] = ("ready", recv, None)
                self._watch_exchange(w0, None)
                return batch
            main = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._exch_stream):
                recv = alltoall_serve_rows(self._flat, table.to(self.device),
                                           self._rows_per_slot)
                done = torch.cuda.Event()
                done.record()
        # the step reads recv on the main stream
        recv.record_stream(main)
        self._watch_exchange(w0, done)
        batch["staged"] = ("stream", recv, done)
        return batch

    def _watch_exchange(self, w0: float, done) -> None:
        if self._watcher is not None:
            self._watcher.watch(done, w0, spans=(("halo_exchange",
                                                  "pipeline"),),
                                exchange=(self.overlap,),
                                program="halo_exchange_stage")

    def _finish_exchange(self, staged) -> torch.Tensor:
        """The answer of an exchange :meth:`_start_exchange` enqueued,
        ready for the current stream."""
        kind, obj, mark = staged
        if kind == "group":
            with call_scope("halo_exchange_stage"):
                recv = request_rows_finish(obj)
            self._watch_exchange(mark, None)
            return recv
        if kind == "stream":
            torch.cuda.current_stream(self.device).wait_event(mark)
        return obj

    def _staged_batches(self, batches: Iterator) -> Iterator:
        """The host batch stream with each batch's exchange enqueued
        ahead of its step: ``"staged"`` enqueues a batch's when the loop
        asks for it, right after the previous step was dispatched;
        ``"fused"`` keeps ``pipeline_depth`` batches enqueued beyond
        the one the loop takes, so batch t+K's exchange is enqueued
        before step t's compute."""
        lead = (self.cfg.pipeline_depth
                if self.cfg.pipeline_mode == "fused" else 0)
        ring: deque = deque()
        try:
            for batch, n_seeds in batches:
                ring.append((self._start_exchange(batch), n_seeds))
                if len(ring) > lead:
                    yield ring.popleft()
            while ring:
                yield ring.popleft()
        finally:
            batches.close()

    def _overlap_ratio(self) -> Optional[float]:
        """The share of the exchanges' time hidden under the steps' so
        far this epoch, over the windows the watcher has closed."""
        return self.overlap.ratio()

    # -- the device sampler ---------------------------------------------
    def device_sampler_step(self, seeds: torch.Tensor, gstep: torch.Tensor
                            ) -> Tuple[torch.Tensor, ...]:
        """One device-sampler step on the bank's seeds ``[L, B]``: every
        local slot's tree blocks from the draws keyed on ``(gstep,
        part)``, its input rows (:meth:`owner_rows` in the owner layout),
        then :func:`slot_mean_step`. Returns the mean slot loss, then,
        with the sentry, the step's stats as one vector
        (``obs/quality.py::stat_vector``)."""
        L = len(self.parts)
        indptr, indices = self._dev_csr
        sampled = [self._tree.sample(indptr[i], indices[i], seeds[i],
                                     draw_key(gstep, part))
                   for i, part in enumerate(self.my_parts)]
        rows = (self.owner_rows(torch.stack([inp for _, inp in sampled]))
                if self._owner_layout else None)

        def loss_of(i):
            blocks, inputs = sampled[i]
            h = self._rows_f32(rows[i] if rows is not None
                               else gather_rows(self.feats[i], inputs))
            return forward.seed_loss(self.model, blocks, h, seeds[i],
                                     self.labels[i])

        loss, stats = slot_mean_step(self.optimizer, loss_of, L,
                                     self.num_parts, self._delta, self._plan)
        return (loss,) if stats is None else (loss, Q.stat_vector(stats))

    def owner_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """The owner layout's input rows ``[L, M, D]`` of the local slots'
        device-sampled input ids ``ids`` ``[L, M]`` (slot-local node ids):
        each id becomes ``(owner part, row in its store)`` through the
        device manifest (a core row is the slot's own, a cached halo row
        its own cache row). In one process one ``gather_rows`` over every
        slot's store answers them. In a group the requests go to every
        process (``all_gather``), each answers all of them from its store
        in one ``gather_rows``, a zero row for a row it does not own, and
        one ``all_to_all_single`` brings the answers back; each row is
        taken from its owner's answer, so the rows are exact. The ids
        owned by another part are added to the epoch's halo row count."""
        L, M = ids.shape
        R = self._rows_per_slot
        owner_m, local_m = self._dev_halo
        core = ids < self._dev_n_inner
        h = (ids - self._dev_n_inner).clamp(0, self.h_pad - 1).long()
        owner = torch.where(core, self._dev_parts, owner_m.gather(1, h))
        local = torch.where(core, ids, local_m.gather(1, h))
        self._dev_halo_rows += ((owner >= 0)
                                & (owner != self._dev_parts)).sum()
        # every local slot's exchange
        register_collective("halo_ring", "dp",
                            L * self.exchange_bytes_per_step)
        D = self._flat.shape[1]
        if not self._group:
            # every part is local, slot i holding part i
            flat = torch.where(owner >= 0, owner.long() * R + local,
                               L * R)
            return gather_rows(self._flat, flat.view(-1)).view(L, M, D)
        W = self.world_size
        req = torch.stack([owner, local])
        got = [torch.empty_like(req) for _ in range(W)]
        dist.all_gather(got, req)
        asked = torch.stack(got)                  # [W, 2, L, M]
        ask_owner, ask_local = asked[:, 0], asked[:, 1]
        mine = (ask_owner >= 0) & (torch.div(
            ask_owner, L, rounding_mode="floor") == self.rank)
        row = torch.where(mine, (ask_owner - self.rank * L).long() * R
                          + ask_local, L * R)
        answers = gather_rows(self._flat, row.view(-1))
        back = torch.empty_like(answers)
        dist.all_to_all_single(back, answers)
        # back[q * L * M + j]: process q's answer to my request j
        src = torch.div(owner.clamp_min(0), L, rounding_mode="floor")
        pick = src.long() * (L * M) + torch.arange(
            L * M, device=ids.device).view(L, M)
        return back.index_select(0, pick.view(-1)).view(L, M, D)

    def train_call(self, batch) -> Tuple[torch.Tensor, None]:
        """The steps of one call; returns their mean slot losses ``[k]``
        (no sync) and None. ``batch`` is a host batch (one
        :meth:`train_step`) or, with the device sampler, ``(b, step,
        k)``: ``k`` steps from bank row ``b`` at global step ``step``
        (:class:`DeviceRun`). With the sentry the call's last step's
        stats are left in :attr:`last_stats`."""
        if not self.cfg.donate:
            self._rebind_state()
        if isinstance(batch, dict):
            return self.train_step(batch)[0].view(1), None
        out = self._run(*batch)
        if self._delta is not None:
            self.last_stats = Q.stats_of_rows(out[1:, -1])
        return out[0], None

    def _rebind_state(self) -> None:
        """``donate=False``: every parameter and Adam state tensor to a
        fresh copy, so the tensors a caller took before this call keep
        their values (under a :class:`ShardPlan`, its storage)."""
        if self._plan is not None:
            self._plan.rebind()
            if self._delta is not None:
                self._delta.rebind()
            return
        with torch.no_grad():
            for p in self.model.parameters():
                p.data = p.data.clone()
        for st in self.optimizer.state.values():
            for k, v in st.items():
                if isinstance(v, torch.Tensor):
                    st[k] = v.clone()
        if self._delta is not None:
            self._delta.rebind()

    def _start_device_run(self) -> DeviceRun:
        """The device sampler's run; its calls of K > 1 steps on the card
        are one graph replay each (captured at the first), except under
        a gloo group, which cannot be captured."""
        capture = (self.device.type == "cuda" and self.cfg.donate
                   and self._plan is None and (
                       not self._group or dist.get_backend() == "nccl"))
        # the loss, then the sentry's rows: the scalars and each of the
        # num_parts slots' loss and non-finite count
        n_out = 1 + (len(Q.STAT_KEYS) + 2 * self.num_parts
                     if self._delta is not None else 0)
        self._run = DeviceRun(
            self.device_sampler_step, n_out,
            (self.steps_per_epoch, len(self.parts), self.cfg.batch_size),
            torch.int32, self.cfg.steps_per_call, self.device, capture)
        return self._run

    def _reset_counts(self) -> None:
        self._counts = {"h2d_bytes": 0, "halo_rows": 0}
        self._dev_halo_rows.zero_()

    def _epoch_stats(self, steps: int) -> Dict:
        if self._run is not None:
            # the epoch's seed bank, staged in one copy
            self._counts["h2d_bytes"] += (self._run.bank.numel()
                                          * self._run.bank.element_size())
            self._counts["halo_rows"] += int(self._dev_halo_rows)
        out = {"h2d_bytes_per_step": self._counts["h2d_bytes"] / steps,
               **graph_stats(self._run)}
        if self._owner_layout:
            out["halo_rows_per_step"] = self._counts["halo_rows"] / steps
            out["exchange_mib"] = (self.exchange_bytes_per_step * steps
                                   / 2**20)
        if self._pipelined:
            if self._watcher is not None:
                self._watcher.drain()
            ratio = self._overlap_ratio()
            if ratio is not None:
                out["overlap_ratio"] = ratio
                get_obs().metrics.gauge(
                    "train_overlap_ratio",
                    "fraction of exchange time hidden under compute "
                    "(epoch end)").set(ratio)
            self.overlap.reset()
        self._reset_counts()
        return out

    # -- epoch loop -----------------------------------------------------
    def _configure_prof(self) -> None:
        """Arm the utilization profiler (``obs/prof.py``): one card's
        peaks for the model's compute, the analytic cost fallback and
        the per-slot memory bill the watermark is reconciled against
        (:func:`~dgl_operator_tpu_torch.obs.prof.dist_hbm_bill_mib`, the
        JAX trainer's bill): the state's per-slot MiB under the active
        placement (``self.state_summary``), and under ZeRO-3 the
        ``gather_depth`` largest full parameters in flight."""
        cfg = self.cfg
        L = len(self.parts)
        # a ZeRO-3 plan's parameters are freed between steps: count them
        # by its leaves
        leaves = self._plan.leaves if self._plan is not None else []
        param_count = (sum(lf.numel for lf in leaves) if leaves else
                       sum(p.numel() for p in self.model.parameters()))
        summary = self.state_summary
        param_mib = summary["params_mib_per_slot_sharded"]
        if cfg.zero_stage == 3:
            # the fused gather window keeps up to gather_depth full
            # leaves in flight on top of the resident shards
            param_mib += prof.gather_staging_mib(
                [lf.numel * lf.param.element_size() for lf in leaves],
                self._gather_depth)
        edges = sum(int(c) * int(f) for c, f in zip(self.caps[:-1],
                                                    cfg.fanouts))
        feat_dim = int(self.feats.shape[-1])
        staging = 0
        if self._pipelined:
            staging = staging_buffer_bytes(
                self.num_parts, self.pair_cap, feat_dim,
                depth=(cfg.pipeline_depth + 1
                       if cfg.pipeline_mode == "fused" else 2),
                itemsize=self.feats.element_size())
        csr = (sum(t.numel() * t.element_size() for t in self._dev_csr)
               if self._device_mode else 0)
        predicted = prof.dist_hbm_bill_mib(
            feat_bytes=self.feats.numel() * self.feats.element_size(),
            label_bytes=self.labels.numel() * self.labels.element_size(),
            num_slots=L, params_mib=param_mib,
            opt_state_mib=summary["opt_state_mib_per_slot_sharded"],
            csr_bytes=csr,
            staging_bytes=staging, edges=edges, rows=int(self.caps[-1]),
            feat_dim=feat_dim, prefetch=cfg.prefetch)
        compute = prof.compute_kind(getattr(self.model, "compute_dtype",
                                            None))
        prof.get_profiler().configure(
            peaks=prof.resolve_peaks(device=self.device, compute=compute),
            fallback_cost=prof.analytic_train_cost(
                param_count, int(self.caps[-1]), feat_dim, edges),
            predicted_hbm_mib=round(predicted, 3), flops_scale=1.0,
            device=self.device)

    def train(self, init_params=None) -> Dict:
        """Train ``cfg.num_epochs`` epochs of ``steps_per_epoch`` steps
        from the model's weights, or from ``init_params`` (a flax-layout
        params tree), with a fresh Adam — or, with ``cfg.ckpt_dir`` and
        ``resume="auto"``, from the newest good checkpoint there.
        Returns ``{"params", "opt_state", "history", "step"}`` as
        ``SampledTrainer.train`` does; each record's ``loss`` is its
        last step's mean slot loss."""
        cfg = self.cfg
        if self._plan is not None:
            # a second train() starts from the full weights
            self._plan.materialize()
        if init_params is not None:
            self.model.load_state_dict(state_dict_from_flax(init_params))
        if self._sharded:
            self._plan = ShardPlan(
                self.model, self.mesh,
                lambda ts: make_adam(ts, cfg, self.device),
                shard_update=cfg.shard_update, shard_rules=cfg.shard_rules,
                zero_stage=cfg.zero_stage, gather_depth=self._gather_depth,
                rank=self.rank, world_size=self.world_size)
            self.optimizer = self._plan.optimizer
            self.state_summary = self._plan.summary()
        else:
            self.optimizer = make_adam(self.model.parameters(), cfg,
                                       self.device)
            self.state_summary = replicated_summary(self.model, self.mesh)
        emit_state_gauges(self.state_summary, role="dist")
        ckpt, start_step = open_checkpoints(cfg, self.model, self.optimizer,
                                            plan=self._plan)
        if self._group:
            hi, neg_lo = collectives.allreduce_host(
                [start_step, -start_step], np.max)
            if hi != -neg_lo:
                raise RuntimeError(f"the ranks resume from different steps "
                                   f"({-neg_lo} to {hi}); every rank must "
                                   "read the same checkpoint directory")
            if ckpt is not None:
                ckpt = RankZeroCheckpoints(ckpt, self.rank)
        # the feature plane's bill: the store a slot holds on the device
        # in its storage dtype, and the book's backing bytes
        emit_dataplane_gauges(
            "dist", cfg.feat_dtype, round(self.data_feat_mib_per_slot, 3),
            backing_mib=round(sum(
                int(p.graph.ndata[self.feat_key].nbytes)
                for p in self.parts) / 2**20, 3))
        self.timer.reset()
        self._reset_counts()
        self.overlap.reset()
        self._configure_prof()
        # this run's collectives register afresh
        reset_ledger()
        self._watcher = CommWatcher(device=self.device)
        call = prof.instrument_call("dp_train_step", self.train_call,
                                    multi_name="dp_train_step_multi",
                                    steps=_call_steps)

        def step(batch):
            # the call's window, after the call committed its seams to
            # the ledger; a pipelined step's is the overlap's compute
            t0 = time.perf_counter()
            staged = isinstance(batch, dict) and "staged" in batch
            out = call(batch)
            self._watch(t0, program=call.last_program,
                        **(dict(spans=(("train_compute", "pipeline"),),
                                compute=(self.overlap,)) if staged
                           else {}))
            return out
        stage = None
        if self._pipelined:
            stage = self._staged_batches
            if self.device.type == "cuda" and not self._group:
                self._exch_stream = torch.cuda.Stream(self.device)
                # the stores' copies, made on the main stream, come first
                self._exch_stream.wait_stream(
                    torch.cuda.current_stream(self.device))
        if self._device_mode:
            run = self._start_device_run()

            def sample(perm, call):
                batch, seeds = run.prepare(perm, call)
                return batch, seeds * (self.num_parts // len(perm))
        else:
            def sample(perm, call):
                return self._sample_all(perm, *call[0])
        try:
            # one lookahead thread stages whole batches; the sampler pool
            # splits each batch by slot
            history, gstep = run_epochs(
                cfg, self.timer, self.steps_per_epoch, start_step, ckpt,
                (self._plan.train_state if self._plan is not None
                 else lambda: train_state(self.model, self.optimizer)),
                self._permute, sample, step,
                self.evaluate, self._epoch_stats, sample_workers=1,
                step_stats=lambda: self.last_stats,
                parts=range(self.num_parts), model=self.model,
                overlap_ratio=(self._overlap_ratio if self._pipelined
                               else lambda: None),
                stage=stage)
        finally:
            self._watcher.shutdown()
            self._watcher = None
            self._close_sampler_pool()
            self._exch_stream = None
            # the graph's memory pool goes with it
            self._run = None
        forward.ensure_full_params(self._plan)
        return {"params": self.model.state_dict(),
                "opt_state": (self._plan.logical_optimizer_state_dict()
                              if self._plan is not None
                              else self.optimizer.state_dict()),
                "history": history, "step": gstep}

    # -- evaluation -----------------------------------------------------
    def _eval_context(self):
        """Per local slot its local-to-global ids on the device, and the
        book's labels and masks over the global node ids: every part's
        core rows ``(global id, label, masks)``, padded to ``c_pad``
        rows, gathered from every process (``host_gather_rows``)."""
        if self._eval_ctx is None:
            N = self.num_nodes
            names = [k for k in ("val_mask", "test_mask")
                     if k in self.parts[0].graph.ndata]
            core = np.full((len(self.parts), self.c_pad, 2 + len(names)),
                           -1, np.int64)
            orig = []
            for i, p in enumerate(self.parts):
                ni = p.num_inner
                core[i, :ni, 0] = p.orig_id[:ni]
                core[i, :ni, 1] = p.graph.ndata[self.label_key][:ni]
                for j, k in enumerate(names):
                    core[i, :ni, 2 + j] = p.graph.ndata[k][:ni]
                orig.append(torch.from_numpy(
                    np.asarray(p.orig_id, np.int64)).to(self.device))
            rows = collectives.host_gather_rows(core).reshape(
                -1, core.shape[-1])
            rows = rows[rows[:, 0] >= 0]
            labels = np.zeros(N, np.int64)
            labels[rows[:, 0]] = rows[:, 1]
            masks = {}
            for j, k in enumerate(names):
                m = np.zeros(N, bool)
                m[rows[:, 0]] = rows[:, 2 + j] != 0
                masks[k] = torch.from_numpy(m).to(self.device)
            self._eval_ctx = (orig, torch.from_numpy(labels).to(self.device),
                              masks)
        return self._eval_ctx

    def evaluate(self, mask_names=("val_mask", "test_mask")
                 ) -> Dict[str, float]:
        """Accuracy per node mask of full-neighborhood layer-wise
        inference over the slots: per layer every slot aggregates over
        its local edges (``models.inference_layer``: SAGE's ``gspmm``, or
        the GAT and GATv2 edge softmax; a core node's in-edges are all
        local, so its attention denominator is exact), its core outputs
        go to one global ``[N, D]`` buffer, and
        each slot reads its local rows from there for the next layer. In
        a group one ``all_reduce(SUM)`` joins the processes' buffers for
        the input and after each layer: exact, since each row has one
        non-zero contributor. Every rank computes the same accuracies.
        Every SAGE aggregator is ported."""
        forward.ensure_full_params(self._plan)
        orig, labels, masks = self._eval_context()
        n_inner = [int(n) for n in self._n_inner]

        def joined(buf):
            if self._group:
                dist.all_reduce(buf)
            return buf

        with torch.no_grad():
            buf = torch.zeros(self.num_nodes, self.feats.shape[-1],
                              device=self.device)
            for i, ni in enumerate(n_inner):
                buf[orig[i][:ni]] = self._rows_f32(self.feats[i, :ni])
            buf = joined(buf)
            for li in range(len(self.model.layers)):
                nxt = None
                for i, p in enumerate(self.parts):
                    out = inference_layer(self.model, li, p.graph,
                                          buf[orig[i]])
                    if nxt is None:
                        nxt = out.new_zeros(self.num_nodes, out.shape[1])
                    nxt[orig[i][:n_inner[i]]] = out[:n_inner[i]]
                buf = joined(nxt)
            correct = buf.argmax(-1) == labels
            return {name: float((correct & masks[name]).sum()
                                / masks[name].sum().clamp_min(1))
                    for name in mask_names if name in masks}

    def predict(self, node_ids, sample_seed: int = 0) -> np.ndarray:
        """``[len(node_ids), C]`` float32 logits in request order through
        the serving path (``runtime/forward.py``): route each global id
        to its owner partition, sample its neighborhood on the stream
        ``part_sample_seed(sample_seed + chunk, part)``, gather the input
        rows from the partition's features and run the model in
        inference mode with its current weights. Every owner partition
        must be loaded by this process; another raises ``ValueError``."""
        cfg = self.cfg
        node_ids = np.asarray(node_ids, np.int64)
        local_of = {p: i for i, p in enumerate(self.my_parts)}
        if self._predict_fn is None:
            self._predict_fn = forward.build_predict_fn(self.model)
        forward.ensure_full_params(self._plan)
        weights = dict(self.model.state_dict())
        out = None
        for part, ci, pos in forward.route_by_owner(
                node_ids, self.parts[0].node_map, cfg.batch_size):
            if part not in local_of:
                raise ValueError(f"predict: partition {part} is not loaded "
                                 f"by this process (rank {self.rank} holds "
                                 f"{self.my_parts})")
            p = self.parts[local_of[part]]
            core_g = p.orig_id[:p.num_inner]
            loc = np.clip(np.searchsorted(core_g, node_ids[pos]),
                          0, len(core_g) - 1)
            if not np.array_equal(core_g[loc], node_ids[pos]):
                raise ValueError("predict: node id not found in its owner "
                                 f"partition {part}")
            mb = forward.sample_padded(
                self.cscs[local_of[part]], loc, cfg.fanouts, self.caps,
                self.n_pad,
                cfg.batch_size,
                forward.part_sample_seed(sample_seed + ci, part))
            sc = p.feat_sidecar(self.feat_key)
            h = torch.from_numpy(forward.gather_host_rows(
                p.graph.ndata[self.feat_key], mb,
                None if sc is None else sc["scale"],
                None if sc is None else sc["zero"])).to(self.device)
            blocks = [b.to(self.device) for b in mb.blocks]
            logits = self._predict_fn(weights, blocks, h).cpu().numpy()
            if out is None:
                out = np.zeros((len(node_ids), logits.shape[-1]),
                               np.float32)
            out[pos] = logits[:len(pos)]
        return out if out is not None else np.zeros((0, 0), np.float32)
