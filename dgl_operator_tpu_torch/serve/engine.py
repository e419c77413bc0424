"""Inference engine over a partitioned graph.

The request path: seed node ids → owner routing → per-partition fanout
sample on the host → halo-aware host feature gather → the model's
forward on the card → predictions (``runtime/forward.py``).

Storage is owner-sharded: each partition contributes only its core
feature rows plus a degree-ranked hot-halo cache
(``parallel/halo.build_halo_cache``). A sampled input node resolves, in
order: core row → cache hit → its owner's core row through the halo
ownership manifest; hits and owner fetches are counted
(``serve_halo_cache_hits_total`` / ``serve_halo_remote_rows_total``).
A book of int8 or uint8 codes opens into quantized stores
(``graph/featstore.py``, with the book's sidecar): the rows are
dequantized on the host as they are read, so the server reads the
reconstructed rows the trainer reads.

Params arrive as a flax-layout tree (an export from either package's
``export_for_serving``) and are converted to the model's state dict on
the engine's device at load (``models.state_dict_from_flax``, which
reads the family, ``DistSAGE``, ``DistGAT`` or ``DistGATv2``, from the
tree's layer prefix). :meth:`warmup` runs one all-padding batch
per shape rung before the first request, which also builds the CUDA
kernels.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.graph.blocks import calibrate_caps, fanout_caps
from dgl_operator_tpu_torch.graph.featstore import (PagedFeatureStore,
                                                    emit_dataplane_gauges)
from dgl_operator_tpu_torch.graph.partition import GraphPartition
from dgl_operator_tpu_torch.models import state_dict_from_flax
from dgl_operator_tpu_torch.obs import LATENCY_BUCKETS, get_obs, tracectx
from dgl_operator_tpu_torch.parallel.halo import (DEFAULT_HALO_CACHE_FRAC,
                                                  build_halo_cache)
from dgl_operator_tpu_torch.runtime import forward
from dgl_operator_tpu_torch.runtime.checkpoint import load_params

CAP_POLICIES = ("auto", "worst")
MAX_AOT_SHAPES = 4


@dataclasses.dataclass
class ServeConfig:
    """Request-path knobs."""

    fanouts: Sequence[int] = (10, 25)
    # seeds per padded micro-batch — the one request shape
    batch_size: int = 64
    # micro-batcher deadline: the most latency an under-full batch
    # waits to coalesce (serve/batcher.py)
    max_wait_ms: float = 5.0
    # shape-ladder depth: rung k serves up to batch_size >> 2k seeds
    aot_shapes: int = 1
    # fraction of each partition's halo kept resident as the hot cache
    halo_cache_frac: float = DEFAULT_HALO_CACHE_FRAC
    # "worst": analytic fanout caps (deterministic in batch_size and
    # fanouts); "auto": calibrate from probe batches
    cap_policy: str = "worst"
    cap_margin: float = 1.08
    seed: int = 0
    feat_key: str = "feat"


def _tree_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(np.shape(tree))}


class ServeEngine:
    """Owner-sharded request executor for one partitioned graph and one
    set of params, on ``device`` (the CUDA card unless told otherwise).
    Predict calls are serialized by the batcher's dispatch path."""

    def __init__(self, model: torch.nn.Module, part_cfg: str, params=None,
                 params_path: Optional[str] = None,
                 cfg: Optional[ServeConfig] = None, warm: bool = True,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg = cfg or ServeConfig()
        if (params is None) == (params_path is None):
            raise ValueError("pass exactly one of params / params_path "
                             "(the params-only serving export)")
        if cfg.cap_policy not in CAP_POLICIES:
            raise ValueError(f"cap_policy must be one of {CAP_POLICIES}, "
                             f"got {cfg.cap_policy!r}")
        if not 1 <= int(cfg.aot_shapes) <= MAX_AOT_SHAPES:
            raise ValueError(f"aot_shapes must be in [1, {MAX_AOT_SHAPES}]"
                             f", got {cfg.aot_shapes}")
        self.params = (params if params is not None
                       else load_params(params_path))
        self._weights = self._device_weights(self.params)
        with open(part_cfg) as f:
            meta = json.load(f)
        self.num_parts = int(meta["num_parts"])
        self.n_pad = max(meta[f"part-{p}"]["num_local_nodes"]
                         for p in range(self.num_parts))
        obs = get_obs()
        m = obs.metrics
        self._m_hits = m.counter(
            "serve_halo_cache_hits_total",
            "sampled halo rows answered by the hot cache")
        self._m_remote = m.counter(
            "serve_halo_remote_rows_total",
            "sampled halo rows fetched from their owner partition")
        self._m_forward = m.histogram(
            "serve_forward_seconds",
            "engine batch execution (sample+gather+forward)",
            buckets=LATENCY_BUCKETS)
        self._m_fastpath = m.counter(
            "serve_fastpath_batches_total",
            "batches executed at a sub-capacity ladder shape")
        self._m_nonfinite = m.counter(
            "serve_nonfinite_logits_total",
            "non-finite logit values observed on served requests")
        t0 = time.perf_counter()
        self._csc: List = []
        self._stores: List[PagedFeatureStore] = []
        self._slot_of: List[np.ndarray] = []
        self._owner_m: List[np.ndarray] = []
        self._local_m: List[np.ndarray] = []
        self._core_gids: List[np.ndarray] = []
        self._n_inner: List[int] = []
        caps_auto = None
        for pid in range(self.num_parts):
            p = GraphPartition(part_cfg, pid)
            ni = p.num_inner
            nh = p.graph.num_nodes - ni
            cache_rows = int(round(float(cfg.halo_cache_frac) * nh))
            cache_idx, slot_of = build_halo_cache(
                p.graph.src, p.graph.num_nodes, ni, cache_rows)
            self._csc.append(p.graph.csc())
            self._stores.append(PagedFeatureStore(
                p.graph.ndata[cfg.feat_key], ni, cache_idx,
                sidecar=p.feat_sidecar(cfg.feat_key)))
            self._slot_of.append(slot_of)
            self._owner_m.append(np.asarray(p.halo_owner_part))
            self._local_m.append(np.asarray(p.halo_owner_local))
            self._core_gids.append(np.asarray(p.orig_id[:ni]))
            self._n_inner.append(ni)
            if pid == 0:
                self.node_map = np.asarray(p.node_map)
            if cfg.cap_policy == "auto":
                c = calibrate_caps(
                    self._csc[-1], np.arange(ni), cfg.batch_size,
                    cfg.fanouts, self.n_pad, margin=cfg.cap_margin,
                    seed=cfg.seed)
                caps_auto = (c if caps_auto is None else
                             [max(a, b) for a, b in zip(caps_auto, c)])
        self.caps = (caps_auto if caps_auto is not None
                     else fanout_caps(cfg.batch_size, cfg.fanouts,
                                      self.n_pad))
        # shape ladder: the full rung keeps the configured cap policy;
        # smaller rungs use the analytic caps for their own batch size
        self.shapes = sorted({max(1, cfg.batch_size >> (2 * k))
                              for k in range(int(cfg.aot_shapes))})
        self._shape_caps = {
            bs: (self.caps if bs == cfg.batch_size
                 else fanout_caps(bs, cfg.fanouts, self.n_pad))
            for bs in self.shapes}
        self.nonfinite_logits = 0
        # model forwards run (one per owner partition chunk of a batch)
        self.forward_calls = 0
        self._predict_fn = forward.build_predict_fn(model)
        self.load_seconds = time.perf_counter() - t0
        self.warmup_seconds = 0.0
        self.warm_shapes = 0
        if warm:
            self.warmup()
        obs.emit("serve_engine_ready", parts=self.num_parts,
                 batch_size=cfg.batch_size, device=str(self.device),
                 load_s=round(self.load_seconds, 3),
                 warmup_s=round(self.warmup_seconds, 3))
        # the feature plane: what one part pins against its backing
        # bytes in the storage dtype
        if self._stores:
            emit_dataplane_gauges(
                "serve", self.feat_dtype,
                round(max(s.resident_bytes for s in self._stores)
                      / 2**20, 3),
                backing_mib=round(sum(s.backing_bytes
                                      for s in self._stores) / 2**20, 3),
                paged_rows=int(sum(s.paged_rows for s in self._stores)))

    def _device_weights(self, params) -> dict:
        """``params`` (flax layout) as the model's state dict on the
        engine's device; raises if names or shapes do not match."""
        sd = state_dict_from_flax(params)
        want = {k: tuple(v.shape) for k, v in self.model.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in sd.items()}
        if got != want:
            raise ValueError(f"params do not fit the model: expected "
                             f"{want}, got {got}")
        return {k: v.to(self.device) for k, v in sd.items()}

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Run one all-padding batch through the full sample → gather →
        forward path per shape rung before the first request (on the
        card this builds and loads the kernels)."""
        t0 = time.perf_counter()
        seed_gid = int(self._core_gids[0][0])
        for bs in self.shapes:
            # bs copies of one core seed keep the batch in one partition
            self.predict_logits(np.full(bs, seed_gid, np.int64),
                                sample_seed=-1)
            self.warm_shapes += 1
        self.warmup_seconds = time.perf_counter() - t0
        get_obs().metrics.histogram(
            "serve_warmup_seconds",
            "warm-up run of the request path").observe(self.warmup_seconds)

    def shape_for(self, n: int) -> int:
        """Smallest warmed batch shape that fits ``n`` seeds (the full
        ``batch_size`` when none does)."""
        for bs in self.shapes:
            if n <= bs:
                return bs
        return self.cfg.batch_size

    # ------------------------------------------------------------------
    def _gather(self, part: int, mb) -> np.ndarray:
        """Halo-aware host feature gather against the owner-sharded
        store: core rows locally, cached halo rows from the hot cache,
        misses from the owner's core rows. Returns [in_cap, D] float32,
        value-identical to a gather from the replicated local store."""
        ids = np.asarray(mb.input_nodes)
        ni = self._n_inner[part]
        store = self._stores[part]
        out = np.zeros((len(ids), store.feat_dim), np.float32)
        is_core = ids < ni
        out[is_core] = store.core_rows(ids[is_core])
        hsel = np.nonzero(~is_core)[0]
        if len(hsel):
            hidx = ids[hsel] - ni
            slot = self._slot_of[part][hidx]
            hit = slot >= 0
            out[hsel[hit]] = store.cache_rows(slot[hit])
            miss = hsel[~hit]
            if len(miss):
                midx = hidx[~hit]
                owners = self._owner_m[part][midx]
                rows = self._local_m[part][midx]
                for o in np.unique(owners):
                    sel = owners == o
                    out[miss[sel]] = \
                        self._stores[int(o)].core_rows(rows[sel])
            self._m_hits.inc(int(hit.sum()))
            self._m_remote.inc(len(miss))
        return out

    # ------------------------------------------------------------------
    def predict_logits(self, node_ids, sample_seed: int = 0
                       ) -> np.ndarray:
        """[len(node_ids), C] float32 logits in request order.
        ``sample_seed`` fixes the neighbor-sampling stream."""
        cfg = self.cfg
        node_ids = np.asarray(node_ids, np.int64)
        bs = self.shape_for(len(node_ids))
        if bs < cfg.batch_size:
            self._m_fastpath.inc()
        caps = self._shape_caps[bs]
        weights = self._weights   # one read: a swap mid-request is safe
        out = None
        t0 = time.perf_counter()
        for part, ci, pos in forward.route_by_owner(
                node_ids, self.node_map, bs):
            core_g = self._core_gids[part]
            loc = np.clip(np.searchsorted(core_g, node_ids[pos]),
                          0, len(core_g) - 1)
            if not np.array_equal(core_g[loc], node_ids[pos]):
                raise ValueError("node id not found in its owner "
                                 f"partition {part}")
            with tracectx.span("engine_fanout", cat="serve", part=part,
                               seeds=len(pos)):
                mb = forward.sample_padded(
                    self._csc[part], loc, cfg.fanouts, caps,
                    self.n_pad, bs,
                    forward.part_sample_seed(sample_seed + ci, part))
                h = self._gather(part, mb)
            with tracectx.span("forward_dispatch", cat="serve", part=part):
                blocks = [b.to(self.device) for b in mb.blocks]
                h_dev = torch.from_numpy(h).to(self.device)
                # .cpu() waits for the card
                logits = self._predict_fn(weights, blocks,
                                          h_dev).cpu().numpy()
                self.forward_calls += 1
            nf = int(np.count_nonzero(~np.isfinite(logits[:len(pos)])))
            if nf:
                self.nonfinite_logits += nf
                self._m_nonfinite.inc(nf)
            if out is None:
                out = np.zeros((len(node_ids), logits.shape[-1]),
                               np.float32)
            out[pos] = logits[:len(pos)]
        self._m_forward.observe(time.perf_counter() - t0)
        return (out if out is not None
                else np.zeros((0, 0), np.float32))

    def swap_params(self, new_params):
        """Swap the serving params (a flax-layout tree) and return the
        incumbent tree. The replacement must have the incumbent's
        structure and leaf shapes. Publication is one attribute store,
        atomic under the GIL against in-flight predict calls."""
        old_shapes = _tree_shapes(self.params)
        new_shapes = _tree_shapes(new_params)
        if old_shapes.keys() != new_shapes.keys():
            raise ValueError(
                "param tree structure mismatch vs incumbent")
        for k, shape in new_shapes.items():
            if shape != old_shapes[k]:
                raise ValueError(
                    f"param leaf {k}: shape {shape} != "
                    f"incumbent {old_shapes[k]}")
        weights = self._device_weights(new_params)
        old = self.params
        self.params = new_params
        self._weights = weights
        get_obs().emit("serve_params_swapped", leaves=len(new_shapes))
        return old

    def predict(self, node_ids, sample_seed: int = 0) -> np.ndarray:
        """Predicted class per seed node (int64, request order)."""
        logits = self.predict_logits(node_ids, sample_seed)
        if logits.size == 0:
            return np.zeros(0, np.int64)
        return np.argmax(logits, axis=-1).astype(np.int64)

    # ------------------------------------------------------------------
    def process_batch(self, seeds: np.ndarray, seq: int) -> np.ndarray:
        """The micro-batcher's ``process_fn``: one padded batch of
        coalesced seeds → one prediction per seed."""
        return self.predict(seeds, sample_seed=seq)

    def make_batcher(self, start: bool = True):
        """A MicroBatcher in front of this engine with the config's
        batch shape and coalescing deadline."""
        from dgl_operator_tpu_torch.serve.batcher import MicroBatcher
        b = MicroBatcher(self.process_batch, self.cfg.batch_size,
                         max_wait_s=self.cfg.max_wait_ms / 1000.0,
                         capacity_of=self.shape_for)
        return b.start() if start else b

    # ------------------------------------------------------------------
    @property
    def feat_dtype(self) -> str:
        """The stores' storage dtype (``int8`` for a book of int8
        codes)."""
        return (self._stores[0].stats()["dtype"] if self._stores
                else "float32")

    @property
    def ready(self) -> bool:
        """The warm-up has run (the stores are resident once the
        constructor returns)."""
        return self.warm_shapes > 0

    def stats(self) -> dict:
        """Health snapshot."""
        return {
            "parts": self.num_parts,
            "ready": self.ready,
            "device": str(self.device),
            "batch_size": self.cfg.batch_size,
            "fanouts": list(self.cfg.fanouts),
            "caps": [int(c) for c in self.caps],
            "warm_shapes": self.warm_shapes,
            "shape_ladder": [int(b) for b in self.shapes],
            "forward_calls": int(self.forward_calls),
            "nonfinite_logits": int(self.nonfinite_logits),
            "load_seconds": round(self.load_seconds, 3),
            "warmup_seconds": round(self.warmup_seconds, 3),
            "feat_resident_mib": round(sum(s.resident_bytes
                                           for s in self._stores)
                                       / 2**20, 3),
            "feat_backing_mib": round(sum(s.backing_bytes
                                          for s in self._stores)
                                      / 2**20, 3),
            "feat_paged_rows": int(sum(s.paged_rows
                                       for s in self._stores)),
            "feat_dtype": self.feat_dtype,
        }
