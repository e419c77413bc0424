"""KGE training and ranking evaluation (the DGL-KE runtime).

The counterpart of the JAX package's ``runtime/kge.py``: the reference's
parameter-server training (``dglke_server``/``dglke_client``), with the
sharded-embedding pull and push of ``parallel/embedding.py`` in place of
KVStore RPC.

- A step gathers the entity rows ``h || t || neg`` and the relation rows
  ``r`` with ``gather_rows`` into leaf tensors and takes the loss's
  gradient with respect to those rows, not the tables, so the gradients
  are row-sparse by construction (the pull).
- The entities push ``h || t || neg`` and the relations ``r`` with
  row-sparse Adagrad (``ops/adagrad.py``; the push): ``scatter_add_rows``
  sums each row's gradients over a plan the host builds next to the
  sampler, and only the touched rows change.

:class:`DistKGETrainer` trains the slots of a mesh
(``parallel/mesh.py``), each with its own relation-aware edge partition
and sampler streams. On a 1-D ``(dp,)`` mesh the entity table is sharded
over every slot (slot ``s`` owns a block of rows); on a ``dp x mp`` grid
it is sharded over ``mp`` and replicated over ``dp``, and each shard
sums the gradient rows of every dp replica before its update
(the dp-replica reduction of ``parallel/embedding.py``). In one process every
slot lives on one device; in a ``torch.distributed`` group each process
holds the slots of its rank (``my_slots``; on a grid, whole dp rows and
so the whole table). Every process draws every slot's batch on its host
(cheap), so it builds its exchange routes and push plans with no
exchange of ids; only rows, gradients and one ``all_reduce`` a step
(the relation accumulator and the slots' losses) cross processes. Per
update: one corruption side for every slot; the entity push summed over
the slots in slot order; the relation gradient summed over the slots
and divided by their count; the loss the slots' mean.
:class:`KGETrainer` is the single-device trainer: one slot, whose
relation gradient is not divided (dividing by 1 is exact).

``neg_sampler="device"``: the host step carries no negative ids. Each
slot's ``[C, N]`` negatives are drawn on the device from the update's
seed and the slot (``ops/kge_negatives.py``); their lookup and the
entity push go through ``device_lookup`` and ``device_push_adagrad``,
whose push plan is built on the device, so no update waits for the
card on the draws. ``num_client`` = K > 1: each slot runs K logical
clients over a dataset partitioned into ``num_slots * K`` ranks
(logical rank ``slot * K + c``), and a step makes K interleaved
updates, as the reference's clients interleave through the KVStore.

:func:`full_ranking_eval` scores every entity as the corruption of each
side in one ``[B, D] x [D, Ne]`` product per batch and reports MR, MRR
and Hits@{1,3,10}, raw or filtered;
:meth:`DistKGETrainer.sharded_ranking_eval` scores each block in place
and combines the counts.

The numerics sentry (``KGETrainConfig.sentry``, on by default;
``obs/quality.py``): every update also computes, from the step's own row
gradients, each slot's loss and non-finite count (the loss counted when
it is not finite) and the global gradient norm over the entity,
negative and relation row gradients of every slot. The loop keeps its
no-sync form: it pushes them to a ``StatsTap`` and feeds a
``QualityMonitor`` over the slots what is ready; a fault goes through
``halt_for_rollback``. The stats only read the step's tensors, so the
tables' trajectory is bit-identical with the sentry on or off. The loop
starts the live sidecar when ``TPU_OPERATOR_LIVE_PORT`` is set, and a
tuned manifest overlays the ``kge`` and ``quality`` knobs
(``autotune/knobs.py::apply_tuned``).

Relation ``shard_rules`` (``KGETrainConfig.shard_rules``, item 8.4):
rules over ``{"entity", "relation"}`` (``parallel/shardrules.py``) may
restate the entity table's sharding or replicate it, and may shard the
relation table and its Adagrad sums over the dp axis, their rows padded
to a multiple of its size. In one process the blocks are one padded
table; in a group each process keeps the blocks of its dp rows, the
step gathers the whole table before its lookups (ZeRO-3's gather at
use) and each process updates the union rows of its own blocks from the
all-reduced accumulator, so the trajectory is the unsharded one bit for
bit. :meth:`DistKGETrainer.state_sharding_summary` is the byte model's
summary of the placement, emitted as the ``train_state_*`` gauges
(``role="kge"``) when training starts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.autotune.knobs import apply_tuned, validate
from dgl_operator_tpu_torch.graph.kge_sampler import (
    BidirectionalOneShotIterator, KGEBatch, TrainDataset)
from dgl_operator_tpu_torch.models.kge import (KGEConfig, KGEModel,
                                               init_kge_params, relation_dim)
from dgl_operator_tpu_torch.obs import quality as Q
from dgl_operator_tpu_torch.obs import trace
from dgl_operator_tpu_torch.obs.comm import register_collective
from dgl_operator_tpu_torch.obs.live import maybe_start_sidecar
from dgl_operator_tpu_torch.ops.adagrad import adagrad_rows_, sparse_adagrad_
from dgl_operator_tpu_torch.ops.gather import gather_rows
from dgl_operator_tpu_torch.ops.kge_negatives import (draw_counters,
                                                      draw_negatives,
                                                      negatives_from_draws,
                                                      update_seed)
from dgl_operator_tpu_torch.ops.scatter import (ScatterPlan, pack_int32,
                                                scatter_add_rows, scatter_plan,
                                                ship_int32, unpack)
from dgl_operator_tpu_torch.parallel import collectives
from dgl_operator_tpu_torch.parallel import shardrules as sr
from dgl_operator_tpu_torch.parallel.shardrules import emit_state_gauges
from dgl_operator_tpu_torch.parallel.embedding import (
    ShardedTableSpec, all_gather_rows, device_lookup, device_push_adagrad,
    gather_blocks, my_block, pad_rows, route, sharded_lookup,
    sharded_push_adagrad)
from dgl_operator_tpu_torch.parallel.mesh import SlotMesh, make_mesh, my_slots
from dgl_operator_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                       RankZeroCheckpoints)
from dgl_operator_tpu_torch.runtime.loop import prefetch_map
from dgl_operator_tpu_torch.runtime.timers import PhaseTimer

# host steps (batches, routes and plans) built ahead of the device step
# on one sampler thread
PREFETCH = 2


@dataclasses.dataclass
class KGETrainConfig:
    """The JAX ``KGETrainConfig``'s fields and defaults. ``shard_rules``
    shards the relation table over dp (``DistKGETrainer``; item 8.4).
    ``neg_sampler``, ``num_client``,
    ``sentry`` and the ``quality_*`` fields are validated against the
    knob registry (``autotune/knobs.py``). ``neg_sampler``,
    ``num_client``, ``ckpt_dir``, ``ckpt_every`` and ``resume`` are read
    by ``DistKGETrainer`` only, as in the JAX package."""

    lr: float = 0.25               # the dglke default
    max_step: int = 1000
    batch_size: int = 1024
    neg_sample_size: int = 256
    neg_chunk_size: Optional[int] = None
    log_interval: int = 100
    seed: int = 0
    neg_sampler: str = "host"
    num_client: int = 1
    shard_rules: Optional[tuple] = None
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0            # steps; 0 = only at train()'s end
    resume: str = "auto"           # "auto" | "never"
    # the numerics sentry and its detectors (obs/quality.py), as in
    # TrainConfig; the trajectory is bit-identical either way
    sentry: bool = True
    quality_action: str = "rollback"   # halt | rollback | warn
    quality_window: int = 32
    quality_z_max: float = 6.0
    quality_grad_ratio_max: float = 50.0
    quality_plateau_window: int = 0
    quality_plateau_rel: float = 1e-3

    def __post_init__(self):
        for name in ("neg_sampler", "num_client", "sentry",
                     "quality_action", "quality_window", "quality_z_max",
                     "quality_grad_ratio_max", "quality_plateau_window",
                     "quality_plateau_rel"):
            setattr(self, name, validate(name, getattr(self, name)))
        for _, spec in self.shard_rules or ():
            sr.to_pspec(spec)      # a spec that is no spec raises
        validate("resume", self.resume)
        if self.ckpt_every < 0 or self.log_interval < 1:
            raise ValueError("ckpt_every must be >= 0 and log_interval "
                             ">= 1")

    @property
    def chunk(self) -> int:
        return self.neg_chunk_size or self.batch_size


@dataclasses.dataclass
class _HostStep:
    """One update's host side: the corruption side, every array the
    device step needs packed into one int32 buffer (in pinned memory for
    a card, so its copy does not wait for the card), and the entity
    route whose exchange counts stay on the host (None with device
    negatives, whose seed ``seed_u`` the step carries instead)."""
    mode: str
    buf: torch.Tensor
    shapes: list
    ent_route: object
    n_ent: int                    # entity arrays in the buffer
    seed_u: Optional[int] = None


class DistKGETrainer:
    """KGE training over the slots of ``mesh`` (a :class:`SlotMesh`;
    default ``make_mesh(num_slots)``, a 1-D mesh of ``num_slots`` slots,
    1 when neither is given): all on ``device`` (the current card when
    None), or, in a process group, this process's ``my_slots``. Tables
    are drawn from ``tcfg.seed`` (``init_kge_params``), so every process,
    every mesh shape and a single-process run start from the same
    tables."""

    _uses_group = True
    _device_negs_ok = True

    def __init__(self, cfg: KGEConfig, tcfg: KGETrainConfig,
                 num_slots: Optional[int] = None, device: DeviceLike = None,
                 mesh: Optional[SlotMesh] = None):
        self.device = resolve_device(device)
        # the tuned manifest's kge and quality knobs, where tcfg keeps
        # the default
        tcfg = apply_tuned(apply_tuned(tcfg, layer="kge"), layer="quality")
        # the trace switch: the timer's span aggregates
        trace.configure()
        self.cfg, self.tcfg = cfg, tcfg
        self.model = KGEModel(cfg)
        # the last update's stats (device tensors), with the sentry
        self.last_stats: Optional[Dict[str, torch.Tensor]] = None
        if mesh is None:
            mesh = make_mesh(1 if num_slots is None else int(num_slots))
        elif num_slots is not None and int(num_slots) != mesh.size:
            raise ValueError(f"num_slots={num_slots} but the mesh "
                             f"{mesh.shape} has {mesh.size} slots")
        self.mesh = mesh
        self.nslots = mesh.size
        self.device_negs = (self._device_negs_ok
                            and tcfg.neg_sampler == "device")
        self.num_client = tcfg.num_client if self._device_negs_ok else 1
        self._group = self._uses_group and collectives.group_active()
        self.rank, self.world_size = (collectives.world() if self._group
                                      else (0, 1))
        if self.nslots < 1:
            raise ValueError(f"a mesh of {self.nslots} slots")
        self.my_slots = my_slots(mesh, self.rank, self.world_size)
        self.spec = ShardedTableSpec(cfg.n_entities, cfg.hidden_dim,
                                     mesh.num_shards)
        # the processes the table's blocks are split over: each holds the
        # whole table on a grid (its replicas are across processes)
        self.block_world = 1 if mesh.replicas > 1 else self.world_size
        self.block_rank = self.rank if self.block_world > 1 else 0
        # the relation accumulator is the slots' sum over their count,
        # as the JAX step's psum / nslots
        self.rel_divisor = self.nslots
        if self._group:
            mine = [self.nslots, mesh.num_shards, cfg.n_entities,
                    cfg.n_relations, cfg.hidden_dim, tcfg.batch_size,
                    tcfg.neg_sample_size, tcfg.max_step, tcfg.seed,
                    int(self.device_negs), self.num_client]
            if collectives.allreduce_host(mine, np.min) != \
                    collectives.allreduce_host(mine, np.max):
                raise ValueError("the processes of the group disagree on "
                                 "the KGE configuration")
        self._parse_shard_rules()
        if self.device_negs:
            self._counters = draw_counters(
                tcfg.batch_size // tcfg.chunk, tcfg.neg_sample_size,
                self.device)
        init = init_kge_params(cfg, torch.Generator().manual_seed(tcfg.seed))
        self.load_state_dict({
            "entity": init["entity"].numpy(),
            "entity_state": np.zeros(cfg.n_entities, np.float32),
            "relation": init["relation"].numpy(),
            "relation_state": np.zeros(cfg.n_relations, np.float32)})
        self.timer = PhaseTimer()

    # -- state -----------------------------------------------------------
    def _parse_shard_rules(self) -> None:
        """Check ``tcfg.shard_rules`` against this mesh and derive the
        relation placement (the JAX trainer's): ``_rel_sharded``,
        ``_rel_axis`` (the dp axis), ``_rel_pad`` (rows padded to a
        multiple of its size) and this process's block of rows
        ``[_rel_lo, _rel_hi)`` (all of them in one process)."""
        self._rel_sharded = False
        self._rel_axis = self.mesh.axis_names[0]
        self._rel_pad = self.cfg.n_relations
        self._rel_lo, self._rel_hi = 0, self.cfg.n_relations
        self._rel_split = False
        rules = self.tcfg.shard_rules
        if not rules:
            return
        shard_axis = self.mesh.table_axis
        like = {"entity": sr.ShapeLeaf((self.cfg.n_entities,
                                        self.cfg.hidden_dim)),
                "relation": sr.ShapeLeaf((self.cfg.n_relations,
                                          relation_dim(self.cfg)))}
        specs = sr.match_partition_rules(rules, like)
        ent_axes = list(sr.spec_axes(specs["entity"]))
        if ent_axes and ent_axes != [shard_axis]:
            raise ValueError(
                f"shard_rules maps 'entity' to {ent_axes}; the entity "
                f"table is owned by ShardedTableSpec on axis "
                f"{shard_axis!r} — a rule may only restate that "
                "or replicate")
        rel_axes = list(sr.spec_axes(specs["relation"]))
        if not rel_axes:
            return
        if rel_axes != [self._rel_axis]:
            raise ValueError(
                f"shard_rules maps 'relation' to {rel_axes}; the "
                "relation table shards over the dp axis "
                f"({self._rel_axis!r} on this mesh)")
        nrel = int(self.mesh.shape[self._rel_axis])
        self._rel_sharded = True
        self._rel_pad = -(-self.cfg.n_relations // nrel) * nrel
        # a process holds whole dp rows of slots, so its blocks are
        # rank-contiguous
        self._rel_split = self._group and self.world_size > 1
        block = self._rel_pad // self.world_size
        self._rel_lo, self._rel_hi = ((self.rank * block,
                                       (self.rank + 1) * block)
                                      if self._rel_split
                                      else (0, self._rel_pad))

    def _relation_table(self) -> torch.Tensor:
        """The whole (padded) relation table for a lookup: this
        process's rows, or, where the blocks are split over the group,
        every process's gathered in rank order (the gather at use)."""
        if not self._rel_split:
            return self.relation
        register_collective("rel_allgather", self._rel_axis,
                            self._rel_pad * self.relation.shape[1]
                            * self.relation.element_size())
        return all_gather_rows(self.relation, True)

    def state_sharding_summary(self) -> Dict[str, float]:
        """The byte model's per-slot state bytes under the active
        placement (``parallel/shardrules.py::sharding_summary``), the
        JAX trainer's numbers for the same tables and mesh."""
        rel_rows = self._rel_pad if self._rel_sharded else \
            self.cfg.n_relations
        params = {"entity": sr.ShapeLeaf((self.spec.padded_rows,
                                          self.cfg.hidden_dim)),
                  "relation": sr.ShapeLeaf((rel_rows,
                                            relation_dim(self.cfg)))}
        opt = {"entity": sr.ShapeLeaf((self.spec.padded_rows,)),
               "relation": sr.ShapeLeaf((rel_rows,))}
        rel_spec = sr.to_pspec(self._rel_axis if self._rel_sharded
                               else None)
        specs = {"entity": sr.to_pspec(self.mesh.table_axis),
                 "relation": rel_spec}
        return sr.sharding_summary(params, opt, specs, specs,
                                   dict(self.mesh.shape))

    def _host_table(self, block: torch.Tensor) -> np.ndarray:
        """The whole padded table on the host from this process's block
        (a collective where the blocks are split over processes)."""
        if self.block_world == 1:
            return block.detach().cpu().numpy().copy()
        return gather_blocks(block)

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Logical (de-padded) host arrays of the whole training state:
        ``entity``, ``entity_state``, ``relation``, ``relation_state``,
        the same on every mesh shape. Where the blocks are split over a
        group every process gathers every block (a collective)."""
        ne, nr = self.cfg.n_entities, self.cfg.n_relations

        def rel(t):
            if self._rel_split:
                return gather_blocks(t)[:nr]
            return t.cpu().numpy()[:nr].copy()

        return {"entity": self._host_table(self.entity)[:ne],
                "entity_state": self._host_table(self.ent_state)[:ne],
                "relation": rel(self.relation),
                "relation_state": rel(self.rel_state)}

    def load_state_dict(self, sd) -> None:
        """Take a :meth:`state_dict` of any mesh shape (numpy arrays or
        tensors, e.g. from ``kge_state_from_numpy``): pad the entity
        arrays to this mesh's blocks and keep this process's."""
        cfg = self.cfg
        want = {"entity": (cfg.n_entities, cfg.hidden_dim),
                "entity_state": (cfg.n_entities,),
                "relation": (cfg.n_relations, relation_dim(cfg)),
                "relation_state": (cfg.n_relations,)}
        host = {}
        for k, shape in want.items():
            v = sd[k]
            # a copy: the trainer updates its tables in place
            v = np.array(v.detach().cpu() if isinstance(v, torch.Tensor)
                         else v, np.float32)
            if v.shape != shape:
                raise ValueError(f"state_dict[{k!r}] has shape {v.shape}, "
                                 f"expected {shape}")
            host[k] = v

        def block(a):
            full = pad_rows(a, self.spec.padded_rows)
            return torch.from_numpy(np.ascontiguousarray(my_block(
                full, self.block_rank, self.block_world))).to(self.device)

        def rel(a):
            # the relation rows padded to the dp axis and this process's
            # block of them, when the rules shard them
            if self._rel_sharded:
                a = pad_rows(a, self._rel_pad)[self._rel_lo:self._rel_hi]
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device)

        self.entity = block(host["entity"])
        self.ent_state = block(host["entity_state"])
        self.relation = rel(host["relation"])
        self.rel_state = rel(host["relation_state"])

    def gathered_params(self) -> Dict[str, torch.Tensor]:
        """``{"entity": [Ne, D], "relation": [Nr, Dr]}`` on the trainer's
        device, the entity table gathered from every block (a collective
        where the blocks are split over a group)."""
        ent = self._host_table(self.entity)[:self.cfg.n_entities]
        return {"entity": torch.from_numpy(np.ascontiguousarray(ent)).to(
            self.device), "relation": self._relation_table()[
                :self.cfg.n_relations].clone()}

    # -- one update ------------------------------------------------------
    def host_step(self, batches: Sequence[KGEBatch],
                  seed_u: Optional[int] = None) -> _HostStep:
        """The host side of one update from every slot's batch (slot
        order): the entity route of this process's requests (``h || t ||
        neg`` of each of its slots) with its push plan, the relation ids
        of its slots, the union of every slot's relation ids and each of
        its slots' relation push plan into that union. With device
        negatives the entity arrays are its slots' ``h || t`` alone and
        ``seed_u`` the update's seed (``ops/kge_negatives.py``)."""
        if len(batches) != self.nslots:
            raise ValueError(f"{len(batches)} batches for {self.nslots} "
                             "slots")
        modes = {b.neg_mode for b in batches}
        if len(modes) != 1:
            raise ValueError(f"one corruption side an update, got {modes}")
        L = len(self.my_slots)
        if self.device_negs:
            if seed_u is None:
                raise ValueError("device negatives need the update's seed")
            ent_route = None
            arrays = [np.concatenate([np.concatenate([batches[s].h,
                                                      batches[s].t])
                                      for s in self.my_slots])]
        else:
            ent = [np.concatenate([b.h, b.t, b.neg_ids.reshape(-1)])
                   for b in batches]
            if self.block_world == 1:
                # every slot's requests: a whole-table process looks up
                # its own and pushes every slot's (the dp reduction)
                ent_route = route([np.concatenate(ent)], self.spec, 0)
            else:
                reqs = [np.concatenate(ent[p * L:(p + 1) * L])
                        for p in range(self.world_size)]
                ent_route = route(reqs, self.spec, self.rank)
            arrays = ent_route.arrays()
        n_ent = len(arrays)
        union = np.unique(np.concatenate([b.r for b in batches]))
        arrays += [np.concatenate([batches[s].r for s in self.my_slots]),
                   union]
        if self._rel_split:
            # the union rows of this process's relation block: their
            # places in the union and their rows in the block
            own = np.nonzero((union >= self._rel_lo)
                             & (union < self._rel_hi))[0]
            arrays += [own, union[own] - self._rel_lo]
        for s in self.my_slots:
            inv = np.searchsorted(union, batches[s].r).astype(
                np.int32)[:, None]
            plan = scatter_plan(inv, None, len(union))
            arrays += [inv] + [getattr(plan, k) for k in ScatterPlan.FIELDS]
        buf, shapes = pack_int32(arrays)
        buf = torch.from_numpy(buf)
        if self.device.type == "cuda":
            buf = buf.pin_memory()
        return _HostStep(modes.pop(), buf, shapes, ent_route, n_ent, seed_u)

    def ship(self, hs: _HostStep) -> List[torch.Tensor]:
        """A host step's arrays on the device, in one copy that does not
        wait for the device's queue."""
        return unpack(hs.buf.to(self.device, non_blocking=True), hs.shapes)

    def device_step(self, hs: _HostStep) -> torch.Tensor:
        """One update on the device from a :meth:`host_step`; returns the
        slots' mean loss (a device scalar, no sync)."""
        return self.update(hs, self.ship(hs))

    def device_step_from_draws(self, hs: _HostStep, draws) -> torch.Tensor:
        """:meth:`device_step` with this process's slots' negatives
        ``draws`` (``[len(my_slots), C, N]``) made elsewhere, e.g. JAX's
        ``jax.random.randint`` draws, in place of the device's own."""
        return self.update(hs, self.ship(hs), negatives_from_draws(
            draws, self.cfg.n_entities, self.device))

    def negatives(self, seed_u: int) -> torch.Tensor:
        """This process's slots' ``[L, C, N]`` device negatives of the
        update seeded ``seed_u``."""
        t = self.tcfg
        return draw_negatives(seed_u, self.my_slots, self._counters,
                              t.batch_size // t.chunk, self.cfg.n_entities)

    def _lookup(self, hs: _HostStep, arrs, negs):
        """This process's slots' entity rows ``h || t || neg`` a slot, the
        route or the device ids they came by, and the relation arrays."""
        t = self.tcfg
        B, L = t.batch_size, len(self.my_slots)
        if not self.device_negs:
            rt = hs.ent_route.rebuilt(arrs[:hs.n_ent])
            if self.block_world == 1:
                m = 2 * B + t.batch_size // t.chunk * t.neg_sample_size
                lo = self.my_slots[0] * m
                register_collective("emb_lookup", self.mesh.table_axis,
                                    L * m * (4 + self.entity.shape[1]
                                             * self.entity.element_size()))
                return gather_rows(self.entity, rt.serve[lo:lo + L * m]), rt
            return sharded_lookup(self.entity, rt,
                                  axis=self.mesh.table_axis), rt
        if negs is None:
            negs = self.negatives(hs.seed_u)
        ids = torch.cat([arrs[0].view(L, 2 * B), negs.reshape(L, -1)],
                        1).reshape(-1)
        return device_lookup(self.entity, ids, self.spec, self.block_rank,
                             self.block_world,
                             axis=self.mesh.table_axis), ids

    def _push(self, g: torch.Tensor, how) -> None:
        t = self.tcfg
        if self.device_negs:
            device_push_adagrad(self.entity, self.ent_state, how, g,
                                self.spec, self.block_rank, self.block_world,
                                t.lr, self._group, axis=self.mesh.table_axis)
        elif self.block_world == 1:
            # the dp-replica reduction: every replica's rows in slot order
            rows = all_gather_rows(g, self._group)
            register_collective("emb_push", self.mesh.table_axis,
                                rows.shape[0] * (4 + rows.shape[1]
                                                 * rows.element_size()))
            sparse_adagrad_(self.entity, self.ent_state, rows, how.push,
                            t.lr)
        else:
            sharded_push_adagrad(self.entity, self.ent_state, g, how, t.lr,
                                 axis=self.mesh.table_axis)

    def update(self, hs: _HostStep, arrs: List[torch.Tensor],
               negs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The update of a shipped host step (:meth:`ship`), with device
        negatives ``negs`` (``[len(my_slots), C, N]``; drawn from the
        step's seed when None). With the sentry its stats are left in
        :attr:`last_stats`: ``grad_norm`` (the norm over every slot's
        entity, negative and relation row gradients), ``nonfinite``
        (their non-finite elements and the non-finite losses), and per
        slot ``part_loss`` and ``part_nonfinite`` (``[num_slots]``), as
        the JAX step returns them."""
        cfg, t = self.cfg, self.tcfg
        ent_rows, how = self._lookup(hs, arrs, negs)
        rel_ids, union = arrs[hs.n_ent:hs.n_ent + 2]
        k0 = hs.n_ent + 2
        if self._rel_split:
            own, own_rows = arrs[k0:k0 + 2]
            k0 += 2
        rel_plans = arrs[k0:]
        B, C = t.batch_size, t.batch_size // t.chunk
        M = 2 * B + C * t.neg_sample_size
        rel_rows = gather_rows(self._relation_table(), rel_ids)
        g_ent, losses, rel_acc = [], [], None
        sq, nonfinite = [], []
        k = 1 + len(ScatterPlan.FIELDS)
        for i in range(len(self.my_slots)):
            e = ent_rows[i * M:(i + 1) * M].detach().requires_grad_()
            r = rel_rows[i * B:(i + 1) * B].detach().requires_grad_()
            loss = self.model.rows_loss(
                e[:B], r, e[B:2 * B],
                e[2 * B:].view(C, t.neg_sample_size, cfg.hidden_dim),
                hs.mode)
            ge, gr = torch.autograd.grad(loss, (e, r))
            g_ent.append(ge)
            losses.append(loss.detach())
            if t.sentry:
                # read-only: the update below does not see these
                sq.append(ge.square().sum() + gr.square().sum())
                nonfinite.append(Q.nonfinite_count([ge, gr,
                                                    loss.reshape(1)]))
            inv, *plan = rel_plans[i * k:(i + 1) * k]
            acc = scatter_add_rows(gr.contiguous(), inv, None, len(union),
                                   mean=False, plan=ScatterPlan(*plan))
            # the slots' accumulators in slot order
            rel_acc = acc if rel_acc is None else rel_acc + acc
        loss_vec = torch.stack(losses)
        if self._group:
            # one all_reduce: the relation accumulator and every slot's
            # loss (each entry has one non-zero contributor: exact)
            full = loss_vec.new_zeros(self.nslots)
            full[self.my_slots[0]:self.my_slots[-1] + 1] = loss_vec
            flat = torch.cat([rel_acc.reshape(-1), full])
            dist.all_reduce(flat)
            rel_acc = flat[:rel_acc.numel()].view_as(rel_acc)
            loss_vec = flat[rel_acc.numel():]
        g = g_ent[0] if len(g_ent) == 1 else torch.cat(g_ent)
        self._push(g.contiguous(), how)
        if self._rel_split:
            adagrad_rows_(self.relation, self.rel_state, own_rows,
                          rel_acc.index_select(0, own.long())
                          / self.rel_divisor, t.lr)
        else:
            adagrad_rows_(self.relation, self.rel_state, union,
                          rel_acc / self.rel_divisor, t.lr)
        if t.sentry:
            self.last_stats = self._slot_stats(loss_vec, sq, nonfinite)
        return loss_vec.mean()

    def _slot_stats(self, loss_vec: torch.Tensor, sq: List[torch.Tensor],
                    nonfinite: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The sentry's stats of one update from its slots' squared
        gradient sums and non-finite counts; in a group one more
        ``all_reduce`` (its own, so the update's bucket is the same with
        the sentry on or off) gathers every slot's."""
        vecs = torch.stack([torch.stack(sq),
                            torch.stack(nonfinite).float()])
        if self._group:
            full = vecs.new_zeros(2, self.nslots)
            full[:, self.my_slots[0]:self.my_slots[-1] + 1] = vecs
            dist.all_reduce(full)
            vecs = full
        part_nonfinite = vecs[1].round().long()
        return {"grad_norm": vecs[0].sum().sqrt(),
                "nonfinite": part_nonfinite.sum(),
                "part_loss": loss_vec.float(),
                "part_nonfinite": part_nonfinite}

    # -- training --------------------------------------------------------
    def _iterators(self, dataset: TrainDataset, ranks: Sequence[int],
                   seeds: Sequence[Tuple[int, int]]):
        t = self.tcfg
        out = []
        for rank, (hs, ts) in zip(ranks, seeds):
            head = dataset.create_sampler(t.batch_size, t.neg_sample_size,
                                          t.chunk, mode="head", rank=rank,
                                          seed=hs,
                                          draw_negatives=not self.device_negs)
            tail = dataset.create_sampler(t.batch_size, t.neg_sample_size,
                                          t.chunk, mode="tail", rank=rank,
                                          seed=ts,
                                          draw_negatives=not self.device_negs)
            out.append(BidirectionalOneShotIterator(head, tail))
        return out

    def _open_checkpoints(self, checkpoints: bool):
        t = self.tcfg
        if t.ckpt_dir is None or not checkpoints:
            return None, 0
        mgr = CheckpointManager(t.ckpt_dir)
        ckpt = RankZeroCheckpoints(mgr, self.rank) if self._group else mgr
        start = 0
        if t.resume == "auto":
            cfg = self.cfg
            like = {"entity": np.zeros((cfg.n_entities, cfg.hidden_dim),
                                       np.float32),
                    "entity_state": np.zeros(cfg.n_entities, np.float32),
                    "relation": np.zeros((cfg.n_relations,
                                          relation_dim(cfg)), np.float32),
                    "relation_state": np.zeros(cfg.n_relations, np.float32)}
            start, sd = mgr.restore(None, like)
            if self._group and collectives.allreduce_host(
                    start, np.min) != collectives.allreduce_host(start,
                                                                 np.max):
                raise RuntimeError("the processes restored different "
                                   "checkpoint steps")
            if start:
                self.load_state_dict(sd)
        return ckpt, start

    def _run(self, iters, checkpoints: bool = True) -> Dict:
        """Steps ``[start, max_step)`` over the logical ranks' iterators
        (every slot's K clients, slot-major, on every process), K updates
        a step, host steps built ``PREFETCH`` ahead on one thread;
        ``checkpoints`` reads and writes ``tcfg.ckpt_dir``."""
        t, K, S = self.tcfg, self.num_client, self.nslots
        ckpt, start = self._open_checkpoints(checkpoints)
        # fast-forward the streams the completed steps consumed
        for _ in range(start):
            for it in iters:
                next(it)
        self.timer.reset()
        maybe_start_sidecar()
        tap = Q.StatsTap() if t.sentry else None
        monitor = (Q.QualityMonitor.from_config(
            t, parts=list(range(self.nslots))) if t.sentry else None)

        def observe(recs) -> None:
            for rec in recs:
                try:
                    monitor.observe(*rec)
                except Q.NumericsFault as fault:
                    Q.halt_for_rollback(fault, ckpt=ckpt,
                                        action=monitor.action)

        def build(step_i: int, c: int) -> _HostStep:
            # update c of a step: client c of every slot
            return self.host_step(
                [next(iters[s * K + c]) for s in range(S)],
                update_seed(t.seed, step_i, K, c) if self.device_negs
                else None)

        pipeline = prefetch_map(
            build, [(i, c) for i in range(start, t.max_step)
                    for c in range(K)], PREFETCH, 1)
        losses, step_s, h2d = [], [], 0
        t0 = time.perf_counter()
        try:
            for step in range(start + 1, t.max_step + 1):
                t_step = time.perf_counter()
                for c in range(K):
                    with self.timer.phase("stall"):
                        hs = next(pipeline)
                    with self.timer.phase("dispatch"):
                        losses.append(self.device_step(hs))
                    h2d += hs.buf.nbytes
                    if tap is not None:
                        tap.push((step - 1) * K + c + 1, losses[-1],
                                 self.last_stats)
                        observe(tap.poll_all())
                step_s.append(time.perf_counter() - t_step)
                if step % t.log_interval == 0:
                    window = torch.stack(losses[-t.log_interval * K:])
                    print(f"[{self.rank}][Train]({step}/{t.max_step}) "
                          f"average loss: {float(window.mean()):.6f}",
                          flush=True)
                if ckpt is not None and t.ckpt_every and \
                        step % t.ckpt_every == 0:
                    ckpt.save(step, self.state_dict(), wait=False)
            if tap is not None:
                observe(tap.drain_all())
            values = torch.stack(losses).tolist() if losses else []
            train_s = time.perf_counter() - t0      # waited for the device
            # the final state, unless the cadence has just written it
            if ckpt is not None and start < t.max_step and not (
                    t.ckpt_every and t.max_step % t.ckpt_every == 0):
                ckpt.save(t.max_step, self.state_dict(), wait=False)
        finally:
            pipeline.close()
            if ckpt is not None:
                ckpt.close()
        n = max(len(values), 1)
        return {"steps": t.max_step, "updates": t.max_step * K,
                "start_step": start, "losses": values,
                "loss": float(np.mean(values[-50:])) if values
                else float("nan"),
                "train_time_s": train_s, "step_s": step_s,
                "stall_s": self.timer.total.get("stall", 0.0),
                "dispatch_s": self.timer.total.get("dispatch", 0.0),
                "h2d_bytes_per_step": h2d / n}

    def train(self, dataset: TrainDataset) -> Dict:
        """Train from the current tables (or, with ``ckpt_dir`` and
        ``resume="auto"``, the newest good checkpoint) to ``max_step``.
        ``dataset`` must be partitioned into ``num_slots * num_client``
        ranks; client ``c`` of slot ``s`` samples logical rank ``lr = s *
        K + c`` with head seed ``seed + lr`` and tail seed ``seed + lr +
        num_slots * K``. Returns ``{"steps", "updates" (K a step),
        "loss" (mean of the last 50 updates), "losses" (every update's),
        "start_step", "train_time_s", "step_s", "stall_s", "dispatch_s",
        "h2d_bytes_per_step" (an update's)}``. The state's byte model
        (:meth:`state_sharding_summary`) goes to the ``train_state_*``
        gauges first."""
        emit_state_gauges(self.state_sharding_summary(), role="kge")
        return self._run(self.iterators(dataset))

    def iterators(self, dataset: TrainDataset) -> List:
        """:meth:`train`'s iterators, one a logical rank in rank order
        (client ``c`` of slot ``s`` at ``s * K + c``); each yields once a
        step."""
        S, K, seed = self.nslots, self.num_client, self.tcfg.seed
        if len(dataset.edge_parts) != S * K:
            raise ValueError(
                f"TrainDataset was partitioned into "
                f"{len(dataset.edge_parts)} ranks but num_slots * "
                f"num_client = {S}*{K} = {S * K}; build it with "
                "ranks=num_slots*num_client")
        return self._iterators(
            dataset, range(S * K),
            [(seed + lr, seed + lr + S * K) for lr in range(S * K)])

    # -- ranking evaluation ----------------------------------------------
    @torch.no_grad()
    def sharded_ranking_eval(self, eval_triples, batch_size: int = 128,
                             filters=None) -> Dict[str, float]:
        """:func:`full_ranking_eval`'s metrics with every block scored in
        place: each process scores its own rows as candidates, reads the
        target's score from its owner's column, counts the candidates
        above it (and, filtered, the known positives above it, which are
        subtracted) and the counts are summed over the processes."""
        h_all, r_all, t_all = (np.asarray(a) for a in eval_triples)
        rows = self.entity.shape[0]
        base = self.block_rank * rows
        split = self.block_world > 1
        gid = base + torch.arange(rows, device=self.device)
        valid = gid < self.cfg.n_entities
        ranks = []
        for mode in ("tail", "head"):
            for b in range(0, len(h_all), batch_size):
                sel = slice(b, min(b + batch_size, len(h_all)))
                h, r, t = h_all[sel], r_all[sel], t_all[sel]
                fixed_ids, target = (h, t) if mode == "tail" else (t, h)
                known = _known(filters, h, r, t, mode)
                rt = route([fixed_ids] * self.block_world, self.spec,
                           self.block_rank)
                shipped = ship_int32(rt.arrays() + [r, target, known],
                                     self.device)
                r_d, tgt, kn = shipped[-3:]
                fixed = sharded_lookup(self.entity,
                                       rt.rebuilt(shipped[:-3]))
                scores = self.model.neg_score(
                    fixed, gather_rows(self._relation_table(), r_d),
                    self.entity[None], len(h), mode)       # [B, rows]
                local = tgt.long() - base
                own = (local >= 0) & (local < rows)
                pos = torch.where(own, scores.gather(
                    1, local.clamp(0, rows - 1)[:, None])[:, 0],
                    scores.new_zeros(()))
                if split:
                    dist.all_reduce(pos)
                count = ((scores > pos[:, None]) & valid).sum(1)
                k_local = kn.long() - base
                k_mine = (kn >= 0) & (k_local >= 0) & (k_local < rows)
                k_scores = scores.gather(1, k_local.clamp(0, rows - 1))
                k_gt = (k_mine & (k_scores > pos[:, None])).sum(1)
                counts = torch.stack([count, k_gt])
                if split:
                    dist.all_reduce(counts)
                ranks.append(1 + counts[0] - counts[1])
        return _metrics(torch.cat(ranks))


class KGETrainer(DistKGETrainer):
    """Single-device KGE trainer (the JAX ``KGETrainer``): one slot, every
    table on ``device`` (the current card when None), relation gradients
    not divided. ``params`` and ``opt_state`` are the tables and their
    Adagrad sums. A process group, if any, is not used. Negatives are
    drawn on the host by one client, whatever ``neg_sampler`` and
    ``num_client`` say, as in the JAX package."""

    _uses_group = False
    # the JAX KGETrainer draws negatives on the host, one client a slot
    _device_negs_ok = False

    def __init__(self, cfg: KGEConfig, tcfg: KGETrainConfig,
                 device: DeviceLike = None):
        super().__init__(cfg, tcfg, num_slots=1, device=device)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return {"entity": self.entity, "relation": self.relation}

    @property
    def opt_state(self) -> Dict[str, torch.Tensor]:
        return {"entity": self.ent_state, "relation": self.rel_state}

    def train(self, dataset: TrainDataset, rank: int = 0) -> Dict:
        """``max_step`` updates on the edge partition ``rank`` of
        ``dataset`` (head sampler seed ``seed``, tail ``seed + 1``);
        returns :meth:`DistKGETrainer.train`'s record with ``loss`` the
        mean of the last 100 losses. Checkpoints are not read or
        written, as in the JAX package."""
        t = self.tcfg
        out = self._run(self._iterators(dataset, [rank],
                                        [(t.seed, t.seed + 1)]),
                        checkpoints=False)
        out["loss"] = float(np.mean(out["losses"][-100:]))
        return out


# ----------------------------------------------------------------------
# Ranking evaluation
def build_filter(triples, n_entities: int):
    """``(h, r) -> tails`` and ``(r, t) -> heads`` maps for filtered
    ranking."""
    h, r, t = triples
    tails: Dict[Tuple[int, int], list] = {}
    heads: Dict[Tuple[int, int], list] = {}
    for hi, ri, ti in zip(h.tolist(), r.tolist(), t.tolist()):
        tails.setdefault((hi, ri), []).append(ti)
        heads.setdefault((ri, ti), []).append(hi)
    return {"tails": tails, "heads": heads}


def _known(filters, h, r, t, mode: str) -> np.ndarray:
    """``[B, K]`` each query's distinct known answers on the corrupted
    side, -1 padded (``K`` at least 1)."""
    lists = [[] for _ in range(len(h))]
    if filters is not None:
        for i in range(len(h)):
            key = ((int(h[i]), int(r[i])) if mode == "tail"
                   else (int(r[i]), int(t[i])))
            lists[i] = sorted(set(filters["tails" if mode == "tail"
                                          else "heads"].get(key, [])))
    out = np.full((len(h), max([1] + [len(x) for x in lists])), -1,
                  np.int64)
    for i, ks in enumerate(lists):
        out[i, :len(ks)] = ks
    return out


def _metrics(rank: torch.Tensor) -> Dict[str, float]:
    rank = rank.cpu().double()
    return {"MR": float(rank.mean()), "MRR": float((1.0 / rank).mean()),
            "HITS@1": float((rank <= 1).double().mean()),
            "HITS@3": float((rank <= 3).double().mean()),
            "HITS@10": float((rank <= 10).double().mean())}


@torch.no_grad()
def full_ranking_eval(model: KGEModel, params, eval_triples,
                      batch_size: int = 128, filters=None
                      ) -> Dict[str, float]:
    """Raw (or, with ``filters`` from :func:`build_filter`, filtered)
    ranking metrics over both corruption sides, ``params`` the
    ``{"entity", "relation"}`` tables on one device. A query's rank is 1
    plus the candidates scoring strictly above its target; filtered, the
    known answers score ``-inf``."""
    ent, rel = params["entity"], params["relation"]
    h_all, r_all, t_all = (np.asarray(a) for a in eval_triples)
    ranks = []
    for mode in ("tail", "head"):
        for b in range(0, len(h_all), batch_size):
            sel = slice(b, min(b + batch_size, len(h_all)))
            h, r, t = h_all[sel], r_all[sel], t_all[sel]
            fixed_ids, target = (h, t) if mode == "tail" else (t, h)
            known = _known(filters, h, r, t, mode)
            f_d, r_d, tgt, kn = ship_int32([fixed_ids, r, target, known],
                                           ent.device)
            scores = model.neg_score(gather_rows(ent, f_d),
                                     gather_rows(rel, r_d), ent[None],
                                     len(h), mode)            # [B, Ne]
            pos = scores.gather(1, tgt.long()[:, None])
            if filters is not None:
                row = torch.arange(len(h), device=ent.device)[:, None]
                hit = kn >= 0
                scores[row.expand_as(kn)[hit], kn.long()[hit]] = -np.inf
            ranks.append(1 + (scores > pos).sum(1))
    return _metrics(torch.cat(ranks))
