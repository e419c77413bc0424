"""Data parallelism over partition slots: the gradient mean, and state
sharding (weight-update sharding, ZeRO-3, tensor-parallel storage).

The counterpart of the JAX package's ``_ddp_update`` and
``make_dp_train_step`` (``dgl_operator_tpu/parallel/dp.py``): each
slot's loss is differentiated on its own batch, the gradients are
averaged over the slots (``pmean``) and one optimizer step applies the
mean. This module is the one place that reduction lives. Every process
accumulates ``grad / P`` over its own slots in slot order, ``P`` the
global slot count; in a ``torch.distributed`` group one ``all_reduce``
then sums the processes' gradients, as the reference's DDP does. The
mean registers its bytes (``grad_pmean``) with the comm ledger
(``obs/comm.py``).

State sharding (:class:`ShardPlan`, the JAX step's ``shard_update``,
``shard_rules``, ``zero_stage`` and ``gather_depth``): the rules of
``parallel/shardrules.py`` select, by flax path, the parameters whose
state is cut over the slots of a :class:`SlotMesh`.

- **Weight-update sharding** (``zero_stage=1``; ``shard_update`` is the
  rule ``(".*", "dp")``): a selected parameter's mean gradient is
  flattened, zero-padded to a multiple of the dp width ``n`` and cut in
  ``n`` shards; slot ``s`` updates shard ``s // mp`` and keeps only
  that shard's optimizer moments; the updated shards are gathered back
  into the full parameter.
- **ZeRO-3** (``zero_stage=3``): the selected parameters themselves stay
  resident as those shards between steps. They are gathered at use, at
  the start of a step, with at most ``gather_depth`` gathers in flight,
  and freed after the update.
- **Tensor-parallel storage** (``zero_stage=3`` with a rule naming
  ``mp``, on a ``make_train_mesh(dp, tp)`` grid): the parameter is
  zero-padded along the rule's dim to a multiple of ``tp`` and stored in
  ``tp`` blocks over ``mp``, gathered at use; each block takes its rows
  of the mean gradient. This is the JAX form, a storage plan, not a
  row-parallel product.

Adam's and Adagrad's updates are elementwise, so each form's trajectory
is the replicated one bit for bit. In one process every slot's shard
lives here, the reduction is the replicated sum and a gather is a
concatenation. In a group each process holds the shards of its slots'
dp coordinates: the selected flat gradients are summed by one
``reduce_scatter_tensor``, the rest (and the slots' losses) by one
``all_reduce``, and a shard comes back by ``all_gather_into_tensor``.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dgl_operator_tpu_torch.obs import quality as Q
from dgl_operator_tpu_torch.obs.comm import register_collective
from dgl_operator_tpu_torch.parallel import shardrules as sr
from dgl_operator_tpu_torch.parallel.collectives import (all_gather_flat,
                                                         group_active,
                                                         reduce_scatter_sum,
                                                         world)
from dgl_operator_tpu_torch.parallel.mesh import (DP_AXIS, SlotMesh,
                                                  my_slots)


def slot_mean_step(optimizer: Optional[torch.optim.Optimizer],
                   loss_of_slot: Callable[[int], torch.Tensor],
                   num_slots: int,
                   num_parts: Optional[int] = None,
                   delta: Optional[Q.ParamDelta] = None,
                   plan: Optional["ShardPlan"] = None
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One optimizer step on the mean over every slot of the per-slot
    gradients; returns the mean of the slot losses (a device scalar, no
    sync) and, given ``delta`` (the sentry's
    :class:`~dgl_operator_tpu_torch.obs.quality.ParamDelta` over the
    optimizer's parameters), the step's ``dp_slot_stats`` stacked over
    the slots, else None.

    ``loss_of_slot(s)`` builds local slot ``s``'s loss, for ``s`` in
    ``range(num_slots)``. Each is differentiated as soon as it is
    built, weighted ``1 / num_parts`` (default ``num_slots``), so one
    slot's activations are alive at a time, and its gradients are added
    into ``.grad`` in slot order, as ``backward`` accumulates them; the
    slot's own gradients are counted for non-finite elements on the
    way (``part_nonfinite``). A slot without train seeds gives a zero
    loss and zero gradients and still counts: the divisor is the slot
    count, not the non-empty slots.

    With a process group initialized, this process holds slots ``rank *
    num_slots`` to ``(rank + 1) * num_slots - 1`` of ``num_parts``; one
    ``all_reduce(SUM)`` of every gradient, the slot losses and the slot
    non-finite counts, in one flat bucket, makes each process's step
    the global one, and the stats cover every slot of the group.

    With a :class:`ShardPlan` the step is the plan's: its parameters are
    gathered first (ZeRO-3), and :meth:`ShardPlan.update` reduces, steps
    its optimizer over the shards and gathers or frees them (``optimizer``
    is not read; ``delta`` only asks for the stats)."""
    P = num_slots if num_parts is None else int(num_parts)
    if plan is not None:
        plan.materialize()
        params = plan.params
    else:
        params = [p for group in optimizer.param_groups
                  for p in group["params"]]
    for p in params:
        p.grad = None
    losses, nonfinite = [], []
    for s in range(num_slots):
        loss = loss_of_slot(s)
        grads = torch.autograd.grad(loss / P, params, allow_unused=True)
        for p, g in zip(params, grads):
            if g is None:
                continue
            if p.grad is None:
                p.grad = g.contiguous()
            else:
                p.grad += g
        if delta is not None:
            nonfinite.append(Q.nonfinite_count([*grads, loss.reshape(1)]))
        losses.append(loss.detach())
    loss_vec = torch.stack(losses)
    nonfinite_vec = (torch.stack(nonfinite).float() if nonfinite
                     else torch.zeros_like(loss_vec))
    if plan is not None:
        loss_vec, nonfinite_vec, stats = plan.update(
            loss_vec, nonfinite_vec, P, stats=delta is not None)
        if stats is None:
            return loss_vec.mean(), None
        stats["part_loss"] = loss_vec.float()
        stats["part_nonfinite"] = nonfinite_vec.round().long()
        return loss_vec.mean(), stats
    # the comm ledger's bill of the gradient mean (the JAX pmean's)
    register_collective("grad_pmean", DP_AXIS,
                        sum(2 * p.numel() * p.element_size()
                            for p in params))
    if group_active():
        loss_vec, nonfinite_vec = _all_reduce_bucket(
            params, loss_vec, nonfinite_vec, P)
    if delta is None:
        optimizer.step()
        return loss_vec.mean(), None
    stats = Q.grad_part([p.grad for p in params])
    delta.before()
    optimizer.step()
    stats.update(delta.stats())
    stats["part_loss"] = loss_vec.float()
    stats["part_nonfinite"] = nonfinite_vec.round().long()
    return loss_vec.mean(), stats


def _all_reduce_bucket(params: List[torch.Tensor],
                       local_losses: torch.Tensor,
                       local_nonfinite: torch.Tensor, P: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum every parameter's gradient over the group in place and return
    the ``[P]`` vectors of every slot's loss and non-finite count. Both
    ride the same bucket, whose layout does not depend on the sentry:
    each slot's entry has one non-zero contributor, so the sum is exact
    and the mean equals the single-process one bit for bit."""
    rank, size = world()
    L = local_losses.numel()
    if L * size != P:
        raise ValueError(f"{size} processes of {L} slots each do not hold "
                         f"the {P} slots")
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    vecs = local_losses.new_zeros(2, P)
    vecs[0, rank * L:(rank + 1) * L] = local_losses
    vecs[1, rank * L:(rank + 1) * L] = local_nonfinite
    flat = torch.cat([p.grad.reshape(-1) for p in params]
                     + [vecs.reshape(-1)])
    dist.all_reduce(flat)
    off = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n
    vecs = flat[off:].view(2, P)
    return vecs[0], vecs[1]


# ----------------------------------------------------------------------
# state sharding
def _validate_dp_rules(rules, mesh: Optional[SlotMesh] = None,
                       zero_stage: int = 1) -> None:
    """Rules of the dense step: under ``zero_stage=1`` they may name only
    the dp axis (another axis would be tensor parallelism, which the
    replicated-parameter step does not do); under ``zero_stage=3`` any
    axis of the mesh (dp selects the flat shard, another axis the dim
    blocks). An axis the mesh does not have raises either way."""
    z3 = zero_stage == 3
    for pat, spec in rules:
        for ax in sr.spec_axes(sr.to_pspec(spec)):
            if z3:
                if mesh is not None and ax not in mesh.axis_names:
                    raise ValueError(
                        f"shard_rules entry {pat!r} names axis {ax!r} "
                        f"which is not on the mesh (axes: "
                        f"{tuple(mesh.axis_names)!r})")
            elif ax != DP_AXIS:
                raise ValueError(
                    f"shard_rules entry {pat!r} names axis {ax!r}; "
                    f"the DP train step only supports {DP_AXIS!r} "
                    "(ZeRO-style weight-update sharding) or None "
                    "(replicated); pass zero_stage=3 for rule-driven "
                    "tensor parallelism")


def param_allgather_start(out: torch.Tensor, local: torch.Tensor):
    """Issue the all-gather that rebuilds a flat parameter ``out`` (every
    rank's ``local`` shards in rank order) from the ranks' shards; returns
    its handle (the ZeRO-3 gather-at-use pull; None when it is done
    already, as through the host under gloo)."""
    return all_gather_flat(out, local, async_op=True)


def param_allgather_done(handle) -> None:
    """Wait for a :func:`param_allgather_start`."""
    if handle is not None:
        handle.wait()


class _Leaf:
    """One parameter's storage plan and the storage this process holds.

    kind   ``"repl"`` (the parameter itself), ``"flat"`` (1/n element
           shards over dp) or ``"dim"`` (blocks over ``axis`` along
           ``tdim``, padded to ``pad_to``).
    parts  the storage tensors this process holds, one a coordinate of
           ``coords`` (dp coordinates for flat, ``axis`` coordinates for
           dim; ``[param]`` for repl).
    local  flat: this process's shards as one buffer ``[len(coords) *
           k]``, ``parts`` its views.
    """

    def __init__(self, lf: sr.ParamLeaf, kind: str, spec, n: int,
                 axis: Optional[str] = None, msize: int = 1,
                 fdim: int = 0):
        self.src = lf
        self.path, self.param, self.shape = lf.path, lf.param, lf.shape
        self.tshape = tuple(lf.param.shape)
        self.numel = int(np.prod(self.tshape, dtype=int))
        self.kind, self.spec = kind, sr.to_pspec(spec)
        self.k = -(-self.numel // n)
        self.axis, self.msize, self.fdim = axis, msize, fdim
        self.tdim = (len(self.shape) - 1 - fdim) if lf.transposed else fdim
        if kind == "dim":
            self.pad_to = -(-self.shape[fdim] // msize) * msize
            self.block = self.pad_to // msize
        self.parts: List[torch.Tensor] = []
        self.coords: List[int] = []
        self.local: Optional[torch.Tensor] = None

    def storage_shape(self, n: int) -> Tuple[int, ...]:
        """The global storage leaf's (flax-layout) shape."""
        if self.kind == "flat":
            return (n * self.k,)
        if self.kind == "dim":
            return tuple(self.pad_to if i == self.fdim else s
                         for i, s in enumerate(self.shape))
        return self.shape

    def padded(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (the parameter's torch shape) zero-padded along ``tdim``
        to ``pad_to``."""
        mults = [1] * t.dim()
        mults[self.tdim] = self.msize
        return sr.pad_dims(t, mults)


class ShardPlan:
    """The state-sharding plan of ``model``'s parameters over ``mesh``
    for this process's slots (``rank`` of ``world``), with its optimizer
    ``make_optimizer(storage tensors)`` over the storage this process
    holds. Built from the model's current weights.

    ``shard_update`` shards every parameter over dp; ``shard_rules``
    (not both) selects by flax path; ``zero_stage=3`` keeps the selected
    parameters resident as their shards (and shards every parameter when
    neither is given); ``gather_depth`` bounds the gathers in flight.
    Raises the JAX step's ``ValueError`` for a rule that names an axis
    the stage cannot take."""

    def __init__(self, model: torch.nn.Module, mesh: SlotMesh,
                 make_optimizer: Callable[[List[torch.Tensor]],
                                          torch.optim.Optimizer],
                 shard_update: bool = False,
                 shard_rules: Optional[Sequence] = None,
                 zero_stage: int = 1, gather_depth: int = 2,
                 rank: int = 0, world_size: int = 1):
        from dgl_operator_tpu_torch.autotune.knobs import validate
        if shard_update and shard_rules is not None:
            raise ValueError("pass either shard_update=True (all params) "
                             "or shard_rules (per-param), not both")
        zero_stage = int(validate("zero_stage", zero_stage))
        gather_depth = int(validate("gather_depth", gather_depth))
        if zero_stage == 3 and not shard_update and shard_rules is None:
            shard_update = True     # ZeRO-3's default: every parameter
        if shard_update:
            shard_rules = ((".*", DP_AXIS),)
        if shard_rules is None:
            # a None check, not a range check: no registry choice for it
            # tpu-lint: disable=TPU004
            raise ValueError("a ShardPlan needs shard_update, shard_rules "
                             "or zero_stage=3")
        _validate_dp_rules(shard_rules, mesh=mesh, zero_stage=zero_stage)
        self.mesh, self.rules = mesh, tuple(shard_rules)
        self.zero_stage, self.gather_depth = zero_stage, gather_depth
        self.rank, self.world_size = rank, world_size
        self.group = world_size > 1
        self.n = int(mesh.shape[DP_AXIS])
        self.model = model
        self.leaves = self._classify(sr.param_leaves(model))
        self.params = [lf.param for lf in self.leaves]
        self.slots = my_slots(mesh, rank, world_size)
        m = mesh.size // self.n
        self.dp_coords = sorted({s // m for s in self.slots})
        self._full = True
        self._shard_from_params()
        self.optimizer = make_optimizer(self.storage_tensors())
        if zero_stage == 3:
            self.release()

    # -- the plan -------------------------------------------------------
    def _classify(self, leaves: List[sr.ParamLeaf]) -> List[_Leaf]:
        """Each parameter's storage kind from the rules (the JAX
        ``_selection`` under ``zero_stage=1``, ``_z3_classify`` under
        3), on the flax shapes."""
        specs = sr.match_partition_rules(self.rules, sr.param_tree(leaves))
        by_path = dict(sr.tree_paths(specs))
        out = []
        for lf in leaves:
            spec = by_path[lf.path]
            axes = sr.spec_axes(spec)
            if not axes:
                out.append(_Leaf(lf, "repl", (), self.n))
            elif self.zero_stage != 3 or DP_AXIS in axes:
                if len(axes) > 1:
                    raise ValueError(
                        f"zero_stage=3 param {lf.path!r}: spec {spec} "
                        f"combines {DP_AXIS!r} (the flat ZeRO shard "
                        "treatment) with model-parallel axes; give "
                        "each param one or the other")
                out.append(_Leaf(lf, "flat", (DP_AXIS,), self.n))
            else:
                entries = tuple(spec)
                sdims = [i for i, e in enumerate(entries) if e]
                ax = entries[sdims[0]] if len(sdims) == 1 else None
                if isinstance(ax, (tuple, list)):
                    ax = ax[0] if len(ax) == 1 else None
                if ax is None:
                    raise ValueError(
                        f"zero_stage=3 TP param {lf.path!r}: exactly one "
                        f"dim sharded over one axis is supported, got "
                        f"spec {spec}")
                out.append(_Leaf(lf, "dim", spec, self.n, axis=ax,
                                 msize=int(self.mesh.shape[ax]),
                                 fdim=sdims[0]))
        return out

    def _dim_coord(self, lf: _Leaf, slot: int) -> int:
        """Slot ``slot``'s coordinate on ``lf.axis`` (row-major)."""
        names = self.mesh.axis_names
        stride = 1
        for a in names[names.index(lf.axis) + 1:]:
            stride *= self.mesh.shape[a]
        return (slot // stride) % lf.msize

    @torch.no_grad()
    def _shard_from_params(self) -> None:
        """Cut every selected parameter's current (full) value into this
        process's storage, into the storage tensors already there."""
        for lf in self.leaves:
            p = lf.param.detach()
            if lf.kind == "repl":
                lf.parts, lf.coords = [lf.param], [0]
                continue
            if lf.kind == "flat":
                coords = self.dp_coords
                flat = sr.pad_flat(p, self.n)
                lo, hi = coords[0] * lf.k, (coords[-1] + 1) * lf.k
                if lf.local is None:
                    lf.local = flat[lo:hi].clone()
                    lf.parts = [lf.local[i * lf.k:(i + 1) * lf.k]
                                for i in range(len(coords))]
                else:
                    lf.local.copy_(flat[lo:hi])
                lf.coords = coords
                continue
            coords = sorted({self._dim_coord(lf, s) for s in self.slots})
            padded = lf.padded(p)
            blocks = [padded.narrow(lf.tdim, c * lf.block, lf.block)
                      for c in coords]
            if not lf.parts:
                lf.parts = [b.contiguous().clone() for b in blocks]
            else:
                for part, b in zip(lf.parts, blocks):
                    part.copy_(b)
            lf.coords = coords

    def storage_tensors(self) -> List[torch.Tensor]:
        """The tensors the optimizer updates, leaf by leaf, each leaf's in
        coordinate order."""
        return [t for lf in self.leaves for t in lf.parts]

    # -- gather at use (ZeRO-3) -----------------------------------------
    def _gather_start(self, lf: _Leaf):
        if lf.kind == "flat" and self.group:
            out = lf.local.new_empty(self.n * lf.k)
            return out, param_allgather_start(out, lf.local)
        if lf.kind == "flat":
            return lf.local, None
        # dim: a process holds whole dp rows, so every block is here
        return torch.cat(lf.parts, lf.tdim), None

    def _gather_done(self, lf: _Leaf, started) -> None:
        full, handle = started
        param_allgather_done(handle)
        if lf.kind == "flat":
            lf.param.data = full[:lf.numel].view(lf.tshape)
        else:
            lf.param.data = full.narrow(lf.tdim, 0,
                                        lf.tshape[lf.tdim]).contiguous()

    def materialize(self) -> None:
        """Gather every selected parameter to its full value (ZeRO-3; a
        no-op when they are full already): the gathers start leaf by
        leaf, the oldest done once ``gather_depth`` are in flight."""
        if self._full:
            return
        self._bill("param_allgather")
        window = collections.deque()
        for lf in self.leaves:
            if lf.kind == "repl":
                continue
            window.append((lf, self._gather_start(lf)))
            if len(window) >= self.gather_depth:
                self._gather_done(*window.popleft())
        while window:
            self._gather_done(*window.popleft())
        self._full = True

    def release(self) -> None:
        """Free the full values of the selected parameters (ZeRO-3):
        between steps only the shards stay."""
        if self.zero_stage != 3:
            return
        for lf in self.leaves:
            if lf.kind != "repl":
                lf.param.data = lf.param.data.new_empty(0)
                lf.param.grad = None
        self._full = False

    def _bill(self, name: str) -> None:
        """The comm ledger's record of the plan's ``name`` collective."""
        flat = sum(self.n * lf.k * lf.param.element_size()
                   for lf in self.leaves if lf.kind == "flat")
        if name == "param_allgather":
            flat += sum(int(np.prod(lf.storage_shape(self.n)))
                        * lf.param.element_size()
                        for lf in self.leaves if lf.kind == "dim")
        register_collective(name, DP_AXIS, flat)

    # -- the update -------------------------------------------------------
    def _flat_grads_group(self, flat: List[_Leaf]) -> None:
        """Sum the selected flat gradients over the group with one
        ``reduce_scatter_tensor``: each process receives the sums of its
        dp coordinates' shards, into its shards' ``.grad``."""
        W = self.world_size
        per = len(self.dp_coords)
        rows = []
        for q in range(W):
            for lf in flat:
                g = sr.pad_flat(lf.param.grad, self.n)
                rows.append(g[q * per * lf.k:(q + 1) * per * lf.k])
        inp = torch.cat(rows)
        out = inp.new_empty(inp.numel() // W)
        reduce_scatter_sum(out, inp)
        off = 0
        for lf in flat:
            g = out[off:off + per * lf.k]
            off += per * lf.k
            for i, part in enumerate(lf.parts):
                part.grad = g[i * lf.k:(i + 1) * lf.k]

    def update(self, loss_vec: torch.Tensor, nonfinite_vec: torch.Tensor,
               P: int, stats: bool = False):
        """The step after the slots' backward: ``.grad`` of every
        parameter holds this process's sum of its slots' ``grad / P``.
        Reduce (in a group), hand each storage tensor its gradient, step
        the optimizer, then gather the selected parameters back
        (``zero_stage=1``) or free them (3). Returns the ``[P]`` loss
        and non-finite vectors and, with ``stats``, the step's
        ``grad_norm``, ``nonfinite``, ``param_norm`` and
        ``update_ratio`` (the sharded leaves' partial sums summed over
        the group)."""
        flat = [lf for lf in self.leaves if lf.kind == "flat"]
        rest = [lf.param for lf in self.leaves if lf.kind != "flat"]
        for lf in self.leaves:
            if lf.param.grad is None:
                lf.param.grad = torch.zeros_like(lf.param)
        self._bill("grad_psum_scatter")
        register_collective("grad_pmean", DP_AXIS,
                            sum(2 * p.numel() * p.element_size()
                                for p in rest))
        if self.group:
            self._flat_grads_group(flat)
            loss_vec, nonfinite_vec = _all_reduce_bucket(
                rest, loss_vec, nonfinite_vec, P)
        else:
            for lf in flat:
                g = sr.pad_flat(lf.param.grad, self.n)
                for part, c in zip(lf.parts, lf.coords):
                    part.grad = g[c * lf.k:(c + 1) * lf.k]
        for lf in self.leaves:
            if lf.kind == "dim":
                g = lf.padded(lf.param.grad)
                for part, c in zip(lf.parts, lf.coords):
                    part.grad = g.narrow(lf.tdim, c * lf.block,
                                         lf.block).contiguous()
        out = None
        if stats:
            out = self._sums("grad")
            before = [t.detach().clone() for t in self.storage_tensors()]
        self.optimizer.step()
        for t in self.storage_tensors():
            t.grad = None
        if out is not None:
            out.update(self._sums("update", before))
        if self.zero_stage == 3:
            self.release()
        else:
            self._gather_back(flat)
        return loss_vec, nonfinite_vec, out

    @torch.no_grad()
    def _gather_back(self, flat: List[_Leaf]) -> None:
        """Weight-update sharding's second half: every selected parameter
        from its updated shards, in place."""
        if not flat:
            return
        self._bill("param_allgather")
        for lf in flat:
            full = lf.local
            if self.group:
                full = lf.local.new_empty(self.n * lf.k)
                param_allgather_done(param_allgather_start(full, lf.local))
            lf.param.copy_(full[:lf.numel].view(lf.tshape))
            lf.param.grad = None

    def _sums(self, what: str, before=None) -> Dict[str, torch.Tensor]:
        """The sentry's norms over the storage: each flat shard and dim
        block counted once (their pad elements are zeros), the flat
        shards' partial sums added over the group."""
        dev = self.leaves[0].parts[0].device
        shard = torch.zeros(2, device=dev)
        whole = torch.zeros(2, device=dev)
        i = 0
        for lf in self.leaves:
            acc = shard if lf.kind == "flat" else whole
            for t in lf.parts:
                if what == "grad":
                    g = t.grad.detach().float()
                    acc[0] += g.square().sum()
                    acc[1] += (~torch.isfinite(g)).sum()
                else:
                    v = t.detach().float()
                    acc[0] += v.square().sum()
                    acc[1] += (v - before[i].float()).square().sum()
                i += 1
        if self.group:
            dist.all_reduce(shard)
        tot = shard + whole
        if what == "grad":
            return {"grad_norm": tot[0].sqrt(),
                    "nonfinite": tot[1].round().long()}
        pn = tot[0].sqrt()
        return {"param_norm": pn, "update_ratio": tot[1].sqrt() / (pn + 1e-12)}

    # -- logical state ----------------------------------------------------
    def _logical(self, lf: _Leaf, parts: List[torch.Tensor]) -> torch.Tensor:
        """The logical (torch-shaped) value of ``parts``, one tensor a
        storage part of ``lf`` (its values or a moment's)."""
        if lf.kind == "repl":
            return parts[0]
        if lf.kind == "flat":
            local = torch.cat([t.reshape(-1) for t in parts])
            full = local
            if self.group:
                full = local.new_empty(self.n * lf.k)
                param_allgather_done(param_allgather_start(full, local))
            return sr.unpad_leaf(full, lf.tshape)
        return sr.unpad_leaf(torch.cat(parts, lf.tdim), lf.tshape)

    def _storage(self, lf: _Leaf, value: torch.Tensor) -> List[torch.Tensor]:
        """``value`` (logical, torch-shaped) cut as ``lf``'s parts."""
        if lf.kind == "repl":
            return [value]
        if lf.kind == "flat":
            flat = sr.pad_flat(value, self.n)
            return [flat[c * lf.k:(c + 1) * lf.k].clone() for c in lf.coords]
        padded = lf.padded(value)
        return [padded.narrow(lf.tdim, c * lf.block, lf.block).contiguous()
                for c in lf.coords]

    def logical_opt_state(self) -> List[Dict[str, torch.Tensor]]:
        """The optimizer's state of each parameter in the replicated
        optimizer's form (``model.parameters()`` order): each moment
        reassembled from its shards and de-padded (``unpad_leaf``), the
        step counters taken as they are. A collective in a group."""
        out = []
        for lf in self.leaves:
            states = [self.optimizer.state.get(t, {}) for t in lf.parts]
            st = {}
            for key, v in states[0].items():
                if isinstance(v, torch.Tensor) and v.shape == \
                        lf.parts[0].shape and v.dim() > 0:
                    st[key] = self._logical(lf, [s[key] for s in states])
                else:
                    st[key] = v
            out.append(st)
        return out

    def logical_optimizer_state_dict(self) -> Dict:
        """:meth:`logical_opt_state` as a replicated optimizer's
        ``state_dict()`` (one param group over the parameters)."""
        group = {k: v for k, v in self.optimizer.param_groups[0].items()
                 if k != "params"}
        return {"state": {i: st for i, st in
                          enumerate(self.logical_opt_state()) if st},
                "param_groups": [{**group,
                                  "params": list(range(len(self.leaves)))}]}

    def train_state(self) -> Dict:
        """The checkpoint tree of ``runtime/checkpoint.py::train_state``
        in its logical form: the same tree, the same bits, as the
        replicated run's at the same step, so it restores under any mesh
        shape and any plan."""
        self.materialize()
        opt = {}
        for i, (lf, st) in enumerate(zip(self.leaves,
                                         self.logical_opt_state())):
            opt[str(i)] = {
                "step": st.get("step", torch.zeros((), dtype=torch.float32)),
                "exp_avg": st.get("exp_avg", torch.zeros_like(lf.param)),
                "exp_avg_sq": st.get("exp_avg_sq",
                                     torch.zeros_like(lf.param))}
        return {"params": self.model.state_dict(), "opt": opt}

    def load_train_state(self, state: Dict) -> None:
        """Load a :meth:`train_state` tree (of any mesh shape, sharded or
        not): the weights into the model and the storage, the moments
        cut into this mesh's shards."""
        self.materialize()
        self.model.load_state_dict(state["params"])
        self._shard_from_params()
        sd = self.optimizer.state_dict()
        new, idx = {}, 0
        for i, lf in enumerate(self.leaves):
            st = state["opt"][str(i)]
            moments = {k: self._storage(lf, v.to(lf.param.device))
                       for k, v in st.items() if k != "step"}
            for j in range(len(lf.parts)):
                # a step counter of each part's own
                new[idx] = {"step": st["step"].detach().cpu().to(
                    torch.float32).clone(),
                    **{k: v[j] for k, v in moments.items()}}
                idx += 1
        sd["state"] = new
        self.optimizer.load_state_dict(sd)
        self.release()

    def rebind(self) -> None:
        """Every storage tensor and optimizer state tensor to a fresh copy
        (``DistTrainer`` with ``donate=False``), the optimizer's
        references with them."""
        old = self.storage_tensors()
        with torch.no_grad():
            for lf in self.leaves:
                if lf.kind == "repl":
                    lf.param.data = lf.param.data.clone()
                elif lf.kind == "flat":
                    lf.local = lf.local.clone()
                    lf.parts = [lf.local[i * lf.k:(i + 1) * lf.k]
                                for i in range(len(lf.coords))]
                    if self.zero_stage != 3:
                        # the gathered-back weights are written in place
                        lf.param.data = lf.param.data.clone()
                else:
                    lf.parts = [t.clone() for t in lf.parts]
        new = self.storage_tensors()
        remap = {id(o): t for o, t in zip(old, new)}
        for group in self.optimizer.param_groups:
            group["params"] = [remap[id(t)] for t in group["params"]]
        state = self.optimizer.state
        for o, t in zip(old, new):
            st = state.pop(o, None)
            if st is not None:
                state[t] = {k: v.clone() if isinstance(v, torch.Tensor)
                            else v for k, v in st.items()}

    # -- accounting ---------------------------------------------------------
    def storage_specs(self) -> Tuple[Dict, Dict]:
        """``(params tree, specs tree)`` of the parameters as the byte
        model bills them: under ``zero_stage=3`` the global storage
        shapes under their storage specs (the JAX ``storage_specs``),
        under 1 the logical shapes, replicated."""
        leaves = [lf.src for lf in self.leaves]
        if self.zero_stage == 3:
            by = {lf.path: lf for lf in self.leaves}
            tree = sr.param_tree(leaves, lambda x: sr.ShapeLeaf(
                by[x.path].storage_shape(self.n), x.param.dtype))
            specs = sr.param_tree(leaves, lambda x: (
                by[x.path].spec if by[x.path].kind != "repl"
                else sr.PSpec()))
            return tree, specs
        tree = sr.param_tree(leaves)
        return tree, sr.tree_map_with_path(lambda _, x: sr.PSpec(), tree)

    def summary(self) -> Dict[str, float]:
        """The byte model's ``sharding_summary`` of this plan, the JAX
        trainer's for the same model (Adam's state as optax lays it
        out: one count, then ``mu`` and ``nu`` over the storage)."""
        params, pspecs = self.storage_specs()
        if self.zero_stage == 3:
            moments = params
            ospec_params = params
            ospec_pspecs = pspecs
        else:
            by = {lf.path: lf for lf in self.leaves}
            moments = sr.tree_map_with_path(
                lambda p, x: sr.ShapeLeaf(by[p].storage_shape(self.n),
                                          x.dtype), params)
            ospec_params = params
            ospec_pspecs = sr.tree_map_with_path(
                lambda p, x: sr.PSpec((DP_AXIS,))
                if by[p].kind == "flat" else sr.PSpec(), params)
        opt = adam_state_tree(moments)
        ospecs = sr.opt_state_specs(opt, ospec_params, ospec_pspecs)
        return sr.sharding_summary(params, opt, pspecs, ospecs,
                                   dict(self.mesh.shape))

    def slot_bytes(self) -> Dict[int, Dict[str, int]]:
        """Measured bytes of each of this process's slots' state tensors:
        ``params`` (a flat shard, a dim block or the full parameter) and
        ``opt_state`` (the optimizer's tensors of those)."""
        m = self.mesh.size // self.n
        out = {}
        for s in self.slots:
            pb = ob = 0
            for lf in self.leaves:
                if lf.kind == "flat":
                    t = lf.parts[lf.coords.index(s // m)]
                elif lf.kind == "dim":
                    t = lf.parts[lf.coords.index(self._dim_coord(lf, s))]
                else:
                    t = lf.param
                if lf.kind == "flat" and self.zero_stage != 3:
                    pb += lf.param.numel() * lf.param.element_size()
                else:
                    pb += t.numel() * t.element_size()
                for v in self.optimizer.state.get(t, {}).values():
                    if isinstance(v, torch.Tensor):
                        ob += v.numel() * v.element_size()
            out[s] = {"params": pb, "opt_state": ob}
        return out


def adam_state_tree(moments) -> Dict:
    """optax ``adam``'s state laid over ``moments`` (a tree of leaves):
    ``(ScaleByAdamState(count, mu, nu), EmptyState())`` as paths, so the
    byte model bills the same leaves in both packages."""
    return {"0": {"count": sr.ShapeLeaf((), np.int32), "mu": moments,
                  "nu": moments}, "1": {}}


def replicated_summary(model: torch.nn.Module, mesh: SlotMesh
                       ) -> Dict[str, float]:
    """The byte model's summary of ``model`` with Adam's state and
    everything replicated (no :class:`ShardPlan`)."""
    params = sr.param_tree(sr.param_leaves(model))
    specs = sr.tree_map_with_path(lambda _, x: sr.PSpec(), params)
    opt = adam_state_tree(params)
    ospecs = sr.tree_map_with_path(lambda _, x: sr.PSpec(), opt)
    return sr.sharding_summary(params, opt, specs, ospecs,
                               dict(mesh.shape))
