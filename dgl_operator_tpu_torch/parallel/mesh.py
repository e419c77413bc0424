"""Slot meshes: the ``(dp,)`` and ``(dp, mp)`` grids of the KGE trainer.

The counterpart of ``dgl_operator_tpu/parallel/mesh.py``. The JAX
package lays its devices out as a ``jax.sharding.Mesh``; the port lays
out *slots*, the unit of ``DistKGETrainer`` (one sampler stream and one
batch each). A :class:`SlotMesh` numbers its slots row-major over its
axes, as the JAX batch ``PartitionSpec((dp, mp))`` flattens them: slot
``s`` of a ``dp x mp`` grid sits at ``(s // mp, s % mp)``.

- ``dp`` is data parallelism: every slot trains its own batch.
- ``mp`` is the entity table's sharding: on a 2-D grid the table is cut
  into ``mp`` blocks and replicated over ``dp`` (the KVStore's machine
  sharding); on a 1-D mesh every slot holds a block. In the training
  plane (:func:`make_train_mesh`) ``mp`` is the tensor-parallel axis the
  rule-selected parameters are stored in blocks over.

The slots live in one process, or are split evenly over the ranks of a
``torch.distributed`` group in slot order (:func:`my_slots`).
``shard_map`` and ``body_axis_size`` are version seams of JAX and have
no counterpart here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from dgl_operator_tpu_torch.parallel import collectives

DP_AXIS = "dp"
MP_AXIS = "mp"


class SlotMesh:
    """``size`` slots laid out row-major over ``axis_names``."""

    def __init__(self, shape: Dict[str, int]):
        if not shape or any(int(n) < 1 for n in shape.values()):
            raise ValueError(f"a mesh needs positive axis sizes, got "
                             f"{shape}")
        self.shape = {a: int(n) for a, n in shape.items()}
        self.axis_names = tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def table_axis(self) -> str:
        """The axis the entity table is sharded over: the only axis of a
        1-D mesh, ``mp`` of a 2-D one."""
        return self.axis_names[-1]

    @property
    def num_shards(self) -> int:
        return self.shape[self.table_axis]

    @property
    def replicas(self) -> int:
        """Copies of the table: ``dp`` on a 2-D grid, 1 on a 1-D mesh."""
        return self.size // self.num_shards

    def __repr__(self):
        return f"SlotMesh({self.shape})"


def make_mesh(num_dp: Optional[int] = None) -> SlotMesh:
    """A 1-D ``(dp,)`` mesh of ``num_dp`` slots (default: one a process
    of the group, or 1 without one)."""
    if num_dp is None:
        num_dp = collectives.world()[1]
    return SlotMesh({DP_AXIS: num_dp})


def make_mesh_2d(num_dp: int, num_mp: int) -> SlotMesh:
    """A ``dp x mp`` grid, dp outermost."""
    return SlotMesh({DP_AXIS: num_dp, MP_AXIS: num_mp})


def make_train_mesh(num_dp: int, tp_axis_size: int = 1) -> SlotMesh:
    """The training plane's mesh for a ``(zero_stage, tp_axis_size)``
    config: the 1-D ``(dp,)`` mesh when tensor parallelism is off, the
    dp-outermost ``dp x mp`` grid when ``tp_axis_size > 1`` (the shape
    ``TrainConfig.tp_axis_size`` is checked against; the rule-selected
    parameters are then stored in blocks over ``mp``,
    ``parallel/dp.py``)."""
    if int(tp_axis_size) <= 1:
        return make_mesh(num_dp)
    return make_mesh_2d(num_dp, int(tp_axis_size))


def axis_size(mesh: SlotMesh, axis: str = DP_AXIS) -> int:
    return int(mesh.shape[axis])


def local_dp_rank_slices(mesh: SlotMesh, n: int) -> Tuple[slice, ...]:
    """Equal slices of ``range(n)``, one a dp rank (the remainder
    dropped)."""
    k = axis_size(mesh)
    per = n // k
    return tuple(slice(i * per, (i + 1) * per) for i in range(k))


def my_slots(mesh: SlotMesh, rank: int, world: int) -> List[int]:
    """The slots process ``rank`` of ``world`` holds: an equal run of
    consecutive slots. On a 2-D grid a process holds whole dp rows, so
    it holds every block of the table (the replicas are across
    processes)."""
    if mesh.size % world:
        raise ValueError(f"{mesh.size} slots do not split over {world} "
                         "processes")
    per = mesh.size // world
    if mesh.replicas > 1 and per % mesh.num_shards:
        raise ValueError(
            f"a process of a {mesh.shape} grid must hold whole dp rows: "
            f"{world} processes hold {per} slots each")
    return list(range(rank * per, (rank + 1) * per))
