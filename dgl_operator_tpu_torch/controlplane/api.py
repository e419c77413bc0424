"""TPUGraphJob API types.

CRD-shaped job objects (group ``tpu.graph/v1alpha1``) mirroring the
reference's DGLJob (api/v1alpha1/dgljob_types.go:110-166): spec fields
``slotsPerWorker`` (TPU chips per worker here), ``partitionMode``
(TPU-API | External | Skip — DGL-API | ParMETIS | Skip parity),
``cleanPodPolicy`` (All | Running | None), and ``replicaSpecs`` keyed by
Launcher / Worker / Partitioner. Plain dicts keep the JSON boundary with
the native reconciler trivial.

The port's copy of the JAX package's ``controlplane/api.py``; the same
objects go through either package's reconciler alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

GROUP_VERSION = "tpu.graph/v1alpha1"
KIND = "TPUGraphJob"

PHASES = ("Starting", "Pending", "Partitioning", "Partitioned",
          "Training", "Completed", "Failed", "Evicted")
REPLICA_TYPES = ("Launcher", "Worker", "Partitioner")
PARTITION_MODES = ("TPU-API", "External", "Skip")
CLEAN_POD_POLICIES = ("All", "Running", "None")
GANG_SCHEDULERS = ("", "volcano", "coscheduling")
# the launcher pod's default command: the port's workflow driver
DEFAULT_LAUNCHER_COMMAND = ("python3", "-m",
                            "dgl_operator_tpu_torch.launcher.tpurun")


def replica_spec(replicas: int, image: str = "tpugraph-worker:latest",
                 command: Optional[list] = None,
                 args: Optional[list] = None,
                 resources: Optional[dict] = None) -> Dict[str, Any]:
    container: Dict[str, Any] = {"name": "main", "image": image}
    if command:
        container["command"] = list(command)
    if args:
        container["args"] = list(args)
    if resources:
        container["resources"] = resources
    return {"replicas": replicas,
            "template": {"spec": {"containers": [container]}}}


@dataclasses.dataclass
class TPUGraphJob:
    name: str
    namespace: str = "default"
    partition_mode: str = "TPU-API"
    clean_pod_policy: str = "Running"
    slots_per_worker: int = 1
    gang_scheduler: str = ""
    scheduler_name: str = ""   # override for gang-scheduled workers
    # multi-host TPU slice placement (spec.tpu): accelerator selects the
    # GKE node pool (cloud.google.com/gke-tpu-accelerator); topology the
    # physical slice shape (cloud.google.com/gke-tpu-topology), derived
    # from slotsPerWorker x workers when empty
    tpu_accelerator: str = ""
    tpu_topology: str = ""
    replica_specs: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    status: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.partition_mode not in PARTITION_MODES:
            raise ValueError(f"partitionMode must be one of "
                             f"{PARTITION_MODES}, got {self.partition_mode}")
        if self.clean_pod_policy not in CLEAN_POD_POLICIES:
            raise ValueError(f"cleanPodPolicy must be one of "
                             f"{CLEAN_POD_POLICIES}, "
                             f"got {self.clean_pod_policy}")
        if self.gang_scheduler not in GANG_SCHEDULERS:
            raise ValueError(f"gangScheduler must be one of "
                             f"{GANG_SCHEDULERS}, "
                             f"got {self.gang_scheduler}")

    def to_dict(self) -> Dict[str, Any]:
        spec = {
            "slotsPerWorker": self.slots_per_worker,
            "partitionMode": self.partition_mode,
            "cleanPodPolicy": self.clean_pod_policy,
            "replicaSpecs": self.replica_specs,
        }
        if self.gang_scheduler:
            spec["gangScheduler"] = self.gang_scheduler
        if self.scheduler_name:
            spec["schedulerName"] = self.scheduler_name
        if self.tpu_accelerator or self.tpu_topology:
            tpu: Dict[str, Any] = {}
            if self.tpu_accelerator:
                tpu["accelerator"] = self.tpu_accelerator
            if self.tpu_topology:
                tpu["topology"] = self.tpu_topology
            spec["tpu"] = tpu
        return {
            "apiVersion": GROUP_VERSION,
            "kind": KIND,
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": spec,
            "status": self.status,
        }

    @property
    def launcher_name(self) -> str:
        return f"{self.name}-launcher"

    @property
    def partitioner_name(self) -> str:
        return f"{self.name}-partitioner"

    def worker_name(self, i: int) -> str:
        return f"{self.name}-worker-{i}"


def simple_job(name: str, num_workers: int,
               launcher_command: Optional[list] = None,
               partition_mode: str = "TPU-API",
               clean_pod_policy: str = "Running",
               slots_per_worker: int = 1,
               gang_scheduler: str = "",
               scheduler_name: str = "",
               tpu_accelerator: str = "",
               tpu_topology: str = "") -> TPUGraphJob:
    """A job like the GraphSAGE_dist example manifest
    (examples/v1alpha1/GraphSAGE_dist.yaml): one launcher running the
    workflow driver (by default the port's ``tpurun``, started by
    module), N workers, operator-injected partitioner."""
    specs = {
        "Launcher": replica_spec(1, command=launcher_command
                                 or list(DEFAULT_LAUNCHER_COMMAND)),
    }
    if num_workers > 0 or partition_mode != "Skip":
        specs["Worker"] = replica_spec(num_workers)
    return TPUGraphJob(name=name, partition_mode=partition_mode,
                       clean_pod_policy=clean_pod_policy,
                       slots_per_worker=slots_per_worker,
                       gang_scheduler=gang_scheduler,
                       scheduler_name=scheduler_name,
                       tpu_accelerator=tpu_accelerator,
                       tpu_topology=tpu_topology,
                       replica_specs=specs)
