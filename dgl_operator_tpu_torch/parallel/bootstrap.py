"""Multi-process rendezvous: the operator's hostfile ->
``torch.distributed.init_process_group``.

The counterpart of ``dgl_operator_tpu/parallel/bootstrap.py``. The
operator renders its pods into a hostfile, one ``ip port podname
slots=N`` line per worker; ``revise_hostfile`` rewrites it per framework
and the workers rendezvous over TCP at the first entry, as the
reference's ``torch.distributed.launch`` does. Here every worker process
calls :func:`initialize_from_hostfile`, which opens the process group
with the world size of the hostfile and this process's line as its
rank.

Env contract (rendered by the operator):

    TPU_OPERATOR_HOSTFILE_PATH   path to the hostfile
    TPU_OPERATOR_RANK            this process's line index (else matched
                                 by hostname)
    TPU_OPERATOR_PHASE_ENV       workflow phase (launcher/partitioner/...)
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import List, Optional

import torch

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device

HOSTFILE_ENV = "TPU_OPERATOR_HOSTFILE_PATH"
RANK_ENV = "TPU_OPERATOR_RANK"
PHASE_ENV = "TPU_OPERATOR_PHASE_ENV"
# the elastic incarnation epoch the launcher exports on every shrink and
# regrow; the checkpoint plane's fences read it (not ported yet)
FENCE_EPOCH_ENV = "TPU_OPERATOR_ELASTIC_EPOCH"
DEFAULT_PORT = 30050  # the operator's DGL_PORT


@dataclasses.dataclass
class HostEntry:
    ip: str
    port: int
    name: str
    slots: int

    @property
    def addr(self) -> str:
        return f"{self.ip}:{self.port}"


def parse_hostfile(path: str) -> List[HostEntry]:
    """Parse the operator hostfile: ``ip port podname slots=N`` per
    line. Comment lines (``#``) and the launcher's own line (a name
    ending in ``launcher``) are skipped; a missing port is
    :data:`DEFAULT_PORT` and missing slots are 1."""
    entries: List[HostEntry] = []
    with open(path) as f:
        for ln in f:
            parts = ln.split()
            if not parts or parts[0].startswith("#"):
                continue
            name = parts[2] if len(parts) > 2 else parts[0]
            if name.endswith("launcher"):
                continue
            slots = 1
            for p in parts[3:]:
                if p.startswith("slots="):
                    slots = int(p.split("=", 1)[1])
            entries.append(HostEntry(parts[0], int(parts[1]) if len(parts) > 1
                                     else DEFAULT_PORT, name, slots))
    return entries


def my_rank(entries: List[HostEntry]) -> Optional[int]:
    """``TPU_OPERATOR_RANK`` when set, else the index of the entry whose
    name or address is this host's name, else None."""
    if RANK_ENV in os.environ:
        return int(os.environ[RANK_ENV])
    host = socket.gethostname()
    for i, e in enumerate(entries):
        if e.name == host or e.ip == host:
            return i
    return None


def default_backend(device: DeviceLike = None) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize_from_hostfile(path: Optional[str] = None,
                             rank: Optional[int] = None,
                             backend: Optional[str] = None,
                             device: DeviceLike = None,
                             timeout_s: float = 600.0) -> int:
    """Open the ``torch.distributed`` process group of the hostfile at
    ``path`` (default ``TPU_OPERATOR_HOSTFILE_PATH``): world size the
    number of entries, rendezvous at ``tcp://<first entry's ip:port>``,
    this process at ``rank`` (default :func:`my_rank`). Returns the rank.

    A missing hostfile, or one of 0 or 1 entries, is a single-process
    job: nothing is opened and the rank is 0. ``backend`` defaults to
    :func:`default_backend` of ``device``. A failed rendezvous raises;
    nothing is retried."""
    import torch.distributed as dist

    path = path or os.environ.get(HOSTFILE_ENV)
    if not path or not os.path.exists(path):
        return 0
    entries = parse_hostfile(path)
    if len(entries) <= 1:
        return 0
    if rank is None:
        rank = my_rank(entries)
    if rank is None:
        raise RuntimeError(
            f"cannot determine rank: hostname {socket.gethostname()!r} not "
            f"in hostfile and {RANK_ENV} unset")
    if not 0 <= rank < len(entries):
        raise RuntimeError(f"rank {rank} outside the hostfile's "
                           f"{len(entries)} entries")
    if backend is None:
        backend = default_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(resolve_device(device))
    dist.init_process_group(
        backend, init_method=f"tcp://{entries[0].addr}",
        world_size=len(entries), rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return rank


def write_hostfile(path: str, entries: List[HostEntry]) -> None:
    with open(path, "w") as f:
        for e in entries:
            f.write(f"{e.ip} {e.port} {e.name} slots={e.slots}\n")


def revise_hostfile(src: str, dst: str, style: str = "jax",
                    num_servers: int = 1) -> str:
    """Rewrite the hostfile for one framework: ``dgl`` -> "ip port";
    ``dglke`` -> "ip port num_servers"; ``jax`` -> coordinator-first
    "ip:port". Returns ``dst``."""
    entries = parse_hostfile(src)
    with open(dst, "w") as f:
        for e in entries:
            if style == "dgl":
                f.write(f"{e.ip} {e.port}\n")
            elif style == "dglke":
                f.write(f"{e.ip} {e.port} {num_servers}\n")
            elif style == "jax":
                f.write(f"{e.ip}:{e.port}\n")
            else:
                raise ValueError(style)
    return dst
