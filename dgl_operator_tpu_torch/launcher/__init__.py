"""The launcher: the workflow drivers ``tpurun`` (the dglrun
counterpart) and ``tpukerun`` (dglkerun), their fabric (exec and copy
over local, shell-wrapper or object-store transports), the retry layer
and the chaos plan.

The port's copy of the JAX package's ``launcher/``, torch-free, with its
names, flags, environment variables, ledger format and exit codes. The
elastic control plane (``elastic.py``) is ``ROADMAP.md`` Queue 1 item 7c.
"""

from dgl_operator_tpu_torch.launcher.fabric import (BatchFabricError, Fabric,
                                                    FabricError,
                                                    FabricTimeout,
                                                    LocalFabric, ShellFabric,
                                                    get_fabric, is_transient)
from dgl_operator_tpu_torch.launcher.chaos import ChaosFabric, ChaosPlan
from dgl_operator_tpu_torch.launcher.retry import RetryPolicy, RetryingFabric
from dgl_operator_tpu_torch.launcher.dispatch import dispatch_partitions
from dgl_operator_tpu_torch.launcher.launch import (launch_train,
                                                    run_copy_batch,
                                                    run_exec_batch)

__all__ = [
    "Fabric", "LocalFabric", "ShellFabric", "get_fabric",
    "FabricError", "FabricTimeout", "BatchFabricError", "is_transient",
    "ChaosFabric", "ChaosPlan", "RetryPolicy", "RetryingFabric",
    "dispatch_partitions", "run_exec_batch", "run_copy_batch",
    "launch_train",
]
