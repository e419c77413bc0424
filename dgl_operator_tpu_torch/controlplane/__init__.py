"""Control-plane driver — Python face of the native C++ operator.

The reconciler itself is the compiled ``tpu-operator`` binary, built at
first use from the port's ``native/controlplane/`` sources (reference
parity: controllers/dgljob_controller.go); this package supplies what
surrounds it:

- :mod:`~.api`         TPUGraphJob construction helpers (CRD-shaped dicts)
- :mod:`~.controller`  the reconcile loop: snapshot state -> run binary ->
                       apply actions to a cluster store
- :mod:`~.cluster`     FakeCluster, the in-process store used by tests
                       and the smoke (envtest-without-kubelet parity) and
                       the model for a kube API-server shim
- :mod:`~.kubeshim`    that shim: the manager against a real API server
                       through ``kubectl``

The port's copy of the JAX package's ``controlplane/``.
"""

from dgl_operator_tpu_torch.controlplane.api import (TPUGraphJob,
                                                     replica_spec,
                                                     simple_job)
from dgl_operator_tpu_torch.controlplane.cluster import FakeCluster
from dgl_operator_tpu_torch.controlplane.controller import (Controller,
                                                            operator_binary,
                                                            watcher_binary)

__all__ = [
    "TPUGraphJob", "replica_spec", "simple_job",
    "FakeCluster", "Controller", "operator_binary", "watcher_binary",
]
