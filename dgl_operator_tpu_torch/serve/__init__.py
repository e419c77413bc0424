"""Online GNN inference serving plane.

- :mod:`~.batcher`: the request micro-batcher (concurrent queries
  coalesced into padded fixed-shape batches under a deadline, with
  load shedding).
- :mod:`~.engine`: the owner-sharded inference engine (per-partition
  fanout sampling, halo-aware feature gather, the forward on the card).
- :mod:`~.server`: the HTTP front end (``/predict``, ``/healthz``,
  ``/metrics``, ``/livez``), ``python -m
  dgl_operator_tpu_torch.serve.server``.
- :mod:`~.router`: the fleet front end (consistent-hash routing by
  owner partition, health-weighted failover, canary promotion).
"""

from dgl_operator_tpu_torch.serve.batcher import (MicroBatcher,  # noqa: F401
                                                  Overloaded)
from dgl_operator_tpu_torch.serve.engine import (ServeConfig,  # noqa: F401
                                                 ServeEngine)
from dgl_operator_tpu_torch.serve.router import (CanaryController,  # noqa: F401
                                                 FleetRouter, HashRing,
                                                 Replica, RouterPlane,
                                                 weight_of)
from dgl_operator_tpu_torch.serve.server import (ServingPlane,  # noqa: F401
                                                 infer_sage_dims)
