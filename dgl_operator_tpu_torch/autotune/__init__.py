"""Telemetry-driven auto-tuning: the knob registry, the probes that
measure a configuration, the search over them and the placement of
partitions on hosts.

- :mod:`~.knobs` — the knob REGISTRY: one declaration per tunable
  (type, range, target layer, probe grid) and the ``tuned.json``
  manifest overlay the trainers read (``TPU_OPERATOR_TUNED_MANIFEST``).
- :mod:`~.probe` — short, seeded, few-step ``DistTrainer`` probes in a
  subprocess (``python -m dgl_operator_tpu_torch.autotune.probe``),
  scored ONLY from the run's own ``obs/`` artifacts
  (``metrics.json`` throughput + ``skew_summary``).
- :mod:`~.search` — successive halving over the registry space with a
  deterministic rung schedule and a resumable probe ledger, whose
  winner :func:`~.knobs.write_manifest` turns into the manifest
  ``tpurun --tuned-manifest`` and both trainers consume.
- :mod:`~.placement` — skew-aware partition→host placement: greedy
  LPT of the book's partition weights over measured per-host step
  rates from a prior job view (``tpurun --placement``,
  ``revise --placement``).

The port's copy of the JAX package's ``autotune/``, with the same
names and file formats.
"""

from dgl_operator_tpu_torch.autotune.knobs import (REGISTRY,  # noqa: F401
                                                   Knob,
                                                   TUNED_MANIFEST_ENV,
                                                   apply_tuned,
                                                   load_manifest,
                                                   overrides_for,
                                                   search_space, validate,
                                                   write_manifest)
from dgl_operator_tpu_torch.autotune.search import (  # noqa: F401
    SearchLedger, successive_halving)
