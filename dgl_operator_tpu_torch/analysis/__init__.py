"""The port's lint — invariant-checking static analysis of
``dgl_operator_tpu_torch`` and ``chip_smoke.py``, the counterpart of
the JAX package's ``analysis/``.

Each rule turns one runtime invariant of the port into an AST check:
capture purity of CUDA-graph-captured and compiled functions, one
issue order for collectives, no read of a tensor lent to an async
collective, the knob registry as the single validation source, a
timeout on every subprocess, and the pinned record and telemetry key
catalogues.

Entry points:

- ``python -m dgl_operator_tpu_torch.analysis`` (:mod:`.cli`): console
  or ``--json`` report, per-line ``# tpu-lint: disable=<RULE>``
  suppressions, a committed baseline file, exit 1 on any
  non-baselined finding.
- :func:`run_lint` — the library face the tests use.

Rule catalogue (:mod:`.rules`; ``--list-rules`` prints each rule's
incident): TPU001 jit-purity (capture purity), TPU002
threaded-collective dispatch, TPU003 donation-after-use (a buffer lent
to an async collective), TPU004 knob-registry bypass, TPU005
naked-subprocess, TPU006 pinned-key drift.
"""

from dgl_operator_tpu_torch.analysis.core import (Finding, LintReport, Rule,
                                                  load_baseline, run_lint)
from dgl_operator_tpu_torch.analysis.rules import RULES, rule_by_code

__all__ = ["Finding", "LintReport", "Rule", "RULES", "rule_by_code",
           "load_baseline", "run_lint"]
