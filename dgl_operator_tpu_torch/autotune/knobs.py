"""The knob registry — each tunable's type, range, target layer and
default, for the knobs the port validates.

The port's own copy of the JAX package's registry
(``autotune/knobs.py``), cut to the entries its configs and planes
read: the SLO targets (``obs/slo.py``), the model-health knobs of
``TrainConfig`` (``obs/quality.py``) and the serving fleet's
(``serve/router.py``). Defaults, ranges and error messages are the JAX
package's. The manifest overlay and the search grid are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

# target layers a knob applies to
LAYERS = ("slo", "quality", "serve")

_CHOICE_MSG = "unknown {label} {value!r} (expected {choices})"
_RANGE_MSG = "{name} must be in [{lo}, {hi}], got {value}"
_GE_MSG = "{name} must be >= {lo}, got {value}"


def _fmt_num(v: float) -> str:
    return f"{v:g}"


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable: ``kind`` is ``"choice"`` (value in ``choices``),
    ``"int"`` / ``"float"`` (numeric in ``[lo, hi]``, ``hi=None``
    unbounded) or ``"bool"``."""

    name: str
    kind: str
    layer: str
    default: Any
    doc: str = ""
    choices: Optional[Tuple] = None
    lo: Optional[float] = None
    hi: Optional[float] = None

    def validate(self, value: Any) -> Any:
        """Return the value (coerced for numerics) or raise
        ``ValueError``."""
        if self.kind in ("choice", "bool"):
            choices = ((True, False) if self.kind == "bool"
                       else tuple(self.choices or ()))
            if value not in choices:
                raise ValueError(_CHOICE_MSG.format(
                    label=self.name, value=value,
                    choices=" or ".join(repr(c) for c in choices)))
            return value
        v = float(value) if self.kind == "float" else int(value)
        if self.lo is not None and v < self.lo:
            if self.hi is None:
                raise ValueError(_GE_MSG.format(
                    name=self.name, lo=_fmt_num(self.lo), value=v))
            raise ValueError(_RANGE_MSG.format(
                name=self.name, lo=_fmt_num(self.lo),
                hi=_fmt_num(self.hi), value=v))
        if self.hi is not None and v > self.hi:
            raise ValueError(_RANGE_MSG.format(
                name=self.name, lo=_fmt_num(self.lo),
                hi=_fmt_num(self.hi), value=v))
        return v


def _knob(*args, **kwargs) -> Tuple[str, Knob]:
    k = Knob(*args, **kwargs)
    if k.layer not in LAYERS:
        raise ValueError(f"knob {k.name}: unknown layer {k.layer!r}")
    return k.name, k


REGISTRY: Dict[str, Knob] = dict((
    # ---- SLO targets (obs/slo.py SLOMonitor) ---------------------------
    _knob("slo_p99_ms", "float", "slo", 250.0,
          "serving SLO: rolling-window p99 request latency ceiling "
          "(ms); breaches flip the micro-batcher to shedding", lo=0.0),
    _knob("slo_min_heartbeat_hz", "float", "slo", 0.0,
          "training SLO: minimum heartbeat rate (steps/s); 0 disables "
          "the floor", lo=0.0),
    _knob("slo_window_s", "float", "slo", 10.0,
          "rolling burn-rate window the SLO monitor evaluates over",
          lo=0.1),
    # ---- model health (obs/quality.py QualityMonitor) ------------------
    _knob("sentry", "bool", "quality", True,
          "numerics sentry: compute the in-step stats (grad/param "
          "norms, non-finite counts, per-partition loss) and run the "
          "rolling model-health detectors over them; trajectories are "
          "bit-identical either way"),
    _knob("quality_action", "choice", "quality", "rollback",
          "response to a numerics fault: 'warn' keeps training "
          "(events only), 'halt' raises NumericsFault at the step "
          "boundary, 'rollback' also quarantines post-fault "
          "checkpoints and marks the workspace",
          choices=("halt", "rollback", "warn")),
    _knob("quality_window", "int", "quality", 32,
          "rolling window (steps) of the EWMA divergence and "
          "grad-median detectors", lo=2),
    _knob("quality_z_max", "float", "quality", 6.0,
          "loss-divergence threshold: EWMA z-score above this emits "
          "loss_divergence", lo=0.0),
    _knob("quality_grad_ratio_max", "float", "quality", 50.0,
          "grad-explosion threshold: grad norm above this multiple of "
          "the rolling median emits grad_explosion (0 disables)",
          lo=0.0),
    _knob("quality_plateau_window", "int", "quality", 0,
          "plateau detector window (steps); 0 disables", lo=0),
    _knob("quality_plateau_rel", "float", "quality", 1e-3,
          "plateau threshold: loss range over the window below this "
          "fraction of its magnitude emits loss_plateau", lo=0.0),
    # ---- replicated serving plane (serve/router.py) --------------------
    _knob("replicas", "int", "serve", 1,
          "serving fleet width: how many ServeEngine replicas the "
          "router fans requests out to", lo=1),
    _knob("canary_frac", "float", "serve", 0.1,
          "fraction of routed traffic mirrored to the canary replica "
          "while a candidate checkpoint is staged", lo=0.0, hi=1.0),
))


def get(name: str) -> Knob:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown knob {name!r}; registered: "
                       f"{', '.join(sorted(REGISTRY))}") from None


def validate(name: str, value: Any) -> Any:
    """Validate one value against its registry entry."""
    return get(name).validate(value)


def default_of(name: str) -> Any:
    return get(name).default
