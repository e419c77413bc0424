"""Rolling-window SLO evaluation with burn-rate hysteresis.

One slow request must not flip the serving plane into shedding, and
one fast one must not flip it back. The monitor evaluates each target
over a rolling window of observations and acts on the burn rate (the
share of the window's evaluations in breach): breach engages when the
burn rate reaches ``burn_threshold`` and releases when it drops below.

Targets come from the knob registry's ``slo`` layer
(``autotune/knobs.py``: ``slo_p99_ms``, ``slo_min_heartbeat_hz``,
``slo_window_s``). The serving plane feeds :meth:`SLOMonitor.evaluate`
with :meth:`~.live.LiveFeed.snapshot` payloads and routes the verdict
into the micro-batcher's shed switch (``serve/server.py``); breach and
recovery edges are events (``slo_breach`` / ``slo_recovered``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from dgl_operator_tpu_torch.autotune.knobs import REGISTRY, default_of
from dgl_operator_tpu_torch.obs import get_obs

DEFAULT_BURN_THRESHOLD = 0.5
_SLO_KNOB_PREFIX = "slo_"
# knobs that configure the monitor itself rather than naming a target
_NON_TARGET_KNOBS = ("slo_window_s",)


def default_targets() -> Dict[str, float]:
    """Target thresholds from the registry's ``slo`` layer, keyed
    without the ``slo_`` prefix (``p99_ms``, ``min_heartbeat_hz``)."""
    return {name[len(_SLO_KNOB_PREFIX):]: k.default
            for name, k in REGISTRY.items()
            if k.layer == "slo" and name not in _NON_TARGET_KNOBS}


def default_window_s() -> float:
    return float(default_of("slo_window_s"))


class SLOMonitor:
    """Evaluate live snapshots against SLO targets; report the targets
    in breach and emit edge telemetry.

    - ``p99_ms``: breach when the window's p99 request latency exceeds
      the ceiling;
    - ``min_heartbeat_hz``: breach when the heartbeat rate falls below
      the floor.

    A signal absent from the snapshot is skipped."""

    def __init__(self, targets: Optional[Dict[str, float]] = None,
                 window_s: Optional[float] = None,
                 burn_threshold: float = DEFAULT_BURN_THRESHOLD,
                 clock: Callable[[], float] = time.time):
        self.targets = (dict(targets) if targets is not None
                        else default_targets())
        self.window_s = float(window_s if window_s is not None
                              else default_window_s())
        self.burn_threshold = float(burn_threshold)
        self._clock = clock
        self._evals: Dict[str, Deque[Tuple[float, bool]]] = {}
        self._breaching: Dict[str, bool] = {}

    def _checks(self, snap: Dict) -> List[Tuple[str, float, float, bool]]:
        out: List[Tuple[str, float, float, bool]] = []
        t = self.targets
        p99 = snap.get("p99_ms")
        if t.get("p99_ms") is not None and p99 is not None:
            out.append(("p99_ms", float(p99), float(t["p99_ms"]),
                        float(p99) > float(t["p99_ms"])))
        hz = snap.get("heartbeat_hz")
        if t.get("min_heartbeat_hz") and hz is not None \
                and not snap.get("done"):
            out.append(("min_heartbeat_hz", float(hz),
                        float(t["min_heartbeat_hz"]),
                        float(hz) < float(t["min_heartbeat_hz"])))
        return out

    def evaluate(self, snap: Dict) -> List[Dict]:
        """Fold one live snapshot into the rolling windows; returns the
        targets in breach (empty: every SLO met). Breach and recovery
        edges are evented and counted; each target's burn rate is the
        ``slo_burn_rate`` gauge."""
        obs = get_obs()
        now = self._clock()
        breaches: List[Dict] = []
        for name, value, threshold, bad in self._checks(snap):
            dq = self._evals.setdefault(name, deque())
            dq.append((now, bad))
            while dq and dq[0][0] < now - self.window_s:
                dq.popleft()
            burn = sum(1 for _, b in dq if b) / len(dq)
            breaching = burn >= self.burn_threshold
            obs.metrics.gauge(
                "slo_burn_rate",
                "fraction of the rolling window in breach per target",
                labels=("target",)).set(burn, target=name)
            prev = self._breaching.get(name, False)
            if breaching and not prev:
                obs.metrics.counter(
                    "slo_breaches_total",
                    "SLO targets that entered breach state",
                    labels=("target",)).inc(target=name)
                obs.emit("slo_breach", target=name, value=round(value, 4),
                         threshold=threshold, burn_rate=round(burn, 3))
            elif prev and not breaching:
                obs.emit("slo_recovered", target=name,
                         value=round(value, 4), threshold=threshold,
                         burn_rate=round(burn, 3))
            self._breaching[name] = breaching
            if breaching:
                breaches.append({"target": name,
                                 "value": round(value, 4),
                                 "threshold": threshold,
                                 "burn_rate": round(burn, 3)})
        return breaches

    def state(self) -> Dict:
        """The current verdict for ``/livez``: overall ok and the
        targets in breach."""
        breaching = sorted(n for n, b in self._breaching.items() if b)
        return {"ok": not breaching, "breaching": breaching,
                "targets": dict(self.targets)}
