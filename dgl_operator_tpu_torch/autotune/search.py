"""Successive-halving knob search with a deterministic rung schedule
and a resumable probe ledger.

Successive halving (the core of Hyperband) fits this probe economy
exactly: most of a knob sweep's cost is configurations that are
obviously bad after a few steps, so rung 0 probes every candidate
cheaply, each following rung doubles (``eta``) the probe budget and
keeps only the top ``1/eta`` — the winner gets the most measurement
where it matters. Everything is deterministic: candidates come from a
seeded draw over the registry grid (the DEFAULT configuration is
always candidate 0, so every survivor out-scored the defaults on a
shared rung before the search can crown it), ties break on the
stable config key, and a fixed seed reproduces the
identical rung schedule and winner (pinned by
tests/test_torch_autotune_search.py).

Resume rides the same pattern as the tpurun phase ledger
(launcher/tpurun.py): every completed probe is recorded under a
search-signature-keyed JSON ledger with atomic writes, so a killed
search relaunches and skips straight past the rungs it already paid
for — probe results are a function of (config, steps, seed), which is
exactly the ledger key.

The probe function is injected (``probe_fn(knobs, steps, rung)`` →
``{"score": float, ...}``); production passes
:func:`dgl_operator_tpu_torch.autotune.probe.make_probe_fn` and tests
pass a synthetic scorer.

The port's copy of the JAX package's ``autotune/search.py``: the same
draw, tie-break and ledger signature, so one space and seed give the
same candidates, rungs and winner in both packages, and a ledger either
writes resumes in the other.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dgl_operator_tpu_torch.autotune import knobs as K
from dgl_operator_tpu_torch.launcher import console
from dgl_operator_tpu_torch.obs import get_obs


def config_key(cfg: Dict) -> str:
    """Stable identity of one candidate (sorted k=v list) — the
    ledger key component and the deterministic tie-breaker."""
    return ",".join(f"{k}={cfg[k]!r}" for k in sorted(cfg))


def sample_configs(space: Dict[str, Sequence], n: int,
                   seed: int) -> List[Dict]:
    """Deterministic candidate draw: candidate 0 is the registry
    DEFAULT for every searched knob (clamped into the grid is not
    needed — defaults are always legal), the rest are a seeded
    sample of distinct grid points. When the full grid is smaller
    than ``n`` the whole grid is returned (stable order)."""
    names = sorted(space)
    default = {m: K.default_of(m) for m in names}
    grid_size = 1
    for m in names:
        grid_size *= len(space[m])
    rng = random.Random(seed)
    out, seen = [default], {config_key(default)}
    if grid_size <= n:
        # exhaustive: enumerate the grid in stable order
        combos = [{}]
        for m in names:
            combos = [dict(c, **{m: v}) for c in combos
                      for v in space[m]]
        for c in sorted(combos, key=config_key):
            if config_key(c) not in seen:
                seen.add(config_key(c))
                out.append(c)
        return out
    attempts = 0
    while len(out) < n and attempts < 200 * n:
        attempts += 1
        c = {m: rng.choice(list(space[m])) for m in names}
        if config_key(c) not in seen:
            seen.add(config_key(c))
            out.append(c)
    return out


def rung_schedule(n0: int, base_steps: int, eta: int = 2,
                  ) -> List[Tuple[int, int, int]]:
    """The deterministic (rung, probe_steps, n_configs) ladder:
    rung r probes ``ceil(n_{r-1}/eta)`` survivors at
    ``base_steps * eta^r`` steps, down to a single winner."""
    sched, n, r = [], int(n0), 0
    while True:
        sched.append((r, base_steps * (eta ** r), n))
        if n <= 1:
            return sched
        n = math.ceil(n / eta)
        r += 1


class SearchLedger:
    """Probe-result ledger (the tpurun PhaseLedger pattern): keyed by
    a signature of the search definition, atomic tmp+rename writes,
    tolerant of a torn/absent file. A relaunched search with the same
    definition skips every probe already recorded; a different
    definition starts fresh."""

    def __init__(self, path: Optional[str], signature: str):
        self.path = path
        self.signature = signature
        self._probes: Dict[str, Dict] = {}
        if not path:
            return
        try:
            with open(path) as f:
                data = json.load(f)
            if data.get("signature") == signature:
                self._probes = data.get("probes", {})
        except (OSError, ValueError):
            self._probes = {}

    @staticmethod
    def signature_of(space: Dict[str, Sequence], n0: int, eta: int,
                     base_steps: int, seed: int) -> str:
        ident = {"space": {m: [repr(v) for v in vs]
                           for m, vs in sorted(space.items())},
                 "n0": n0, "eta": eta, "base_steps": base_steps,
                 "seed": seed}
        return hashlib.sha1(json.dumps(
            ident, sort_keys=True).encode()).hexdigest()[:16]

    def get(self, key: str) -> Optional[Dict]:
        return self._probes.get(key)

    def put(self, key: str, rec: Dict) -> None:
        self._probes[key] = rec
        if not self.path:
            return
        try:
            os.makedirs(os.path.dirname(self.path) or ".",
                        exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"signature": self.signature,
                           "probes": self._probes}, f, indent=2,
                          sort_keys=True)
            os.replace(tmp, self.path)
        except OSError as exc:
            # an unwritable ledger must not fail the search — it only
            # costs a relaunch its skip
            console.log(
                f"autotune: ledger write failed ({exc}); a relaunch "
                "will re-run completed probes",
                event="autotune_ledger_write_failed", error=str(exc))


def successive_halving(space: Dict[str, Sequence],
                       probe_fn: Callable[[Dict, int, int], Dict], *,
                       n0: int = 8, eta: int = 2, base_steps: int = 2,
                       seed: int = 0,
                       ledger_path: Optional[str] = None) -> Dict:
    """Run the search; returns ``{"winner", "winner_score", "rungs",
    "schedule", "probes_run", "probes_skipped", "signature"}``.

    ``probe_fn(knobs, steps, rung)`` must return a dict with a float
    ``"score"`` (higher is better; the obs-artifact scorer returns
    seeds/sec). Survivor selection sorts by (-score, config_key) —
    fully deterministic. Probes found in the ledger are NOT re-run
    (resume); every fresh probe is recorded before the next starts,
    so a kill loses at most the in-flight probe.
    """
    obs = get_obs()
    sig = SearchLedger.signature_of(space, n0, eta, base_steps, seed)
    ledger = SearchLedger(ledger_path, sig)
    configs = sample_configs(space, n0, seed)
    sched = rung_schedule(len(configs), base_steps, eta)
    probes_c = obs.metrics.counter(
        "autotune_probes_total", "autotune probes by outcome",
        labels=("status",))
    rungs: List[Dict] = []
    run = skipped = 0
    for r, steps, n_expect in sched:
        assert len(configs) == n_expect, (r, len(configs), n_expect)
        scored: List[Tuple[float, str, Dict, Dict]] = []
        for cfg in configs:
            key = f"r{r}:s{steps}:{config_key(cfg)}"
            rec = ledger.get(key)
            if rec is None:
                rec = dict(probe_fn(cfg, steps, r))
                rec["knobs"] = cfg
                rec["steps"] = steps
                ledger.put(key, rec)
                run += 1
                probes_c.inc(status="run")
                obs.emit("autotune_probe", rung=r, steps=steps,
                         key=config_key(cfg), score=rec.get("score"))
            else:
                skipped += 1
                probes_c.inc(status="ledger_skip")
            scored.append((float(rec.get("score", float("-inf"))),
                           config_key(cfg), cfg, rec))
        scored.sort(key=lambda t: (-t[0], t[1]))
        keep = (math.ceil(len(scored) / eta) if len(scored) > 1 else 1)
        rungs.append({
            "rung": r, "steps": steps,
            "scores": {k: s for s, k, _, _ in scored},
            "survivors": [k for _, k, _, _ in scored[:keep]],
        })
        obs.emit("autotune_rung", rung=r, steps=steps, survivors=keep,
                 of=len(scored))
        configs = [c for _, _, c, _ in scored[:keep]]
    winner_score, _, winner, _ = scored[0]
    obs.metrics.gauge("autotune_best_score",
                      "winning probe score of the last search").set(
                          winner_score)
    obs.flush()
    return {"winner": winner, "winner_score": winner_score,
            "rungs": rungs, "schedule": sched, "probes_run": run,
            "probes_skipped": skipped, "signature": sig}
