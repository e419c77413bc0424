"""Skew-aware partition→host placement from measured telemetry.

Placeto (PAPERS.md) motivates learning device placement from measured
run behavior instead of assuming homogeneous hardware; the pragmatic
80% of that idea here is greedy LPT (longest-processing-time) over
MEASURED quantities the obs plane already records:

- per-host step rates from a prior job view's heartbeat stream
  (``obs/job/events.jsonl`` — the same per-step events the stall
  analytics read): a worker's pace is 1 / median heartbeat interval,
  aggregated per host;
- per-partition weights from the partition book (owned edges — the
  per-step aggregation cost driver; node counts as fallback).

LPT assigns the heaviest remaining partition to the host whose
projected finish time ``(load + weight) / rate`` is smallest, bounded
by the host's ``slots``. With one slot per host (the launch_train
contract: one partition per host) this reduces to heaviest→fastest
matching — an injected slow host provably receives the lightest
partition (pinned by tests/test_torch_autotune_search.py).

The emitted mapping is honored by hostfile generation: partition *i*
trains on the host at hostfile line *i* (launch_train rank order +
dispatch affinity), so placement is a REORDERING of hostfile entries.
``launcher/revise.py --placement`` applies it when rewriting the
framework hostfile, and ``tpurun`` regenerates its working hostfile
from the mapping before phases 3-5 — including on the controller's
stalled-job restart path: the relaunched driver re-derives placement
from the job view the straggler just polluted, so detection triggers
re-placement.

Stdlib-only: importable from the launcher and control-plane image.
The port's copy of the JAX package's ``autotune/placement.py``: the same
greedy order, tie-break and ``placement.json`` bytes, so either
package's driver places a job alike.
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Dict, List, Optional, Sequence

from dgl_operator_tpu_torch.obs.analyze import (_liveness, _median_interval,
                                                load_events)
from dgl_operator_tpu_torch.obs.collect import EVENTS_JSONL, job_dir_of
from dgl_operator_tpu_torch.parallel.bootstrap import HostEntry

PLACEMENT_JSON = "placement.json"


def host_of(worker: str) -> str:
    """Host component of an obs worker id (``host:pid:role``)."""
    return worker.split(":", 1)[0]


def host_step_rates(obs_dir: str,
                    grace_s: float = 1.0) -> Dict[str, float]:
    """Measured steps/sec per host from a prior run's heartbeat
    stream. Reads the ``obs/job/`` view when one was collected,
    falling back to the plain obs dir (the analyze_job convention).
    Hosts with no heartbeat data are absent — callers treat absent
    hosts as unmeasured (uniform rate)."""
    jd = job_dir_of(obs_dir)
    path = os.path.join(jd, EVENTS_JSONL)
    if not os.path.exists(path):
        path = os.path.join(obs_dir, EVENTS_JSONL)
    per_host: Dict[str, List[float]] = {}
    for w, rec in _liveness(load_events(path)).items():
        if len(rec["hb_ts"]) < 2:
            continue
        med = _median_interval(rec["hb_ts"], grace_s)
        if med > 0:
            per_host.setdefault(host_of(w), []).append(1.0 / med)
    # a host's pace is its median worker pace (robust to a resumed
    # successor sharing the host with its killed predecessor)
    return {h: statistics.median(rs) for h, rs in per_host.items()}


def part_weights(part_config: str) -> List[float]:
    """Per-partition load weight from the partition book: owned edges
    (the per-step aggregation cost driver), falling back to local
    node counts for books without edge counts."""
    with open(part_config) as f:
        meta = json.load(f)
    out = []
    for p in range(int(meta["num_parts"])):
        pm = meta.get(f"part-{p}", {})
        w = pm.get("num_edges") or pm.get("num_local_nodes") or 1
        out.append(float(w))
    return out


def lpt_assign(weights: Sequence[float], rates: Dict[str, float],
               slots: Optional[Dict[str, int]] = None
               ) -> Dict[int, str]:
    """Greedy LPT over measured rates: partitions in descending
    weight order, each to the host minimizing projected finish time
    ``(load + w) / rate`` among hosts with free slots (deterministic
    tie-break on host name). Returns ``{partition_index: host}``."""
    if not rates:
        raise ValueError("lpt_assign: no host rates")
    slots = dict(slots or {h: 1 for h in rates})
    cap = {h: int(slots.get(h, 1)) for h in rates}
    if sum(cap.values()) < len(weights):
        raise ValueError(
            f"lpt_assign: {len(weights)} partitions exceed "
            f"{sum(cap.values())} host slot(s)")
    load = {h: 0.0 for h in rates}
    used = {h: 0 for h in rates}
    assignment: Dict[int, str] = {}
    order = sorted(range(len(weights)),
                   key=lambda p: (-weights[p], p))
    for p in order:
        free = [h for h in sorted(rates) if used[h] < cap[h]]
        host = min(free, key=lambda h: (
            (load[h] + weights[p]) / max(rates[h], 1e-12), h))
        assignment[p] = host
        load[host] += weights[p]
        used[host] += 1
    return assignment


def derive(obs_dir: str, part_config: str,
           entries: Sequence[HostEntry]) -> Optional[Dict]:
    """Full placement derivation: measured host rates from a prior
    job view + partition weights from the book → LPT mapping.
    Returns the placement record (``{"assignment": {part: host},
    "rates", "weights"}``) or ``None`` when the job view carries no
    usable rate for ANY hostfile host (first run: nothing measured
    yet, keep the operator's order)."""
    weights = part_weights(part_config)
    measured = host_step_rates(obs_dir)
    names = [e.name for e in entries]
    rates = {n: measured[n] for n in names if n in measured}
    if not rates:
        return None
    # unmeasured hosts run at the measured median (unknown ≠ slow)
    med = statistics.median(rates.values())
    for n in names:
        rates.setdefault(n, med)
    slots = {e.name: max(int(e.slots), 1) for e in entries}
    assignment = lpt_assign(weights, rates, slots)
    return {"assignment": {str(p): h for p, h in assignment.items()},
            "rates": {h: round(r, 6) for h, r in sorted(rates.items())},
            "weights": weights}


def write_placement(path: str, placement: Dict) -> str:
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(placement, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_placement(path: str) -> Dict:
    with open(path) as f:
        placement = json.load(f)
    if not isinstance(placement.get("assignment"), dict):
        raise ValueError(f"placement {path}: missing 'assignment' map")
    return placement


def elastic_slots(num_parts: int, num_hosts: int) -> int:
    """Per-survivor slot budget for an elastic shrink: the P graph
    partitions stay fixed, so each of the H surviving hosts must be
    willing to take up to ceil(P / H) of them."""
    return -(-int(num_parts) // max(int(num_hosts), 1))


def apply_elastic_entries(entries: Sequence[HostEntry],
                          assignment: Dict) -> List[HostEntry]:
    """The elastic-shrink form of :func:`apply_to_entries`: hostfile
    line *i* is the host assigned partition *i*, and hosts MAY repeat
    (survivors take multiple partitions each). ``entries`` may itself
    already carry repeats (re-revising a shrunk hostfile) — the
    mapping is applied against the distinct hosts, so the operation is
    idempotent."""
    by_name: Dict[str, HostEntry] = {}
    for e in entries:
        by_name.setdefault(e.name, e)
    out: List[HostEntry] = []
    for p in range(len(assignment)):
        host = assignment.get(str(p), assignment.get(p))
        if host is None:
            raise ValueError(f"elastic placement: no host for "
                             f"partition {p}")
        if host not in by_name:
            raise ValueError(f"elastic placement: host {host!r} not "
                             "in hostfile")
        out.append(by_name[host])
    return out


def apply_to_entries(entries: Sequence[HostEntry],
                     assignment: Dict) -> List[HostEntry]:
    """Reorder hostfile entries so line *i* is the host assigned
    partition *i* (idempotent — applying a mapping to an already-
    placed hostfile reproduces it). Every assigned host must exist
    and every line must be consumed exactly once."""
    by_name = {e.name: e for e in entries}
    if len(by_name) != len(entries):
        raise ValueError("placement needs unique host names")
    out: List[HostEntry] = []
    seen = set()
    for p in range(len(entries)):
        host = assignment.get(str(p), assignment.get(p))
        if host is None:
            raise ValueError(f"placement: no host for partition {p}")
        if host not in by_name:
            raise ValueError(f"placement: host {host!r} not in "
                             "hostfile")
        if host in seen:
            raise ValueError(f"placement: host {host!r} assigned "
                             "twice (one hostfile line per host)")
        seen.add(host)
        out.append(by_name[host])
    return out
