"""Elastic fault-domain re-planning — health-triggered shrink and
regrow of the partition→host mapping.

The reference operator's only answer to a lost worker is a full
delete-and-recreate restart that blocks until every pod returns
(PAPER.md Evicted→recreate). Here a host declared *dead* — the chaos
``host:die`` marker, the fabric's fatal
:class:`~.fabric.FabricHostLost` taxonomy, or a ``host_died`` event in
the live health plane — triggers a re-plan instead of a wait:

- **shrink**: keep the P graph partitions fixed, re-run the greedy-LPT
  placement (autotune/placement.py) over the *surviving* hosts with
  ceil(P / H) slots each, regenerate the working hostfile (partition
  *i* trains on line *i*; survivors repeat), bump the incarnation
  *epoch* (exported as ``TPU_OPERATOR_ELASTIC_EPOCH`` → the
  checkpoint fence, runtime/checkpoint.py), and relaunch from the last
  checkpoint on the shrunk mapping. Because partitioning is untouched
  and sampler streams are keyed by (step position, partition), the
  post-shrink trajectory is bit-identical to an undisturbed run
  (pinned by tests/test_torch_elastic.py and ``chip_smoke.py``'s
  ``elastic`` phase).
- **regrow**: at the next (re)launch — a checkpoint boundary by
  construction, since every relaunch resumes from the last fenced
  checkpoint — a previously dead host that answers a liveness probe
  again is readmitted: the mapping returns to full width under a fresh
  epoch.

The plan persists as ``<workspace>/elastic.json`` and the shrunk
hostfile as ``<workspace>/hostfile_elastic``; both are consumed by
``tpurun --elastic`` (ledger-signature-busting, so phases 3-5 re-run
against the new mapping) and by the phase-4 ``revise --placement``
pass on every worker.

Stdlib-only: importable from the launcher and control-plane image.
The port's copy of the JAX package's ``launcher/elastic.py``, with its
file names, events and ``epoch-<n>`` signature, so either package's
driver resumes the other's plan.
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Dict, List, Optional, Sequence

from dgl_operator_tpu_torch.autotune import placement as PL
from dgl_operator_tpu_torch.launcher import chaos
from dgl_operator_tpu_torch.launcher.fabric import (BatchFabricError,
                                                    FabricHostLost)
from dgl_operator_tpu_torch.obs import get_obs
from dgl_operator_tpu_torch.parallel.bootstrap import (FENCE_EPOCH_ENV,
                                                       HostEntry,
                                                       parse_hostfile,
                                                       write_hostfile)

ELASTIC_JSON = "elastic.json"
ELASTIC_HOSTFILE = "hostfile_elastic"


def plan_path(workspace: str) -> str:
    return os.path.join(workspace, ELASTIC_JSON)


def load_plan(workspace: str) -> Optional[Dict]:
    try:
        with open(plan_path(workspace)) as f:
            plan = json.load(f)
        return plan if isinstance(plan, dict) and plan.get("elastic") \
            else None
    except (OSError, ValueError):
        return None


def save_plan(workspace: str, plan: Dict) -> str:
    return PL.write_placement(plan_path(workspace), plan)


def current_epoch(workspace: str) -> int:
    plan = load_plan(workspace)
    return int(plan.get("epoch", 0)) if plan else 0


def export_epoch(epoch: int) -> None:
    """Publish the incarnation epoch to every child this driver spawns
    (LocalFabric inherits the env; launch_train forwards it explicitly
    for shell fabrics) — the trainers' checkpoint managers fence their
    publications with it (runtime/checkpoint.py)."""
    os.environ[FENCE_EPOCH_ENV] = str(int(epoch))


def _unique_entries(entries: Sequence[HostEntry]) -> List[HostEntry]:
    seen: Dict[str, HostEntry] = {}
    for e in entries:
        seen.setdefault(e.name, e)
    return list(seen.values())


def hosts_lost_in(exc: Optional[BaseException]) -> List[str]:
    """Hosts the fabric's error taxonomy declared permanently gone:
    every :class:`FabricHostLost` in the exception chain (directly, or
    carried inside a :class:`BatchFabricError`'s per-host failures).
    Transient/retry-exhausted failures do NOT count — those stay on
    the stalled→restart path; only a *fatal* host loss justifies
    re-placing its partitions."""
    out: List[str] = []
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, FabricHostLost) and exc.host:
            out.append(exc.host)
        if isinstance(exc, BatchFabricError):
            for _, host, err in exc.failures:
                if isinstance(err, FabricHostLost):
                    out.append(err.host or host)
        exc = exc.__cause__ or exc.__context__
    return sorted(set(out))


def detect_dead(workspace: str, entries: Sequence[HostEntry],
                exc: Optional[BaseException] = None,
                obs_dir: Optional[str] = None) -> List[str]:
    """Union of every dead-host signal, restricted to hosts actually
    in the current mapping: the chaos dead-marker registry, the
    exception chain's :class:`FabricHostLost` taxonomy, and the health
    plane's ``host_died`` events (obs/analyze.py ``job_health``)."""
    names = {e.name for e in entries}
    dead = {h for h in chaos.dead_hosts(workspace) if h in names}
    dead.update(h for h in hosts_lost_in(exc) if h in names)
    if obs_dir:
        try:
            from dgl_operator_tpu_torch.obs.analyze import job_health
            snap = job_health(obs_dir)
            dead.update(h for h in snap.get("dead_hosts", [])
                        if h in names)
        except Exception:  # noqa: BLE001 — detection is best-effort
            pass
    return sorted(dead)


def plan_shrink(part_config: str, entries: Sequence[HostEntry],
                dead: Sequence[str],
                obs_dir: Optional[str] = None) -> Dict:
    """Re-place the fixed P partitions over the surviving hosts:
    greedy LPT (autotune/placement.py) over measured per-host step
    rates when the obs job view carries any (unmeasured survivors run
    at the measured median; no measurements at all = uniform), with
    ceil(P / H) slots per survivor. Returns the elastic plan record —
    the epoch is stamped by :func:`apply_shrink`."""
    uniq = _unique_entries(entries)
    survivors = [e for e in uniq if e.name not in set(dead)]
    if not survivors:
        raise ValueError("elastic shrink: every host is dead — "
                         "nothing left to place partitions on")
    weights = PL.part_weights(part_config)
    measured: Dict[str, float] = {}
    if obs_dir:
        try:
            rates = PL.host_step_rates(obs_dir)
            measured = {e.name: rates[e.name] for e in survivors
                        if e.name in rates}
        except Exception:  # noqa: BLE001 — rates only refine the plan
            measured = {}
    med = statistics.median(measured.values()) if measured else 1.0
    full_rates = {e.name: measured.get(e.name, med) for e in survivors}
    k = PL.elastic_slots(len(weights), len(survivors))
    slots = {e.name: k for e in survivors}
    assignment = PL.lpt_assign(weights, full_rates, slots)
    return {
        "elastic": True,
        "assignment": {str(p): h for p, h in assignment.items()},
        "dead": sorted(set(dead)),
        "width": len(survivors),
        "full_width": len(uniq),
        "rates": {h: round(r, 6) for h, r in sorted(full_rates.items())},
        "weights": weights,
    }


def write_shrunk_hostfile(workspace: str,
                          entries: Sequence[HostEntry],
                          plan: Dict) -> str:
    ordered = PL.apply_elastic_entries(entries, plan["assignment"])
    path = os.path.join(workspace, ELASTIC_HOSTFILE)
    write_hostfile(path, ordered)
    return path


def apply_shrink(workspace: str, entries: Sequence[HostEntry],
                 plan: Dict) -> str:
    """Commit a shrink: bump + export the incarnation epoch (fencing
    the previous incarnation's checkpoints out), persist the plan,
    regenerate the working hostfile, and record the edge. Returns the
    shrunk hostfile path; the caller's ``plan`` dict is stamped with
    the committed ``epoch`` in place."""
    plan["epoch"] = current_epoch(workspace) + 1
    save_plan(workspace, plan)
    export_epoch(plan["epoch"])
    hf = write_shrunk_hostfile(workspace, entries, plan)
    obs = get_obs()
    obs.metrics.counter(
        "elastic_shrinks_total",
        "elastic shrink edges: dead hosts re-placed over survivors"
    ).inc()
    obs.emit("elastic_shrink", dead=plan["dead"], width=plan["width"],
             full_width=plan["full_width"], epoch=plan["epoch"],
             assignment=plan["assignment"], hostfile=hf)
    return hf


def host_alive(fabric, host: str) -> bool:
    """Liveness probe for the regrow edge: one no-op exec. A chaos
    dead marker fails it through the fabric's own FabricHostLost path,
    so readmission requires BOTH the marker cleared and the host
    actually answering."""
    try:
        fabric.exec(host, "true")
        return True
    except Exception:  # noqa: BLE001 — any failure = not yet back
        return False


def maybe_regrow(workspace: str, entries: Sequence[HostEntry],
                 fabric) -> bool:
    """The regrow edge: when every host the current plan shrank around
    answers the liveness probe again, re-place back to full width
    (identity mapping — partition *i* on hostfile line *i*) under a
    fresh fenced epoch. Runs at (re)launch time, which IS the next
    checkpoint boundary: the relaunch resumes from the last fenced
    checkpoint. Returns whether a regrow happened."""
    plan = load_plan(workspace)
    if not plan or not plan.get("dead"):
        return False
    if not all(host_alive(fabric, h) for h in plan["dead"]):
        return False
    uniq = _unique_entries(entries)
    epoch = int(plan.get("epoch", 0)) + 1
    save_plan(workspace, {
        "elastic": True, "epoch": epoch, "dead": [],
        "width": len(uniq), "full_width": len(uniq),
        "assignment": {str(i): e.name for i, e in enumerate(uniq)},
    })
    export_epoch(epoch)
    obs = get_obs()
    obs.metrics.counter(
        "elastic_regrows_total",
        "elastic regrow edges: readmitted hosts re-placed to full "
        "width").inc()
    obs.emit("elastic_regrow", hosts=plan["dead"], epoch=epoch,
             width=len(uniq))
    return True


def resolve(args, workspace: str, part_config: str, hostfile: str,
            fabric) -> str:
    """Driver-start elastic resolution for ``tpurun --elastic``:

    - no plan yet → fenced epoch 0, operator hostfile;
    - shrunk plan, dead hosts all probing alive → **regrow** to full
      width (fresh epoch), operator hostfile;
    - shrunk plan, hosts still dead → regenerate the shrunk hostfile
      from the persisted plan and stay at its epoch.

    Sets ``args.elastic_sig`` (the phase-ledger signature component —
    a changed mapping re-runs dispatch/revise/launch) and
    ``args.placement_path`` (phase 4's revise applies the same
    mapping on every worker) as side effects."""
    entries = parse_hostfile(hostfile)
    plan = load_plan(workspace)
    if plan and plan.get("dead"):
        if maybe_regrow(workspace, entries, fabric):
            plan = load_plan(workspace)
        else:
            hf = write_shrunk_hostfile(workspace, entries, plan)
            export_epoch(int(plan["epoch"]))
            args.elastic_sig = f"epoch-{plan['epoch']}"
            args.placement_path = plan_path(workspace)
            return hf
    epoch = int(plan.get("epoch", 0)) if plan else 0
    export_epoch(epoch)
    args.elastic_sig = f"epoch-{epoch}"
    return hostfile
