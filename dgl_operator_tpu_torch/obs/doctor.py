"""``tpu-doctor`` — render a job's telemetry into a diagnosis a human
(or the controller) can act on.

The reference stack answers "why is this job slow/stuck" with
``kubectl exec`` and hope. Here the answer is computed from artifacts
the run already left behind: the doctor loads the ``obs/job/`` view
(building one in place from a plain single-host ``obs/`` directory
when no collection ran), runs the analytics (``obs/analyze.py``), and
emits both a human-readable report and ``obs/job/report.json``.

Usage::

    python -m dgl_operator_tpu_torch.obs.doctor [<obs-dir>] [--json]

The obs directory defaults to ``$TPU_OPERATOR_OBS_DIR``, then
``<workspace>/obs``. Exit status: 0 healthy-ish (info/warning only),
1 when any finding is critical, 2 usage errors — so CI and runbooks
can gate on it (docs/operations.md: "job is slow/stuck → run
tpu-doctor").

Standard library only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from dgl_operator_tpu_torch.obs import OBS_DIR_ENV
from dgl_operator_tpu_torch.obs._io import atomic_write
from dgl_operator_tpu_torch.obs.analyze import (DEFAULT_STALL_FACTOR,
                                          DEFAULT_STRAGGLER_RATIO,
                                          analyze_job, load_events)
from dgl_operator_tpu_torch.obs.collect import (EVENTS_JSONL, METRICS_JSON,
                                          job_dir_of, merge_job_view)
from dgl_operator_tpu_torch.obs.metrics import quantile_from_counts

REPORT_JSON = "report.json"
_SEV_MARK = {"critical": "[CRITICAL]", "warning": "[WARNING ]",
             "info": "[info    ]"}


def resolve_obs_dir(obs_dir: Optional[str],
                    workspace: Optional[str]) -> str:
    d = (obs_dir or os.environ.get(OBS_DIR_ENV)
         or (os.path.join(workspace, "obs") if workspace else None))
    if not d:
        raise SystemExit(2)
    return os.path.abspath(d)


def build_report(obs_dir: str,
                 straggler_ratio: float = DEFAULT_STRAGGLER_RATIO,
                 stall_factor: float = DEFAULT_STALL_FACTOR) -> Dict:
    """Ensure a job view exists (a plain obs dir becomes its own
    single-source view), analyze it, and persist ``job/report.json``."""
    job_dir = job_dir_of(obs_dir)
    if not os.path.exists(os.path.join(job_dir, EVENTS_JSONL)):
        merge_job_view(job_dir, sources=[("local", obs_dir)])
    report = analyze_job(obs_dir, straggler_ratio=straggler_ratio,
                         stall_factor=stall_factor)
    report["obs_dir"] = obs_dir
    slo = serve_slo(os.path.join(job_dir, METRICS_JSON))
    if slo:
        report["serve_slo"] = slo
    fleet = serve_fleet(os.path.join(job_dir, METRICS_JSON),
                        os.path.join(job_dir, EVENTS_JSONL))
    if fleet:
        report["serve_fleet"] = fleet
    ss = state_sharding(os.path.join(job_dir, METRICS_JSON))
    if ss:
        report["state_sharding"] = ss
    dp = dataplane(os.path.join(job_dir, METRICS_JSON))
    if dp:
        report["dataplane"] = dp
    tn = tuning(os.path.join(job_dir, METRICS_JSON))
    if tn:
        report["tuning"] = tn
    cm = comm(obs_dir)
    if cm:
        report["comm"] = cm
    fl = flight_incidents(obs_dir)
    if fl:
        report["flight"] = fl
    try:
        atomic_write(os.path.join(job_dir, REPORT_JSON),
                     json.dumps(report, indent=2, sort_keys=True))
        report["report_path"] = os.path.join(job_dir, REPORT_JSON)
    except OSError:
        report["report_path"] = None   # read-only view still renders
    return report


def serve_slo(metrics_json_path: str) -> Optional[Dict]:
    """Serving-plane SLO block from a finished run's merged metrics
    snapshot: request-latency quantiles (bucket-interpolated —
    ``obs.metrics.quantile_from_counts``, the estimator
    ``bench_serve`` cross-checks against exact samples), request/batch
    counts and padding occupancy. ``None`` when the run had no serving
    plane — training-only reports are unchanged."""
    try:
        with open(metrics_json_path) as f:
            merged = json.load(f).get("merged", {})
    except (OSError, ValueError):
        return None
    fam = merged.get("serve_request_seconds")
    if not fam or not fam.get("samples"):
        return None
    buckets = fam.get("buckets", [])
    counts = [0] * (len(buckets) + 1)
    for s in fam["samples"]:
        for i, c in enumerate(s.get("counts", [])):
            counts[i] += c
    out: Dict = {"requests": sum(counts)}
    for q, key in ((0.5, "p50_ms"), (0.95, "p95_ms"), (0.99, "p99_ms")):
        v = quantile_from_counts(buckets, counts, q)
        out[key] = round(v * 1e3, 3) if v is not None else None

    def _counter(name):
        f = merged.get(name, {})
        return sum(s.get("value", 0) for s in f.get("samples", []))

    out["batches"] = int(_counter("serve_batches_total"))
    occ = merged.get("serve_batch_occupancy", {})
    tot = sum(s.get("count", 0) for s in occ.get("samples", []))
    ssum = sum(s.get("sum", 0.0) for s in occ.get("samples", []))
    out["mean_batch_occupancy"] = (round(ssum / tot, 4) if tot else None)
    out["errors"] = int(_counter("serve_errors_total"))
    out["shed"] = int(_counter("serve_requests_shed_total"))
    out["slo_breaches"] = int(_counter("slo_breaches_total"))
    return out


def serve_fleet(metrics_json_path: str,
                events_path: Optional[str] = None) -> Optional[Dict]:
    """Serve-fleet block from a finished run's merged metrics (+ the
    job event ledger): replica fan-out counts, failover/drain/regrow
    tallies, and the canary-promotion history (``serve/router.py``,
    docs/serving.md). ``None`` when no router ran — single-replica and
    training-only reports are unchanged."""
    try:
        with open(metrics_json_path) as f:
            merged = json.load(f).get("merged", {})
    except (OSError, ValueError):
        return None
    fam = merged.get("fleet_requests_total")
    if not fam or not fam.get("samples"):
        return None

    def _counter(name, label=None):
        f = merged.get(name, {})
        return sum(s.get("value", 0) for s in f.get("samples", [])
                   if label is None or s.get("labels", {}) == label)

    out: Dict = {
        "per_replica": {
            s.get("labels", {}).get("replica", "?"):
            int(s.get("value", 0))
            for s in fam["samples"]},
        "retries": int(_counter("fleet_retries_total")),
        "failovers": int(_counter("fleet_failovers_total")),
        "shed": int(_counter("fleet_shed_total")),
        "canary_mirrors": int(_counter("fleet_canary_mirrors_total")),
        "promoted": int(_counter("ckpt_promotions_total",
                                 {"result": "promoted"})),
        "rolled_back": int(_counter("ckpt_promotions_total",
                                    {"result": "rolled_back"})),
    }
    up = merged.get("fleet_replicas_up", {})
    vals = [s.get("value") for s in up.get("samples", [])
            if s.get("value") is not None]
    out["replicas_up"] = int(max(vals)) if vals else None
    # drain/regrow + canary verdict story from the event ledger
    if events_path:
        downs, regrows, verdicts = 0, 0, []
        for e in load_events(events_path):
            ev = e.get("event")
            if ev == "fleet_replica_down":
                downs += 1
            elif ev == "fleet_replica_regrow":
                regrows += 1
            elif ev == "fleet_canary_verdict":
                verdicts.append({
                    "verdict": e.get("verdict"),
                    "replica": e.get("replica"),
                    "divergence": e.get("divergence"),
                    "nonfinite": e.get("nonfinite")})
        out["replica_downs"] = downs
        out["replica_regrows"] = regrows
        out["canary_verdicts"] = verdicts
    return out


def state_sharding(metrics_json_path: str) -> Optional[Dict]:
    """State-sharding block from a finished run's merged metrics
    snapshot: per-role (dist trainer / kge trainer) replicated-vs-
    sharded per-slot MiB for params and optimizer state, plus the
    savings ratio — the gauges the trainers emit through
    ``parallel.shardrules.emit_state_gauges``. ``None`` when no
    trainer ran (launch-only obs dirs are unchanged)."""
    try:
        with open(metrics_json_path) as f:
            merged = json.load(f).get("merged", {})
    except (OSError, ValueError):
        return None
    fam = merged.get("train_state_mib_per_slot")
    if not fam or not fam.get("samples"):
        return None
    roles: Dict[str, Dict] = {}
    for s in fam["samples"]:
        lb = s.get("labels", {})
        roles.setdefault(lb.get("role", "?"), {}).setdefault(
            lb.get("kind", "?"), {})[lb.get("mode", "?")] = s["value"]
    ratios = {}
    for s in merged.get("train_state_savings_ratio",
                        {}).get("samples", []):
        ratios[s.get("labels", {}).get("role", "?")] = s["value"]
    return {"roles": roles, "savings_ratio": ratios}


def dataplane(metrics_json_path: str) -> Optional[Dict]:
    """Feature data-plane block from the merged metrics snapshot
    (docs/dataplane.md): per-role feature-store MiB/slot in the active
    storage dtype, the storage-dtype backing bytes, and cold-tier rows
    demand-paged since load — the gauges the trainers and the serve
    engine emit through ``graph.featstore.emit_dataplane_gauges``.
    ``None`` when no feature plane reported (launch-only obs dirs are
    unchanged)."""
    try:
        with open(metrics_json_path) as f:
            merged = json.load(f).get("merged", {})
    except (OSError, ValueError):
        return None
    fam = merged.get("data_feat_mib_per_slot")
    if not fam or not fam.get("samples"):
        return None
    roles: Dict[str, Dict] = {}
    for s in fam["samples"]:
        lb = s.get("labels", {})
        roles.setdefault(lb.get("role", "?"), {}).update(
            dtype=lb.get("dtype", "?"), mib_per_slot=s["value"])
    for s in merged.get("data_feat_backing_mib",
                        {}).get("samples", []):
        role = s.get("labels", {}).get("role", "?")
        roles.setdefault(role, {})["backing_mib"] = s["value"]
    for s in merged.get("data_feat_paged_rows",
                        {}).get("samples", []):
        role = s.get("labels", {}).get("role", "?")
        roles.setdefault(role, {})["paged_rows"] = int(s["value"])
    return {"roles": roles}


def tuning(metrics_json_path: str) -> Optional[Dict]:
    """Auto-tuning block from the merged metrics snapshot:
    which tuned-manifest knob overrides the trainers actually applied
    (``autotune_overrides_applied_total`` from
    ``autotune.knobs.apply_tuned``), how many search probes ran /
    ledger-skipped, the winning probe score, and whether a skew-aware
    placement rewrote the working hostfile. ``None`` when the run
    never touched the autotune plane — untuned reports are
    unchanged."""
    try:
        with open(metrics_json_path) as f:
            merged = json.load(f).get("merged", {})
    except (OSError, ValueError):
        return None
    knobs = []
    for s in merged.get("autotune_overrides_applied_total",
                        {}).get("samples", []):
        k = s.get("labels", {}).get("knob")
        if k:
            knobs.append(k)
    probes = {s.get("labels", {}).get("status", "?"):
              int(s.get("value", 0))
              for s in merged.get("autotune_probes_total",
                                  {}).get("samples", [])}

    def _first_value(name):
        samples = merged.get(name, {}).get("samples", [])
        return samples[0].get("value") if samples else None

    manifests = _first_value("autotune_manifest_loaded_total")
    placements = _first_value("autotune_placements_total")
    best = _first_value("autotune_best_score")
    if not (knobs or probes or manifests or placements
            or best is not None):
        return None
    return {"overrides_applied": sorted(knobs),
            "probes": probes,
            "best_score": best,
            "manifests_loaded": int(manifests or 0),
            "placements_applied": int(placements or 0)}


def comm(obs_dir: str) -> Optional[Dict]:
    """Communication-plane block: the pinned
    ``benchkeys.COMM_KEYS`` summary from the per-collective ledger
    metrics (``obs.comm.comm_summary``) — per-op achieved bytes /
    seconds / GB/s, the peak link-utilization gauge, and the run's
    exchange/compute overlap. ``None`` when the run emitted no comm
    metrics — pre-comm-plane obs dirs are unchanged."""
    from dgl_operator_tpu_torch.obs.comm import comm_summary
    try:
        return comm_summary(obs_dir)
    except (OSError, ValueError):
        return None


def flight_incidents(obs_dir: str) -> Optional[List[Dict]]:
    """Incident timeline from crash-safe flight-recorder dumps
    (``obs/flight.py``: ``flight-<pid>.json``, written on fault /
    SIGTERM / chaos kill): who dumped, why, and — the question an
    incident review always starts with — which collective was in
    flight when the process died. ``None`` when no process dumped."""
    from dgl_operator_tpu_torch.obs.flight import load_flights
    dumps = load_flights(obs_dir)
    if not dumps:
        return None
    out: List[Dict] = []
    for d in dumps:
        samples = d.get("samples") or []
        out.append({
            "host": d.get("host"), "pid": d.get("pid"),
            "role": d.get("role"), "reason": d.get("reason"),
            "ts": d.get("ts"), "inflight": d.get("inflight"),
            "last_comm": d.get("last_comm"),
            "samples": len(samples),
            "last_kinds": [s.get("kind") for s in samples[-5:]],
        })
    return out


def render(report: Dict) -> str:
    """The human-readable diagnosis."""
    s = report.get("summary", {})
    lines: List[str] = []
    lines.append("tpu-doctor" + (f" — run {report['run']}"
                                 if report.get("run") else ""))
    lines.append(f"  obs dir : {report.get('obs_dir', '?')}")
    lines.append(f"  events  : {s.get('events', 0)}  "
                 f"workers: {len(s.get('workers', []))}  "
                 f"epochs: {s.get('epochs', 0)}  "
                 f"last step: {s.get('last_step')}")
    if s.get("phases"):
        parts = ", ".join(
            f"{p.get('phase')}:{p.get('title') or '?'} "
            f"{p.get('seconds', 0):.1f}s" for p in s["phases"])
        lines.append(f"  phases  : {parts}")
    if s.get("phases_skipped"):
        lines.append("  skipped : " + ", ".join(
            str(p.get("phase")) for p in s["phases_skipped"])
            + " (ledger resume)")
    if s.get("faults_injected"):
        lines.append(f"  faults  : {len(s['faults_injected'])} injected "
                     "(chaos plan)")
    lines.append(f"  retries : {s.get('retries', 0)}"
                 + (f"  exhausted: {s['retry_exhausted']}"
                    if s.get("retry_exhausted") else ""))
    for r in s.get("resume_points", []):
        lines.append(f"  resume  : step {r.get('step')} "
                     f"by {r.get('worker')}")
    if s.get("lock_breaks"):
        lines.append(f"  locks   : {s['lock_breaks']} stale obs lock(s) "
                     "broken")
    skew = report.get("skew") or {}
    if skew:
        lines.append("  skew (slowest vs median per bucket):")
        for bucket, v in sorted(skew.items()):
            ratio = v.get("ratio")
            lines.append(
                f"    {bucket:<10} median {v['median_s']:.3f}s  "
                f"slowest {v['slowest_s']:.3f}s"
                + (f"  ({ratio}x, {v['slowest']})"
                   if ratio is not None else ""))
    pipe = report.get("pipeline")
    if pipe:
        # the starved-vs-saturated line: is the device
        # waiting on the input plane, or is the pipeline keeping ahead?
        lines.append(
            f"  pipeline: {pipe['verdict']} — stall "
            f"{pipe['stall_s']:.3f}s vs dispatch "
            f"{pipe['dispatch_s']:.3f}s"
            + (f", exchange {pipe['exchange_s']:.3f}s hidden off-thread"
               if pipe.get("exchange_s") else "")
            + ("  (sampler-starved: raise num_samplers/prefetch)"
               if pipe["verdict"] == "starved" else ""))
    hw = report.get("hardware")
    if hw:
        # how far from the hardware ceiling the run actually ran
        # (obs/prof.py): MFU, the binding roofline resource, the HBM
        # watermark vs the analytic budget, and the compile bill
        parts = []
        if hw.get("mfu") is not None:
            line = f"MFU {hw['mfu']:.4f}"
            if hw.get("roofline_bound"):
                frac = hw["roofline_fracs"].get(hw["roofline_bound"])
                line += (f" ({hw['roofline_bound']}-bound"
                         + (f" at {frac:.4f} of peak" if frac is not None
                            else "") + ")")
            parts.append(line)
        if hw.get("hbm_watermark_mib") is not None:
            line = f"HBM {hw['hbm_watermark_mib']:.1f} MiB watermark"
            if hw.get("hbm_predicted_mib") is not None:
                line += f" vs {hw['hbm_predicted_mib']:.1f} predicted"
            parts.append(line)
        if hw.get("jit_compiles"):
            parts.append(f"{hw['jit_compiles']} compile(s), "
                         f"{hw['jit_compile_seconds']:.1f}s")
        if parts:
            lines.append("  hardware: " + "; ".join(parts))
    el = report.get("elasticity")
    if el:
        # the elastic fault-domain story (docs/elasticity.md): who
        # died, how the mapping reshaped, and whether the checkpoint
        # hardening (fencing, checksum fallback) had to act
        parts = []
        if el.get("dead_hosts"):
            parts.append("dead: " + ", ".join(el["dead_hosts"]))
        if el.get("shrinks"):
            w = (f" (width {el['full_width']}→{el['width']})"
                 if el.get("width") is not None else "")
            parts.append(f"{el['shrinks']} shrink(s){w}")
        if el.get("regrows"):
            parts.append(f"{el['regrows']} regrow(s)")
        if el.get("last_epoch") is not None:
            parts.append(f"epoch {el['last_epoch']}")
        if el.get("fence_rejections"):
            parts.append(f"{el['fence_rejections']} zombie "
                         "publication(s) fenced")
        if el.get("ckpt_fallbacks"):
            parts.append(f"{el['ckpt_fallbacks']} ckpt fallback(s) "
                         "to last-known-good")
        lines.append("  elastic : " + ("; ".join(parts) or "active"))
    mh = report.get("model_health")
    if mh:
        # the model-health story (obs/quality.py): did the trajectory
        # itself go bad, and did the automated response handle it?
        parts = []
        if mh.get("faults"):
            descs = []
            for f in mh["faults"]:
                d = f"step {f.get('step')}"
                if f.get("partition") is not None:
                    d += f" part {f.get('partition')}"
                descs.append(d)
            parts.append(f"{len(mh['faults'])} numerics fault(s) "
                         f"({', '.join(descs)})")
        if mh.get("rollbacks"):
            parts.append(f"{mh['rollbacks']} rollback(s) to "
                         "last-known-good")
        if mh.get("divergences"):
            parts.append(f"{mh['divergences']} loss divergence(s)")
        if mh.get("grad_explosions"):
            parts.append(f"{mh['grad_explosions']} grad explosion(s)")
        if mh.get("plateaus"):
            parts.append(f"{mh['plateaus']} plateau(s)")
        if mh.get("last_loss") is not None:
            parts.append(f"loss {mh['last_loss']:.4f}")
        if mh.get("last_grad_norm") is not None:
            parts.append(f"grad norm {mh['last_grad_norm']:.4f}")
        lines.append("  model   : " + ("; ".join(parts) or "healthy"))
    ss = report.get("state_sharding")
    if ss:
        # replicated vs sharded per-slot state (docs/sharding.md): is
        # the ZeRO/rules lever actually engaged, and what did it buy?
        for role, kinds in sorted(ss.get("roles", {}).items()):
            parts = []
            for kind in ("params", "opt_state"):
                v = kinds.get(kind, {})
                if "sharded" in v and "replicated" in v:
                    parts.append(f"{kind} {v['sharded']:.3f} vs "
                                 f"{v['replicated']:.3f} MiB/slot")
            ratio = ss.get("savings_ratio", {}).get(role)
            lines.append(
                f"  state   : [{role}] " + ", ".join(parts)
                + (f" — {ratio:.2f}x of replicated"
                   if ratio is not None else ""))
    dp = report.get("dataplane")
    if dp:
        # the feature data-plane story (docs/dataplane.md): what dtype
        # the feature store runs in and what it costs per slot
        for role, v in sorted(dp.get("roles", {}).items()):
            parts = [f"{v.get('dtype', '?')} feats "
                     f"{v.get('mib_per_slot', 0):.3f} MiB/slot"]
            if v.get("backing_mib") is not None:
                parts.append(f"backing {v['backing_mib']:.3f} MiB")
            if v.get("paged_rows") is not None:
                parts.append(f"{v['paged_rows']} row(s) demand-paged")
            lines.append(f"  data    : [{role}] " + ", ".join(parts))
    tn = report.get("tuning")
    if tn:
        # the auto-tuning story (docs/autotune.md): what the run
        # trained with vs its hand-set defaults
        parts = []
        if tn.get("overrides_applied"):
            parts.append("overrides "
                         + ", ".join(tn["overrides_applied"]))
        if tn.get("probes"):
            ran = tn["probes"].get("run", 0)
            skp = tn["probes"].get("ledger_skip", 0)
            parts.append(f"{ran} probe(s)"
                         + (f" (+{skp} ledger-skipped)" if skp else ""))
        if tn.get("best_score") is not None:
            parts.append(f"best score {tn['best_score']:.1f}")
        if tn.get("placements_applied"):
            parts.append(f"{tn['placements_applied']} placement(s) "
                         "applied")
        lines.append("  tuning  : " + ("; ".join(parts) or "active"))
    slo = report.get("serve_slo")
    if slo:
        lines.append(
            f"  serving : {slo['requests']} requests in "
            f"{slo['batches']} batches"
            + (f", occupancy {slo['mean_batch_occupancy']}"
               if slo.get("mean_batch_occupancy") is not None else "")
            + (f", {slo['errors']} errors" if slo.get("errors") else "")
            + (f", {slo['shed']} shed" if slo.get("shed") else "")
            + (f", {slo['slo_breaches']} SLO breach(es)"
               if slo.get("slo_breaches") else ""))
        if slo.get("p50_ms") is not None:
            lines.append(
                f"    latency p50 {slo['p50_ms']}ms  "
                f"p95 {slo['p95_ms']}ms  p99 {slo['p99_ms']}ms "
                "(bucket-interpolated)")
    fleet = report.get("serve_fleet")
    if fleet:
        parts = [f"{len(fleet['per_replica'])} replica(s)"]
        if fleet.get("replicas_up") is not None:
            parts.append(f"{fleet['replicas_up']} up")
        if fleet.get("replica_downs"):
            parts.append(f"{fleet['replica_downs']} down event(s), "
                         f"{fleet.get('replica_regrows', 0)} regrown")
        if fleet.get("failovers"):
            parts.append(f"{fleet['failovers']} failover(s)")
        if fleet.get("retries"):
            parts.append(f"{fleet['retries']} retried forward(s)")
        if fleet.get("shed"):
            parts.append(f"{fleet['shed']} shed")
        lines.append("  fleet   : " + "; ".join(parts))
        if fleet.get("promoted") or fleet.get("rolled_back"):
            lines.append(
                f"    promotions: {fleet.get('promoted', 0)} "
                f"promoted, {fleet.get('rolled_back', 0)} rolled "
                f"back ({fleet.get('canary_mirrors', 0)} canary "
                "mirror(s))")
        for v in (fleet.get("canary_verdicts") or []):
            lines.append(
                f"    canary on {v.get('replica')}: "
                f"{v.get('verdict')} (divergence "
                f"{v.get('divergence')}, nonfinite "
                f"{v.get('nonfinite')})")
    cm = report.get("comm")
    if cm:
        # the network side of the roofline (docs/profiling.md): what
        # the collectives moved, how fast, and how close to the link
        lines.append(
            f"  comm    : {len(cm.get('comm_ops', []))} collective "
            f"kind(s), {cm['comm_bytes_total'] / 2**20:.2f} MiB in "
            f"{cm['comm_seconds']:.3f}s"
            + (f"; top {cm['top_op']} at {cm['top_op_gbps']:.3f} GB/s"
               if cm.get("top_op") else "")
            + (f"; link util {cm['axis_util_max']:.3f}"
               if cm.get("axis_util_max") is not None else "")
            + (f"; overlap {cm['overlap_ratio']}"
               if cm.get("overlap_ratio") is not None else ""))
        for name, v in sorted((cm.get("per_op") or {}).items(),
                              key=lambda kv: -kv[1]["bytes"]):
            lines.append(
                f"    {name}: {v['bytes'] / 2**20:.3f} MiB, "
                f"{v['seconds']:.3f}s, {v['gbps']:.3f} GB/s")
    xr = report.get("xray")
    if xr:
        # the step-anatomy verdict (obs/xray.py): who sets the step
        # time, what category of work they spend it on, and what
        # fixing it would buy
        from dgl_operator_tpu_torch.obs.xray import CATEGORIES
        lines.append(
            f"  xray    : {xr['steps']} step(s), mean critical-path "
            f"step {xr['step_wall_mean_s']:.4f}s; "
            + "  ".join(f"{c} {xr[f'critpath_frac_{c}']:.0%}"
                        for c in CATEGORIES))
        lines.append(
            f"    owner {xr['critical_owner']} "
            f"({xr['critical_owner_frac']:.0%} of steps); what-if: "
            f"comm free −{xr['whatif_comm_free_frac']:.0%}, stalls "
            f"removed −{xr['whatif_stall_free_frac']:.0%}, owner at "
            f"median −{xr['whatif_owner_at_median_frac']:.0%}")
        per = xr.get("periodicity") or {}
        if per.get("every"):
            lines.append(
                f"    periodic spike every {per['every']} step(s)"
                + (f" aligned with {per['aligned_with']}"
                   if per.get("aligned_with") else ""))
    fl = report.get("flight")
    if fl:
        # the incident timeline (obs/flight.py): each dead process's
        # last seconds, leading with the collective left in flight
        lines.append(f"  flight  : {len(fl)} recorder dump(s)")
        for d in fl:
            who = (f"{d.get('host', '?')}:{d.get('pid', '?')}:"
                   f"{d.get('role', '?')}")
            infl = d.get("inflight") or {}
            last = d.get("last_comm") or {}
            if infl:
                what = (f"in flight: {infl.get('op')}@"
                        f"{infl.get('axis')} (program "
                        f"{infl.get('program')}, step "
                        f"{infl.get('step')})")
            elif last:
                what = (f"last comm: {last.get('op')}@"
                        f"{last.get('axis')} (program "
                        f"{last.get('program')}, step "
                        f"{last.get('step')}; window closed)")
            else:
                what = "no collective in flight"
            lines.append(
                f"    {d.get('reason', '?')} on {who} — {what}"
                + f"; {d.get('samples', 0)} sample(s) in window")
    findings = report.get("findings", [])
    if findings:
        lines.append(f"findings ({len(findings)}):")
        for f in findings:
            lines.append(f"  {_SEV_MARK.get(f['severity'], '[?]')} "
                         f"{f['kind']}: {f['message']}")
    else:
        lines.append("findings: none — job looks healthy")
    if report.get("report_path"):
        lines.append(f"report  : {report['report_path']}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-doctor",
        description="Diagnose a TPUGraphJob run from its obs/ "
                    "telemetry: merged timeline, skew/straggler "
                    "analytics, stall and lost-host findings.")
    ap.add_argument("obs_dir", nargs="?", default=None,
                    help="obs directory (default: $TPU_OPERATOR_OBS_DIR"
                         ", else <workspace>/obs)")
    ap.add_argument("--workspace", default=None,
                    help="workspace whose obs/ subdir to diagnose")
    ap.add_argument("--json", action="store_true",
                    help="print report.json to stdout instead of text")
    ap.add_argument("--straggler-ratio", type=float,
                    default=DEFAULT_STRAGGLER_RATIO)
    ap.add_argument("--stall-factor", type=float,
                    default=DEFAULT_STALL_FACTOR)
    args = ap.parse_args(argv)
    try:
        obs_dir = resolve_obs_dir(args.obs_dir, args.workspace)
    except SystemExit:
        ap.error("no obs directory: pass one, set "
                 f"{OBS_DIR_ENV}, or use --workspace")
    if not os.path.isdir(obs_dir):
        print(f"tpu-doctor: no such obs directory: {obs_dir}",
              file=sys.stderr)
        return 2
    report = build_report(obs_dir,
                          straggler_ratio=args.straggler_ratio,
                          stall_factor=args.stall_factor)
    if args.json:
        # EXACTLY the persisted job/report.json payload (flag parity
        # with tpu-lint --json / tpu-top --json): report_path is where
        # the file landed, not part of the file — scrapers piping
        # stdout and readers of the artifact must see one schema
        # (pinned in tests/test_quality.py)
        print(json.dumps({k: v for k, v in report.items()
                          if k != "report_path"},
                         indent=2, sort_keys=True))
    else:
        print(render(report))
    critical = any(f["severity"] == "critical"
                   for f in report.get("findings", []))
    return 1 if critical else 0


if __name__ == "__main__":
    raise SystemExit(main())
