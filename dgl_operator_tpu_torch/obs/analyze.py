"""Job-level analytics over the merged obs view: skew, stragglers,
stalls, lost workers, and a live health snapshot.

Systems work on data-parallel training (GSPMD; Automatic Cross-Replica
Sharding, PAPERS.md) shows per-replica imbalance is the dominant
silent perf killer: the job is only as fast as its slowest host, and
nothing in a phase-flip view surfaces WHICH host that is. These
analytics read what the runtime already records — the folded
PhaseTimer buckets (``train_phase_seconds{phase=...}`` per process)
and the per-step ``heartbeat`` events — and answer it:

- :func:`skew_summary` — slowest-vs-median per timing bucket
  (compute/``dispatch``, ``sample``, the owner-layout ``exchange``);
- :func:`analyze_job` — findings with severities: stragglers (worker
  persistently > k × median), stalls (heartbeats stop mid-run), lost
  workers (events end early, no terminal record), injected faults,
  preemptions and resume points;
- :func:`job_health` — a LIVE snapshot from the run's own
  ``events.jsonl`` (no collection needed): per-worker ok / done /
  stalled, consumed by ``Controller.reconcile_until`` so a stalled —
  not just dead — job restarts instead of hanging until deadline.

Worker identity is the obs proc id (``host:pid:role``); the launcher
stamps trainers with a per-rank role (``trainer-<rank>``), so a killed
trainer and its resumed successor are distinct workers sharing a role.

Standard library only.
"""

from __future__ import annotations

import json
import os
import statistics
import time
from typing import Dict, List, Optional

from dgl_operator_tpu_torch.obs._io import read_json
from dgl_operator_tpu_torch.obs.collect import EVENTS_JSONL, METRICS_JSON, \
    job_dir_of

# findings severity order (reports sort most-severe first)
SEVERITIES = ("critical", "warning", "info")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}

DEFAULT_STRAGGLER_RATIO = 1.5   # slowest > k * median => straggler
DEFAULT_STALL_FACTOR = 5.0      # silent for > N * median step time
DEFAULT_STALL_GRACE_S = 1.0     # floor under the stall window
DEFAULT_HBM_DRIFT_FRAC = 0.20   # measured > (1 + f) * predicted HBM

# events that prove a worker is making progress
_LIVENESS_EVENTS = ("heartbeat", "train_step", "epoch", "epoch_summary",
                    "eval", "train_resume", "ckpt_save")
# events that END a worker's story cleanly (silence afterwards is fine)
_TERMINAL_EVENTS = ("train_done", "preempted")


def worker_id(rec: Dict) -> str:
    """The obs proc id of an event's emitter."""
    return (f"{rec.get('host', '?')}:{rec.get('pid', '?')}:"
            f"{rec.get('role', '?')}")


def load_events(path: str) -> List[Dict]:
    """Tolerant JSONL read: skips torn/garbage lines (a killed writer
    may leave a partial tail)."""
    out: List[Dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


# ------------------------------------------------------------- skew
def skew_summary(series: Dict[str, Dict[str, float]]) -> Dict[str, Dict]:
    """Per-bucket imbalance: ``series`` maps bucket -> {subject ->
    seconds} (subjects are workers for job skew, steps for the bench's
    per-step skew). Returns per bucket the median, the slowest subject
    and the slowest/median ratio.

    Zero-median contract: a bucket whose median is
    0 (e.g. an all-zero bytes-only bucket, or a phase no worker spent
    time in) reports ``ratio: None`` — undefined, not ``inf``. Every
    downstream consumer (the straggler findings below, the doctor's
    skew lines, the autotune probe scorer) must guard before comparing
    a ratio; regression-pinned in tests/test_autotune.py with an
    all-zero bucket."""
    out: Dict[str, Dict] = {}
    for bucket in sorted(series):
        per = {k: float(v) for k, v in series[bucket].items()
               if v is not None}
        if not per:
            continue
        med = statistics.median(per.values())
        slowest = max(per, key=per.get)
        out[bucket] = {
            "n": len(per),
            "median_s": round(med, 6),
            "slowest": slowest,
            "slowest_s": round(per[slowest], 6),
            "ratio": (round(per[slowest] / med, 3) if med > 0 else None),
        }
    return out


def phase_seconds_by_worker(procs: Dict[str, dict],
                            family: str = "train_phase_seconds"
                            ) -> Dict[str, Dict[str, float]]:
    """bucket -> worker -> accumulated seconds, from each process's
    folded PhaseTimer histogram (the ``sum`` of its per-epoch
    observations)."""
    series: Dict[str, Dict[str, float]] = {}
    for proc_id, snap in procs.items():
        fam = (snap or {}).get(family)
        if not isinstance(fam, dict):
            continue
        for s in fam.get("samples", []):
            bucket = s.get("labels", {}).get("phase")
            if bucket is None:
                continue
            series.setdefault(bucket, {})[proc_id] = \
                float(s.get("sum", 0.0))
    return series


def comm_slot_seconds_by_slot(procs: Dict[str, dict]
                              ) -> Dict[str, Dict[str, float]]:
    """``op@axis`` -> mesh slot -> accumulated readiness-lag seconds,
    from the comm watcher's per-slot skew counter (obs/comm.py
    ``comm_slot_seconds``) — the collective-granularity straggler
    series: subjects are mesh SLOTS, not workers, so a slow link or
    chip shows up even when every host process looks healthy."""
    series: Dict[str, Dict[str, float]] = {}
    for snap in procs.values():
        fam = (snap or {}).get("comm_slot_seconds")
        if not isinstance(fam, dict):
            continue
        for s in fam.get("samples", []):
            lb = s.get("labels", {})
            op, axis, slot = lb.get("op"), lb.get("axis"), \
                lb.get("slot")
            if op is None or slot is None:
                continue
            bucket = f"{op}@{axis}"
            series.setdefault(bucket, {})
            series[bucket][f"slot {slot}"] = \
                series[bucket].get(f"slot {slot}", 0.0) \
                + float(s.get("value", 0.0))
    return series


DEFAULT_STARVED_FRAC = 0.25     # stall > 25% of loop-thread time


def pipeline_summary(procs: Dict[str, dict],
                     starved_frac: float = DEFAULT_STARVED_FRAC
                     ) -> Optional[Dict]:
    """Input-pipeline starvation verdict from the folded PhaseTimer
    buckets: ``stall`` is loop-thread time blocked waiting on
    a pipeline stage (sampler futures, staged halo exchanges) —
    sampler-starved time, not staging work. The verdict compares it to
    the loop thread's total accounted time (``stall + sample +
    dispatch``): **starved** means the device waited on the input plane
    (raise ``num_samplers`` / ``prefetch``); **saturated** means the
    pipeline kept ahead of compute. ``exchange_s`` (the decoupled halo
    stage, measured off-thread) rides along for context. ``None`` when
    no training process recorded pipeline buckets."""
    series = phase_seconds_by_worker(procs)
    if "stall" not in series and "sample" not in series:
        return None
    stall = sum(series.get("stall", {}).values())
    sample = sum(series.get("sample", {}).values())
    dispatch = sum(series.get("dispatch", {}).values())
    exchange = sum(series.get("exchange", {}).values())
    busy = stall + sample + dispatch
    frac = stall / busy if busy > 0 else 0.0
    return {"stall_s": round(stall, 3), "sample_s": round(sample, 3),
            "dispatch_s": round(dispatch, 3),
            "exchange_s": round(exchange, 3),
            "stall_frac": round(frac, 4),
            "verdict": "starved" if frac > starved_frac
            else "saturated"}


def hardware_summary(procs: Dict[str, dict]) -> Optional[Dict]:
    """Hardware-utilization roll-up from the per-process snapshots
    (the gauges ``obs/prof.py`` emits every heartbeat window): the
    job-wide MFU (max across trainer processes — each scores its own
    devices against the same peak table), the binding roofline
    resource, the worst per-device HBM watermark vs the analytic
    prediction, and the compile bill. ``None`` when no process carried
    the profiler (pre-prof runs are unchanged)."""
    mfu = None
    fracs: Dict[str, float] = {}
    wm, wm_dev, pred = None, None, None
    compiles = 0
    compile_s = 0.0
    for snap in procs.values():
        snap = snap or {}
        for s in (snap.get("train_mfu") or {}).get("samples", []):
            v = float(s["value"])
            mfu = v if mfu is None else max(mfu, v)
        for s in (snap.get("train_roofline_frac") or {}).get(
                "samples", []):
            b = s.get("labels", {}).get("bound", "?")
            fracs[b] = max(fracs.get(b, 0.0), float(s["value"]))
        for s in (snap.get("train_hbm_watermark_mib") or {}).get(
                "samples", []):
            v = float(s["value"])
            if wm is None or v > wm:
                wm, wm_dev = v, s.get("labels", {}).get("device")
        for s in (snap.get("train_hbm_predicted_mib") or {}).get(
                "samples", []):
            v = float(s["value"])
            pred = v if pred is None else max(pred, v)
        for s in (snap.get("jit_compiles_total") or {}).get(
                "samples", []):
            compiles += int(s.get("value", 0))
        for s in (snap.get("jit_compile_seconds") or {}).get(
                "samples", []):
            compile_s += float(s.get("sum", 0.0))
    if mfu is None and wm is None and not compiles:
        return None
    bound = max(fracs, key=fracs.get) if fracs else None
    return {
        "mfu": mfu,
        "roofline_bound": bound,
        "roofline_fracs": {k: round(v, 6)
                           for k, v in sorted(fracs.items())},
        "hbm_watermark_mib": wm,
        "hbm_watermark_device": wm_dev,
        "hbm_predicted_mib": pred,
        "jit_compiles": compiles,
        "jit_compile_seconds": round(compile_s, 3),
    }


# -------------------------------------------------------------- report
def _finding(kind: str, severity: str, subject: str, message: str,
             **evidence) -> Dict:
    assert severity in _SEV_RANK, severity
    return {"kind": kind, "severity": severity, "subject": subject,
            "message": message, "evidence": evidence}


def _liveness(events: List[Dict]) -> Dict[str, Dict]:
    """Per-worker liveness ledger: heartbeat timestamps/steps, last
    event of any kind, and the terminal event (if one ended the
    worker's story)."""
    workers: Dict[str, Dict] = {}
    for e in events:
        w = worker_id(e)
        rec = workers.setdefault(w, {"hb_ts": [], "steps": [],
                                     "last_ts": 0.0, "first_ts": None,
                                     "terminal": None, "dead": None,
                                     "numerics": None,
                                     "n_events": 0})
        ts = float(e.get("ts") or 0.0)
        rec["n_events"] += 1
        rec["last_ts"] = max(rec["last_ts"], ts)
        if rec["first_ts"] is None:
            rec["first_ts"] = ts
        if e.get("event") in _LIVENESS_EVENTS:
            rec["hb_ts"].append(ts)
            if isinstance(e.get("step"), (int, float)):
                rec["steps"].append(int(e["step"]))
        if e.get("event") in _TERMINAL_EVENTS:
            rec["terminal"] = {"event": e["event"],
                               "step": e.get("step"), "ts": ts}
        if e.get("event") == "numerics_fault" \
                and e.get("action") != "warn":
            # the sentry halted this worker on non-finite state
            # (action warn keeps training and must not read unhealthy)
            rec["numerics"] = {"step": e.get("step"),
                               "partition": e.get("partition"),
                               "kind": e.get("kind"), "ts": ts}
        if e.get("event") == "host_died":
            # permanent loss (chaos host:die / elastic detection):
            # host_name is the LOGICAL hostfile host — on a shared-fs
            # fabric every process reports the same real hostname, so
            # the event must carry the identity elasticity plans with
            rec["dead"] = {"step": e.get("step"), "ts": ts,
                           "host_name": e.get("host_name")}
    return workers


def _median_interval(ts: List[float], floor: float) -> float:
    if len(ts) < 2:
        return floor
    ts = sorted(ts)
    gaps = [b - a for a, b in zip(ts, ts[1:])]
    return max(statistics.median(gaps), 1e-6)


def analyze_job(obs_dir: Optional[str] = None, *,
                events: Optional[List[Dict]] = None,
                procs: Optional[Dict[str, dict]] = None,
                straggler_ratio: float = DEFAULT_STRAGGLER_RATIO,
                stall_factor: float = DEFAULT_STALL_FACTOR,
                stall_grace_s: float = DEFAULT_STALL_GRACE_S) -> Dict:
    """Analyze a job's merged telemetry into a structured report:
    ``{"run", "summary", "skew", "findings"}``. Reads the ``obs/job/``
    view when ``obs_dir`` is given (falling back to the plain obs dir
    for single-host runs); pass ``events``/``procs`` directly in
    tests."""
    if obs_dir is not None:
        jd = job_dir_of(obs_dir)
        epath = os.path.join(jd, EVENTS_JSONL)
        if not os.path.exists(epath):
            jd = obs_dir
            epath = os.path.join(jd, EVENTS_JSONL)
        if events is None:
            events = load_events(epath)
        if procs is None:
            procs = read_json(os.path.join(jd, METRICS_JSON),
                              {}).get("procs") or {}
    events = events or []
    procs = procs or {}

    findings: List[Dict] = []
    run_id = next((e.get("run") for e in events if e.get("run")), None)
    end_ts = max((float(e.get("ts") or 0.0) for e in events),
                 default=0.0)

    # ---- summary ----------------------------------------------------
    by_kind: Dict[str, List[Dict]] = {}
    for e in events:
        by_kind.setdefault(str(e.get("event")), []).append(e)

    phases = []
    titles = {e.get("phase"): e.get("title")
              for e in by_kind.get("phase_start", [])}
    for e in by_kind.get("phase_finish", []):
        phases.append({"phase": e.get("phase"),
                       "title": titles.get(e.get("phase")),
                       "seconds": e.get("seconds")})
    skipped = [{"phase": e.get("phase"), "title": e.get("title")}
               for e in by_kind.get("phase_skip", [])]

    faults = []
    for e in by_kind.get("chaos_fault", []):
        faults.append({"verb": e.get("verb"), "action": e.get("action"),
                       "host": e.get("host"), "rule": e.get("rule")})
    for e in by_kind.get("chaos_train_kill", []):
        faults.append({"verb": "train", "action": "kill",
                       "step": e.get("step"), "worker": worker_id(e)})

    preemptions = [{"worker": worker_id(e), "step": e.get("step")}
                   for e in by_kind.get("preempted", [])]
    resumes = [{"worker": worker_id(e), "step": e.get("step")}
               for e in by_kind.get("train_resume", [])]

    live = _liveness(events)
    workers = sorted(w for w, rec in live.items() if rec["hb_ts"])
    steps = [s for rec in live.values() for s in rec["steps"]]

    summary = {
        "events": len(events),
        "workers": workers,
        "phases": phases,
        "phases_skipped": skipped,
        "faults_injected": faults,
        "retries": len(by_kind.get("fabric_retry", [])),
        "retry_exhausted": len(by_kind.get("fabric_retry_exhausted",
                                           [])),
        "preemptions": preemptions,
        "resume_points": resumes,
        "epochs": len(by_kind.get("epoch", [])),
        "last_step": max(steps) if steps else None,
        "lock_breaks": len(by_kind.get("obs_lock_broken", [])),
        "slo_breaches": len(by_kind.get("slo_breach", [])),
        "failure_collections": len(by_kind.get("obs_collect_on_failure",
                                               [])),
        "jit_compiles": len(by_kind.get("jit_compile", [])),
        "host_deaths": len(by_kind.get("host_died", [])),
        "elastic_shrinks": len(by_kind.get("elastic_shrink", [])),
        "elastic_regrows": len(by_kind.get("elastic_regrow", [])),
        "ckpt_fallbacks": len(by_kind.get("ckpt_restore_fallback", [])),
        "fence_rejections": len(by_kind.get("ckpt_fence_rejected", [])),
        "numerics_faults": len(by_kind.get("numerics_fault", [])),
        "numerics_rollbacks": len(by_kind.get("numerics_rollback", [])),
    }

    # ---- elasticity roll-up -----------------------------------------
    shrinks = by_kind.get("elastic_shrink", [])
    regrows = by_kind.get("elastic_regrow", [])
    deaths = [{"worker": worker_id(e), "host": e.get("host_name"),
               "step": e.get("step"),
               "ts": float(e.get("ts") or 0.0)}
              for e in by_kind.get("host_died", [])]
    elasticity = None
    if deaths or shrinks or regrows or summary["ckpt_fallbacks"] \
            or summary["fence_rejections"]:
        epochs = [e.get("epoch") for e in shrinks + regrows
                  if isinstance(e.get("epoch"), int)]
        elasticity = {
            "host_deaths": [{k: v for k, v in d.items() if k != "ts"}
                            for d in deaths],
            "dead_hosts": sorted({d["host"] for d in deaths
                                  if d["host"]}),
            "shrinks": len(shrinks),
            "regrows": len(regrows),
            "width": (shrinks[-1].get("width") if shrinks else None),
            "full_width": (shrinks[-1].get("full_width")
                           if shrinks else None),
            "last_epoch": (max(epochs) if epochs else None),
            "fence_rejections": summary["fence_rejections"],
            "ckpt_fallbacks": summary["ckpt_fallbacks"],
        }

    # ---- model health (obs/quality.py) ------------------------------
    from dgl_operator_tpu_torch.obs.quality import model_health_summary
    model_health = model_health_summary(events, procs)

    # recovery signal for the numerics findings: a rollback relaunch
    # or a resumed trainer at/after the fault means the automated
    # response handled it — warning, not an open critical
    recovery_ts = [float(e.get("ts") or 0.0)
                   for e in (by_kind.get("numerics_rollback", [])
                             + by_kind.get("train_resume", []))]
    for e in by_kind.get("numerics_fault", []):
        ts = float(e.get("ts") or 0.0)
        recovered = any(r >= ts for r in recovery_ts)
        sev = ("warning" if recovered or e.get("action") == "warn"
               else "critical")
        part = e.get("partition")
        msg = (f"non-finite training state ({e.get('kind')}) at step "
               f"{e.get('step')}"
               + (f" on partition {part}" if part is not None else ""))
        if recovered:
            msg += ("; rolled back to the last-known-good checkpoint "
                    "and resumed")
        elif e.get("action") == "warn":
            msg += ("; quality_action=warn — training continued on "
                    "bad state (inspect the trajectory)")
        else:
            msg += ("; trainer halted — relaunch with tpurun "
                    "--numerics-retries or inspect the quarantined "
                    "checkpoints")
        findings.append(_finding(
            "numerics_fault", sev, worker_id(e), msg,
            step=e.get("step"), partition=part,
            fault_kind=e.get("kind"), recovered=recovered))
    for kind, label in (("loss_divergence", "loss diverged"),
                        ("grad_explosion", "gradient norm exploded")):
        evs = by_kind.get(kind, [])
        if not evs:
            continue
        last = evs[-1]
        detail = (f"z={last.get('z')} (max {last.get('z_max')})"
                  if kind == "loss_divergence" else
                  f"{last.get('ratio')}x the rolling median "
                  f"(max {last.get('ratio_max')}x)")
        findings.append(_finding(
            kind, "warning", worker_id(last),
            f"{label} at step {last.get('step')}: {detail}"
            + (f" — {len(evs)} detection(s)" if len(evs) > 1 else ""),
            step=last.get("step"), count=len(evs)))
    for e in by_kind.get("loss_plateau", []):
        findings.append(_finding(
            "loss_plateau", "info", worker_id(e),
            f"loss plateaued at step {e.get('step')} (range "
            f"{e.get('spread')} over {e.get('window')} steps)",
            step=e.get("step")))

    # ---- findings: faults / failures -------------------------------
    rule_counts: Dict[str, int] = {}
    for f in faults:
        key = f.get("rule") or f"train:kill:{f.get('step')}"
        rule_counts[key] = rule_counts.get(key, 0) + 1
    for f in faults:
        key = f.get("rule") or f"train:kill:{f.get('step')}"
        if key not in rule_counts:
            continue
        n = rule_counts.pop(key)
        subject = f.get("host") or f.get("worker") or "?"
        findings.append(_finding(
            "fault_injected", "info", subject,
            f"chaos plan delivered {key} on {subject}"
            + (f" ({n} times)" if n > 1 else ""),
            rule=key, count=n, step=f.get("step")))
    for e in by_kind.get("fabric_retry_exhausted", []):
        findings.append(_finding(
            "retry_exhausted", "critical", worker_id(e),
            f"fabric verb {e.get('verb')} ran out of retry attempts: "
            f"{str(e.get('error'))[:120]}",
            verb=e.get("verb"), attempts=e.get("attempts")))
    for e in by_kind.get("phase_error", []):
        # a phase error the elastic plane recovered (a shrink followed
        # it and the phase later finished) — or the model-health plane
        # rolled back (numerics_rollback, same contract) — is a
        # handled event, not an open incident; critical only when
        # nothing absorbed it
        ts = float(e.get("ts") or 0.0)
        reshaped = any(float(s.get("ts") or 0.0) >= ts
                       for s in shrinks)
        rolled_back = any(float(r.get("ts") or 0.0) >= ts
                          for r in by_kind.get("numerics_rollback",
                                               []))
        refinished = any(f.get("phase") == e.get("phase")
                         and float(f.get("ts") or 0.0) >= ts
                         for f in by_kind.get("phase_finish", []))
        handled = (reshaped or rolled_back) and refinished
        findings.append(_finding(
            "phase_failed", "warning" if handled else "critical",
            worker_id(e),
            f"workflow phase {e.get('phase')} raised"
            + ("; recovered by elastic shrink + relaunch"
               if handled and reshaped else
               "; recovered by numerics rollback + relaunch"
               if handled else ""),
            phase=e.get("phase"), recovered=handled))

    # ---- findings: preempted / lost / stalled workers --------------
    for p in preemptions:
        resumed = next((r for r in resumes
                        if r["step"] is not None and p["step"] is not None
                        and r["step"] >= p["step"]), None)
        sev = "warning" if resumed else "critical"
        msg = (f"worker {p['worker']} lost to preemption/kill at step "
               f"{p['step']}")
        if resumed:
            msg += (f"; resumed at step {resumed['step']} by "
                    f"{resumed['worker']}")
        findings.append(_finding("worker_lost", sev, p["worker"], msg,
                                 step=p["step"],
                                 resumed_step=(resumed or {}).get("step"),
                                 resumed_by=(resumed or {}).get("worker")))
    # ---- findings: dead hosts / elastic edges ----------------------
    for d in deaths:
        reshaped = any(float(s.get("ts") or 0.0) >= d["ts"]
                       for s in shrinks)
        sev = "warning" if reshaped else "critical"
        msg = (f"host {d['host'] or '?'} died permanently at step "
               f"{d['step']} (worker {d['worker']})")
        if reshaped:
            msg += ("; elastic shrink re-placed its partitions over "
                    "the surviving hosts")
        else:
            msg += ("; no elastic shrink followed — the job cannot "
                    "finish without re-placement (run the driver "
                    "with --elastic, docs/elasticity.md)")
        findings.append(_finding(
            "host_died", sev, d["worker"], msg, step=d["step"],
            host=d["host"], reshaped=reshaped))
    if summary["ckpt_fallbacks"]:
        last = by_kind["ckpt_restore_fallback"][-1]
        findings.append(_finding(
            "ckpt_fallback", "warning", worker_id(last),
            f"{summary['ckpt_fallbacks']} checkpoint restore(s) "
            "skipped a corrupt/partial archive and fell back to the "
            f"last-known-good (latest: step {last.get('step')}, "
            f"{str(last.get('error'))[:120]})",
            count=summary["ckpt_fallbacks"], step=last.get("step")))
    if summary["fence_rejections"]:
        last = by_kind["ckpt_fence_rejected"][-1]
        findings.append(_finding(
            "ckpt_fence_rejected", "info", worker_id(last),
            f"{summary['fence_rejections']} zombie checkpoint "
            "publication(s) rejected by the fencing token (epoch "
            f"{last.get('epoch')} vs current "
            f"{last.get('current_epoch')}) — newer state survived, "
            "the fence doing its job",
            count=summary["fence_rejections"]))

    preempted_ids = {p["worker"] for p in preemptions}
    dead_ids = {d["worker"] for d in deaths}
    # a numerics-halted worker ends its story at the fault — the
    # numerics_fault finding owns that verdict; a stalled finding on
    # top would double-report the same incident
    numerics_ids = {worker_id(e)
                    for e in by_kind.get("numerics_fault", [])
                    if e.get("action") != "warn"}
    for w in workers:
        rec = live[w]
        if rec["terminal"] is not None or w in preempted_ids \
                or w in dead_ids or w in numerics_ids:
            continue
        med = _median_interval(rec["hb_ts"], stall_grace_s)
        window = max(stall_factor * med, stall_grace_s)
        silent = end_ts - max(rec["hb_ts"])
        if silent > window:
            findings.append(_finding(
                "worker_stalled", "critical", w,
                f"worker {w} went silent {silent:.1f}s before the end "
                f"of the run (median step interval {med:.3f}s, no "
                "terminal event) — stalled or lost",
                silent_s=round(silent, 3),
                median_interval_s=round(med, 6),
                last_step=(max(rec["steps"]) if rec["steps"] else None)))

    # ---- findings: stragglers from the folded phase buckets --------
    skew = skew_summary(phase_seconds_by_worker(procs))
    for bucket, s in skew.items():
        # the explicit zero-median guard: ratio is None for all-zero
        # buckets and must never be compared (skew_summary contract)
        if s["n"] >= 2 and s["ratio"] is not None and \
                s["ratio"] > straggler_ratio:
            findings.append(_finding(
                "straggler", "warning", s["slowest"],
                f"worker {s['slowest']} spent {s['slowest_s']:.3f}s in "
                f"'{bucket}' vs a median of {s['median_s']:.3f}s "
                f"({s['ratio']}x; threshold {straggler_ratio}x)",
                bucket=bucket, ratio=s["ratio"],
                median_s=s["median_s"], slowest_s=s["slowest_s"]))

    # ---- findings: per-collective stragglers (comm watcher skew) ----
    # same skew machinery, finer grain: subjects are mesh slots and
    # buckets are op@axis from the comm ledger, so the finding names
    # the collective in flight ("slot 3 is 2.1x median on
    # halo_a2a_serve@dp") instead of blaming a whole phase
    comm_skew = skew_summary(comm_slot_seconds_by_slot(procs))
    for bucket, s in comm_skew.items():
        if s["n"] >= 2 and s["ratio"] is not None and \
                s["ratio"] > straggler_ratio:
            findings.append(_finding(
                "comm_straggler", "warning", s["slowest"],
                f"{s['slowest']} is {s['ratio']}x median on {bucket} "
                f"({s['slowest_s']:.3f}s vs {s['median_s']:.3f}s; "
                f"threshold {straggler_ratio}x)",
                bucket=bucket, ratio=s["ratio"],
                median_s=s["median_s"], slowest_s=s["slowest_s"]))

    # ---- findings: SLO breaches (live monitor, obs/slo.py) ----------
    # one finding per target: the latest breach's numbers plus the
    # breach count — a recovered breach still warrants a look
    slo_by_target: Dict[str, List[Dict]] = {}
    for e in by_kind.get("slo_breach", []):
        slo_by_target.setdefault(str(e.get("target")), []).append(e)
    for target, evs in sorted(slo_by_target.items()):
        last = evs[-1]
        recovered = any(r.get("target") == target
                        for r in by_kind.get("slo_recovered", []))
        shed = bool(by_kind.get("serve_shed_start"))
        findings.append(_finding(
            "slo_breach", "warning", worker_id(last),
            f"SLO target {target} breached "
            f"({last.get('value')} vs threshold "
            f"{last.get('threshold')}, burn {last.get('burn_rate')})"
            + (f" {len(evs)} time(s)" if len(evs) > 1 else "")
            + ("; load shedding engaged" if shed else "")
            + ("; recovered" if recovered else ""),
            target=target, count=len(evs), value=last.get("value"),
            threshold=last.get("threshold"),
            burn_rate=last.get("burn_rate"), recovered=recovered))

    # ---- findings: recompilation in steady state --------------------
    # the silent 10x killer the padding invariant exists to prevent
    # (runtime/loop.py pad contract; obs/prof.py instrument_jit marks
    # every compile past a function's warmup calls `steady=True`) —
    # now enforced with data: any steady compile is critical
    steady_by_fn: Dict[str, List[Dict]] = {}
    for e in by_kind.get("jit_compile", []):
        if e.get("steady"):
            steady_by_fn.setdefault(str(e.get("fn")), []).append(e)
    for fn, evs in sorted(steady_by_fn.items()):
        last = evs[-1]
        secs = sum(float(e.get("seconds") or 0.0) for e in evs)
        findings.append(_finding(
            "steady_state_recompile", "critical", worker_id(last),
            f"jitted function '{fn}' recompiled {len(evs)} time(s) "
            f"after warmup ({secs:.2f}s of compile stall) — a shape "
            "is churning past the static-padding contract "
            "(runtime/loop.py); every distinct shape costs a full "
            "XLA compile mid-training",
            fn=fn, count=len(evs), compile_seconds=round(secs, 3),
            last_call=last.get("call")))

    # ---- findings: measured vs predicted HBM drift ------------------
    hw = hardware_summary(procs)
    if hw is not None:
        pred = hw.get("hbm_predicted_mib")
        meas = hw.get("hbm_watermark_mib")
        if pred and meas and meas > pred * (1.0 + DEFAULT_HBM_DRIFT_FRAC):
            findings.append(_finding(
                "hbm_drift", "warning", hw.get("hbm_watermark_device",
                                               "job"),
                f"measured HBM watermark {meas:.1f} MiB exceeds the "
                f"analytic hbm_budget model's {pred:.1f} MiB by "
                f"{meas / pred - 1.0:.0%} (> "
                f"{DEFAULT_HBM_DRIFT_FRAC:.0%} tolerance) — the "
                "budget model is missing a resident buffer (staging "
                "depth? cache? donation regression)",
                watermark_mib=meas, predicted_mib=pred,
                drift_frac=round(meas / pred - 1.0, 4)))

    # ---- findings: input-pipeline starvation ------------------------
    pipeline = pipeline_summary(procs)
    if pipeline is not None and pipeline["verdict"] == "starved":
        findings.append(_finding(
            "pipeline_starved", "info", "job",
            f"input pipeline starved: {pipeline['stall_s']}s blocked "
            f"on sampler/exchange stages vs {pipeline['dispatch_s']}s "
            f"dispatching ({pipeline['stall_frac']:.0%} of loop time) "
            "— raise num_samplers or prefetch",
            **{k: v for k, v in pipeline.items() if k != "verdict"}))

    # ---- findings: step anatomy (obs/xray.py) -----------------------
    # the critical-path view answers what the phase-bucket straggler
    # finding cannot: not just "who is slow" but what owning the
    # critical path COSTS — and whether the spikes are periodic
    xray = None
    if obs_dir is not None:
        from dgl_operator_tpu_torch.obs.xray import xray_summary
        try:
            xray = xray_summary(obs_dir)
        except (OSError, ValueError):
            xray = None
    if xray:
        if len(workers) >= 2 and xray["critical_owner_frac"] > 0.6 \
                and xray["whatif_owner_at_median_frac"] >= 0.05:
            findings.append(_finding(
                "xray_straggler", "warning", xray["critical_owner"],
                f"worker {xray['critical_owner']} owns "
                f"{xray['critical_owner_frac']:.0%} of the critical "
                f"path; at the median per-step rate the job would run "
                f"{xray['whatif_owner_at_median_frac']:.0%} faster "
                "(tpu-xray)",
                owner_frac=xray["critical_owner_frac"],
                whatif_frac=xray["whatif_owner_at_median_frac"]))
        if xray["critpath_frac_stall"] >= 0.10:
            findings.append(_finding(
                "xray_stall", "warning", xray["critical_owner"],
                f"{xray['critpath_frac_stall']:.0%} of the critical "
                "path is stall time; removing it would cut step time "
                f"{xray['whatif_stall_free_frac']:.0%} (tpu-xray)",
                stall_frac=xray["critpath_frac_stall"],
                whatif_frac=xray["whatif_stall_free_frac"]))
        per = xray.get("periodicity") or {}
        if per.get("every"):
            findings.append(_finding(
                "xray_periodic_stall", "info", "job",
                f"critical-path step time spikes every "
                f"{per['every']} steps"
                + (f", aligned with {per['aligned_with']} spans"
                   if per.get("aligned_with") else "")
                + " (tpu-xray)",
                every=per["every"], spikes=len(per.get("spike_steps",
                                                       [])),
                aligned_with=per.get("aligned_with")))

    findings.sort(key=lambda f: (_SEV_RANK[f["severity"]], f["kind"],
                                 f["subject"]))
    return {"run": run_id, "summary": summary, "skew": skew,
            "pipeline": pipeline, "hardware": hw,
            "elasticity": elasticity, "model_health": model_health,
            "xray": xray, "findings": findings}


# -------------------------------------------------------------- health
def job_health(obs_dir: str, now: Optional[float] = None,
               stall_factor: float = DEFAULT_STALL_FACTOR,
               stall_grace_s: float = DEFAULT_STALL_GRACE_S) -> Dict:
    """LIVE job health from the run's own ``events.jsonl`` (append-only
    — readable mid-run with no collection): per-worker status ``ok`` /
    ``done`` / ``stalled`` derived from the per-step heartbeats. A
    worker is stalled when it has been silent for more than
    ``stall_factor`` × its median heartbeat interval (floored at
    ``stall_grace_s``) and no terminal event ended its story.
    ``healthy`` is False iff any worker is stalled — the signal
    ``Controller.reconcile_until`` turns into a restart."""
    now = time.time() if now is None else now
    events = load_events(os.path.join(obs_dir, EVENTS_JSONL))
    live = _liveness(events)
    # a numerics fault the rollback plane already handled (a rollback
    # relaunch or a resumed trainer at/after the fault) ended that
    # worker's story — its successor carries the job
    recovery_ts = [float(e.get("ts") or 0.0) for e in events
                   if e.get("event") in ("numerics_rollback",
                                         "train_resume")]
    workers: Dict[str, Dict] = {}
    stalled: List[str] = []
    dead: List[str] = []
    dead_hosts: List[str] = []
    numerics: List[str] = []
    for w, rec in sorted(live.items()):
        if not rec["hb_ts"]:
            continue   # driver/controller processes have no heartbeat
        last = max(rec["hb_ts"])
        med = _median_interval(rec["hb_ts"], stall_grace_s)
        window = max(stall_factor * med, stall_grace_s)
        if rec["dead"] is not None:
            # a host_died worker is PERMANENTLY gone — not "stalled"
            # (which a restart might heal in place): the controller
            # restarts with reason HostDead and the elastic driver
            # re-places its partitions (docs/elasticity.md)
            status = "dead"
            dead.append(w)
            hn = rec["dead"].get("host_name")
            if hn and hn not in dead_hosts:
                dead_hosts.append(hn)
        elif rec["numerics"] is not None:
            # the numerics sentry halted this worker (obs/quality.py):
            # the controller restarts with reason NumericsFault unless
            # a rollback/resume already handled it
            handled = any(ts >= rec["numerics"]["ts"]
                          for ts in recovery_ts)
            status = "rolled_back" if handled else "numerics_fault"
            if not handled:
                numerics.append(w)
        elif rec["terminal"] is not None:
            status = "done"
        elif now - last > window:
            status = "stalled"
            stalled.append(w)
        else:
            status = "ok"
        workers[w] = {
            "status": status,
            "last_step": (max(rec["steps"]) if rec["steps"] else None),
            "last_heartbeat_ts": last,
            "silent_s": round(max(now - last, 0.0), 3),
            "stall_window_s": round(window, 3),
            "terminal": rec["terminal"],
            "dead": rec["dead"],
            "numerics": rec["numerics"],
        }
    # serving-fleet replica ledger (serve/router.py): a replica is
    # down when its last down/regrow event says so. Deliberately NOT
    # folded into `healthy` — the router already drained its traffic
    # to survivors, so the JOB is fine; the controller restarts the
    # replica with its own reason (ReplicaDead) instead
    rep_state: Dict[str, str] = {}
    for e in events:
        if e.get("event") == "fleet_replica_down":
            rep_state[str(e.get("replica"))] = "down"
        elif e.get("event") == "fleet_replica_regrow":
            rep_state[str(e.get("replica"))] = "up"
    replicas_down = sorted(n for n, s in rep_state.items()
                           if s == "down")
    return {"checked_ts": now, "workers": workers, "stalled": stalled,
            "dead": dead, "dead_hosts": sorted(dead_hosts),
            "numerics": numerics, "replicas_down": replicas_down,
            "healthy": not stalled and not dead and not numerics}
