"""``tpu-xray`` — distributed step anatomy, critical path, and
what-if attribution from a job's merged telemetry.

The doctor answers "is this job sick"; the profiler answers "how far
from the roofline". Neither answers the question a slow-but-healthy
distributed run actually poses: **which host, doing what, sets the
step time — and what would fixing it buy?** The xray computes that
from artifacts every run already leaves behind:

- per-worker **step windows** from the ``heartbeat`` event stream
  (every trainer emits one per step; consecutive heartbeats fence the
  step's work — SampledTrainer emits no per-step spans, so windows
  must come from events, not the trace);
- per-worker **category time** from the merged ``job/trace.json``
  spans: ``train_compute`` → compute; the comm ledger's
  per-collective spans plus ``halo_exchange_fused`` /
  ``param_gather_fused`` → comm; chaos straggler spans
  (``chaos_step_slow``) → stall; checkpoint spans → ckpt. Attribution
  is **priority-layered and disjoint** (stall ⊃ compute ⊃ comm ⊃
  ckpt; the un-spanned remainder is ``other``), so per-step fractions
  sum to exactly 1.0 — no double-billing an overlapped collective;
- the **critical path**: per step, the worker with the longest
  window owns the step; job step time is the sum of owner walls, and
  ``critpath_frac{category}`` is each category's share of it;
- **what-if estimates** — re-running the per-step max with a category
  (or the dominant owner) removed: "comm free → step −18%",
  "slot 3 at median rate → epoch −11%";
- **periodicity** — every-K-step spikes in the owner wall, aligned
  against ``ckpt_save`` / canary-promotion events.

Timestamps: trace spans are epoch-anchored µs (obs/trace.py), events
epoch seconds — one clock after the collector's skew alignment
(obs/collect.py applies the per-source offsets to BOTH streams), so
windows and spans compare directly.

Standard library only: the doctor imports this. The interval helpers
are local on purpose (``runtime.timers`` has the same math but imports
torch). :func:`live_critpath`, the live feed's single-worker estimate,
lives here too (``obs/live.py`` imports it).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from dgl_operator_tpu_torch.benchkeys import XRAY_KEYS
from dgl_operator_tpu_torch.obs import OBS_DIR_ENV
from dgl_operator_tpu_torch.obs.collect import EVENTS_JSONL, job_dir_of
from dgl_operator_tpu_torch.obs.trace import TRACE_JSON

# attribution categories, in render order; layering priority below
CATEGORIES = ("compute", "comm", "stall", "ckpt", "other")
# spans are credited in this order; a lower-priority category only
# gets intervals no higher-priority category covered (stall first:
# an injected straggler drag must never launder itself as compute)
_PRIORITY = ("stall", "compute", "comm", "ckpt")

_COMM_SPAN_NAMES = ("halo_exchange", "halo_exchange_fused",
                    "param_gather_fused")
# trace process rows are named "<label>/<role> (<host>:<pid>)" by the
# collector ("<role> (<host>:<pid>)" pre-merge, obs/__init__.py) —
# parse back to the event worker id host:pid:role
_PROC_RE = re.compile(r"(?:.*/)?(?P<role>[^/]+) "
                      r"\((?P<host>[^:()]+):(?P<pid>\d+)\)$")

DEFAULT_SPIKE_RATIO = 1.5       # owner wall > k * median => spike
_PER_STEP_CAP = 100             # per_step extra rows kept in summary


# ----------------------------------------------------- interval algebra
def _merge(spans: Sequence[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    """Union as a sorted disjoint list (empty/inverted spans drop)."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted((a, b) for a, b in spans if b > a):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _clip(spans: Sequence[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in spans
            if min(b, hi) > max(a, lo)]


def _subtract(spans: Sequence[Tuple[float, float]],
              cover: Sequence[Tuple[float, float]]
              ) -> List[Tuple[float, float]]:
    """``union(spans) - union(cover)`` — both args need not be
    disjoint; the result is."""
    out: List[Tuple[float, float]] = []
    cover = _merge(cover)
    for a, b in _merge(spans):
        cur = a
        for ca, cb in cover:
            if cb <= cur:
                continue
            if ca >= b:
                break
            if ca > cur:
                out.append((cur, ca))
            cur = max(cur, cb)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


def _measure(spans: Sequence[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in spans)


# ------------------------------------------------------------- loaders
def _load_events(obs_dir: str) -> List[Dict]:
    from dgl_operator_tpu_torch.obs.analyze import load_events
    path = os.path.join(job_dir_of(obs_dir), EVENTS_JSONL)
    if not os.path.exists(path):
        path = os.path.join(obs_dir, EVENTS_JSONL)
    return load_events(path)


def _load_trace(obs_dir: str) -> List[Dict]:
    from dgl_operator_tpu_torch.obs._io import read_json
    path = os.path.join(job_dir_of(obs_dir), TRACE_JSON)
    if not os.path.exists(path):
        path = os.path.join(obs_dir, TRACE_JSON)
    doc = read_json(path, {})
    return [ev for ev in doc.get("traceEvents", [])
            if isinstance(ev, dict)]


def _clock_offsets(obs_dir: str) -> Dict[str, float]:
    from dgl_operator_tpu_torch.obs._io import read_json
    man = read_json(os.path.join(job_dir_of(obs_dir), "manifest.json"),
                    {})
    off = man.get("clock_offsets_us")
    return off if isinstance(off, dict) else {}


# ----------------------------------------------------- stream digestion
def step_windows(events: Sequence[Dict]
                 ) -> Dict[str, List[Tuple[int, float, float]]]:
    """Per-worker ``(step, t0, t1)`` windows from consecutive
    ``heartbeat`` events: the trainer emits a heartbeat after each
    device call, so the window between heartbeat N-1 and heartbeat N
    fences step N's work on that worker."""
    from dgl_operator_tpu_torch.obs.analyze import worker_id
    beats: Dict[str, List[Tuple[float, int]]] = {}
    for e in events:
        if e.get("event") != "heartbeat" \
                or not isinstance(e.get("step"), (int, float)):
            continue
        beats.setdefault(worker_id(e), []).append(
            (float(e.get("ts") or 0.0), int(e["step"])))
    out: Dict[str, List[Tuple[int, float, float]]] = {}
    for w, seq in beats.items():
        seq.sort()
        wins = [(s1, t0, t1) for (t0, _), (t1, s1)
                in zip(seq, seq[1:]) if t1 > t0]
        if wins:
            out[w] = wins
    return out


def _span_category(name: str, cat: str) -> Optional[str]:
    if cat == "chaos":
        return "stall"
    if name == "train_compute":
        return "compute"
    if cat == "comm" or name in _COMM_SPAN_NAMES:
        return "comm"
    if cat == "ckpt" or name.startswith("ckpt"):
        return "ckpt"
    return None


def spans_by_worker(trace_events: Sequence[Dict]
                    ) -> Dict[str, Dict[str, List[Tuple[float, float]]]]:
    """worker -> category -> [(t0, t1)] in epoch SECONDS, from the
    trace's complete (``ph == "X"``) spans, joined to workers through
    the ``process_name`` metadata rows."""
    pid_worker: Dict[object, str] = {}
    for ev in trace_events:
        if ev.get("ph") != "M" or ev.get("name") != "process_name":
            continue
        m = _PROC_RE.match(str((ev.get("args") or {}).get("name", "")))
        if m:
            pid_worker[ev.get("pid")] = (f"{m.group('host')}:"
                                         f"{m.group('pid')}:"
                                         f"{m.group('role')}")
    out: Dict[str, Dict[str, List[Tuple[float, float]]]] = {}
    for ev in trace_events:
        if ev.get("ph") != "X" \
                or not isinstance(ev.get("ts"), (int, float)):
            continue
        w = pid_worker.get(ev.get("pid"))
        if w is None:
            continue
        cat = _span_category(str(ev.get("name", "")),
                             str(ev.get("cat", "")))
        if cat is None:
            continue
        t0 = float(ev["ts"]) / 1e6
        out.setdefault(w, {}).setdefault(cat, []).append(
            (t0, t0 + float(ev.get("dur") or 0.0) / 1e6))
    return out


# ----------------------------------------------------------- attribution
def _attribute_window(t0: float, t1: float,
                      cats: Dict[str, List[Tuple[float, float]]]
                      ) -> Dict[str, float]:
    """Disjoint per-category seconds inside ``[t0, t1]``; sums (with
    ``other``) to exactly the window wall."""
    out: Dict[str, float] = {}
    covered: List[Tuple[float, float]] = []
    for cat in _PRIORITY:
        iv = _clip(cats.get(cat, ()), t0, t1)
        out[cat] = _measure(_subtract(iv, covered))
        covered = _merge(covered + list(iv))
    out["other"] = (t1 - t0) - _measure(covered)
    return out


def xray_report(events: Sequence[Dict],
                trace_events: Sequence[Dict],
                spike_ratio: float = DEFAULT_SPIKE_RATIO
                ) -> Optional[Dict]:
    """The full step-anatomy report (pure — tests feed synthetic
    streams). ``None`` when no worker produced two heartbeats (no
    step telemetry to anatomize)."""
    windows = step_windows(events)
    if not windows:
        return None
    spans = spans_by_worker(trace_events)

    # per (step, worker): wall + disjoint category seconds
    per_step: Dict[int, Dict[str, Dict]] = {}
    for w, wins in windows.items():
        cats = spans.get(w, {})
        for step, t0, t1 in wins:
            rec = _attribute_window(t0, t1, cats)
            rec["wall"] = t1 - t0
            per_step.setdefault(step, {})[w] = rec

    # critical path: the slowest worker owns each step
    steps = sorted(per_step)
    owner_rows: List[Dict] = []
    cat_s = {c: 0.0 for c in CATEGORIES}
    wall_s = 0.0
    owners: Counter = Counter()
    for step in steps:
        ws = per_step[step]
        owner = max(ws, key=lambda w: ws[w]["wall"])
        rec = ws[owner]
        owners[owner] += 1
        wall_s += rec["wall"]
        for c in CATEGORIES:
            cat_s[c] += rec[c]
        owner_rows.append({"step": step, "owner": owner,
                           "wall_s": round(rec["wall"], 6),
                           **{f"{c}_s": round(rec[c], 6)
                              for c in CATEGORIES}})
    if wall_s <= 0:
        return None
    fracs = {c: cat_s[c] / wall_s for c in CATEGORIES}

    # what-if: re-run the per-step max with a category removed —
    # every worker sheds its own category time, then the slowest
    # survivor sets the new step time
    def _without(cat: str) -> float:
        new = sum(max(r["wall"] - r[cat] for r in per_step[s].values())
                  for s in steps)
        return max(0.0, 1.0 - new / wall_s)

    dom, dom_n = owners.most_common(1)[0]

    def _owner_at_median() -> float:
        new = 0.0
        for s in steps:
            walls = {w: r["wall"] for w, r in per_step[s].items()}
            if dom in walls:
                walls[dom] = statistics.median(walls.values())
            new += max(walls.values())
        return max(0.0, 1.0 - new / wall_s)

    whatif = {"comm_free": _without("comm"),
              "stall_free": _without("stall"),
              "owner_at_median": _owner_at_median()}

    # periodicity: every-K-step spikes in the owner wall, aligned
    # against checkpoint / canary-promotion events
    med = statistics.median(r["wall_s"] for r in owner_rows)
    spikes = [r["step"] for r in owner_rows
              if med > 0 and r["wall_s"] > spike_ratio * med]
    every = None
    if len(spikes) >= 3:
        diffs = Counter(b - a for a, b in zip(spikes, spikes[1:]))
        k, n = diffs.most_common(1)[0]
        if k > 0 and n >= 2 and n * 2 >= sum(diffs.values()):
            every = k
    aligned = None
    if spikes:
        ck = {int(e["step"]) for e in events
              if e.get("event") == "ckpt_save"
              and isinstance(e.get("step"), (int, float))}
        ca = {int(e["step"]) for e in events
              if str(e.get("event", "")).startswith("ckpt_promote")
              and isinstance(e.get("step"), (int, float))}
        near = lambda s, ref: any(abs(s - r) <= 1 for r in ref)  # noqa: E731
        if ck and sum(near(s, ck) for s in spikes) * 2 >= len(spikes):
            aligned = "ckpt_save"
        elif ca and sum(near(s, ca) for s in spikes) * 2 >= len(spikes):
            aligned = "ckpt_promote"

    return {
        "steps": len(steps),
        "workers": sorted(windows),
        "step_wall_mean_s": wall_s / len(steps),
        "critpath_frac": fracs,
        "critical_owner": dom,
        "critical_owner_frac": dom_n / len(steps),
        "owner_seconds": {c: cat_s[c] for c in CATEGORIES},
        "whatif": whatif,
        "periodicity": {"spike_steps": spikes, "every": every,
                        "aligned_with": aligned},
        "per_step": owner_rows,
        "owners": dict(owners),
    }


# -------------------------------------------------------------- summary
def xray_summary(obs_dir: str) -> Optional[Dict[str, object]]:
    """Step-anatomy summary of a finished run's obs dir, shaped by the
    pinned ``benchkeys.XRAY_KEYS`` (benchmarks/bench_xray.py tracks it
    as XRAY.json; the doctor xray block renders it). ``None`` when the
    run left no step telemetry — pre-xray obs dirs are unchanged."""
    rep = xray_report(_load_events(obs_dir), _load_trace(obs_dir))
    if rep is None:
        return None
    fr = rep["critpath_frac"]
    out: Dict[str, object] = {
        "steps": rep["steps"],
        "workers": len(rep["workers"]),
        "step_wall_mean_s": round(rep["step_wall_mean_s"], 6),
        "critpath_frac_compute": round(fr["compute"], 4),
        "critpath_frac_comm": round(fr["comm"], 4),
        "critpath_frac_stall": round(fr["stall"], 4),
        "critpath_frac_ckpt": round(fr["ckpt"], 4),
        "critpath_frac_other": round(fr["other"], 4),
        "critical_owner": rep["critical_owner"],
        "critical_owner_frac": round(rep["critical_owner_frac"], 4),
        "whatif_comm_free_frac": round(rep["whatif"]["comm_free"], 4),
        "whatif_stall_free_frac": round(rep["whatif"]["stall_free"], 4),
        "whatif_owner_at_median_frac":
            round(rep["whatif"]["owner_at_median"], 4),
        "periodic_spike_every": rep["periodicity"]["every"],
    }
    assert tuple(out) == XRAY_KEYS
    out["owner_seconds"] = {k: round(v, 6) for k, v
                            in rep["owner_seconds"].items()}
    out["owners"] = rep["owners"]
    out["per_step"] = rep["per_step"][:_PER_STEP_CAP]
    out["periodicity"] = rep["periodicity"]
    out["clock_offsets_us"] = _clock_offsets(obs_dir)
    return out


# ------------------------------------------------------------ live plane
# PhaseTimer bucket -> xray category for the rolling /livez gauge:
# dispatch is the device-call enqueue (compute proxy), exchange the
# halo stage, stall the blocked loop thread; sample is host-side work
# no trace span categorizes — same bucket the trace remainder lands in
_LIVE_PHASE_CAT = {"dispatch": "compute", "exchange": "comm",
                   "stall": "stall", "sample": "other"}


def live_critpath(totals: Optional[Dict[str, float]]
                  ) -> Optional[Dict[str, float]]:
    """Normalized category fractions from a PhaseTimer totals dict —
    the cheap single-worker estimate of ``critpath_frac`` the live
    feed publishes between collections (obs/live.py; the real
    cross-host number needs the merged trace). ``None`` when the
    timer has accumulated nothing yet."""
    acc: Dict[str, float] = {}
    for phase, v in (totals or {}).items():
        cat = _LIVE_PHASE_CAT.get(phase)
        if cat is not None and v and v > 0:
            acc[cat] = acc.get(cat, 0.0) + float(v)
    tot = sum(acc.values())
    if tot <= 0:
        return None
    return {k: round(v / tot, 4) for k, v in sorted(acc.items())}


# ------------------------------------------------------------------ CLI
def render(s: Dict, obs_dir: str) -> str:
    lines = ["tpu-xray — distributed step anatomy"]
    lines.append(f"  obs dir : {obs_dir}")
    lines.append(f"  steps   : {s['steps']} across {s['workers']} "
                 f"worker(s); mean critical-path step "
                 f"{s['step_wall_mean_s']:.4f}s")
    lines.append("  critpath: " + "  ".join(
        f"{c} {s[f'critpath_frac_{c}']:.0%}" for c in CATEGORIES))
    lines.append(f"  owner   : {s['critical_owner']} owns "
                 f"{s['critical_owner_frac']:.0%} of the steps")
    lines.append(
        f"  what-if : comm free → step "
        f"−{s['whatif_comm_free_frac']:.0%};  stalls removed → "
        f"−{s['whatif_stall_free_frac']:.0%};  "
        f"{s['critical_owner']} at median rate → "
        f"−{s['whatif_owner_at_median_frac']:.0%}")
    per = s.get("periodicity") or {}
    if per.get("spike_steps"):
        lines.append(
            f"  periodic: {len(per['spike_steps'])} spike step(s)"
            + (f", every {per['every']} steps" if per.get("every")
               else "")
            + (f" — aligned with {per['aligned_with']}"
               if per.get("aligned_with") else ""))
    off = s.get("clock_offsets_us") or {}
    skewed = {k: v for k, v in off.items() if v}
    if skewed:
        lines.append("  clocks  : skew-corrected "
                     + ", ".join(f"{k} {v:+.0f}µs"
                                 for k, v in sorted(skewed.items())))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-xray",
        description="Reconstruct a run's cross-host step anatomy: "
                    "blame-attributed critical path, what-if "
                    "estimates, and periodic-stall detection.")
    ap.add_argument("obs_dir", nargs="?", default=None,
                    help="obs directory (default: $TPU_OPERATOR_OBS_DIR"
                         ", else <workspace>/obs)")
    ap.add_argument("--workspace", default=None,
                    help="workspace whose obs/ subdir to analyze")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as JSON instead of text")
    args = ap.parse_args(argv)
    from dgl_operator_tpu_torch.obs.doctor import resolve_obs_dir
    try:
        obs_dir = resolve_obs_dir(args.obs_dir, args.workspace)
    except SystemExit:
        ap.error("no obs directory: pass one, set "
                 f"{OBS_DIR_ENV}, or use --workspace")
    if not os.path.isdir(obs_dir):
        print(f"tpu-xray: no such obs directory: {obs_dir}",
              file=sys.stderr)
        return 2
    # a plain single-host obs dir becomes its own job view, exactly
    # like the doctor (the merge also computes clock offsets)
    from dgl_operator_tpu_torch.obs.collect import merge_job_view
    if not os.path.exists(os.path.join(job_dir_of(obs_dir),
                                       EVENTS_JSONL)):
        merge_job_view(job_dir_of(obs_dir),
                       sources=[("local", obs_dir)])
    s = xray_summary(obs_dir)
    if s is None:
        print("tpu-xray: no step telemetry (need >= 2 heartbeats "
              "from at least one worker)", file=sys.stderr)
        return 1
    print(json.dumps(s, indent=2, sort_keys=True) if args.json
          else render(s, obs_dir))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
