"""Job-level telemetry collection: pull every worker's obs artifacts
back over the exec/copy fabric and fold them into ONE ``obs/job/``
view.

Every process writes events, metrics and traces, but each host's
``obs/`` directory is an island — the reference's only cross-host
visibility is ``kubectl exec`` / ``kubectl cp`` by hand. The collector
closes that gap with the same two verbs: :func:`collect_job` fetches
each host's artifact files (``Fabric.fetch`` — the pull direction of
the copy verb, so the chaos and retry layers wrapped around the fabric
cover collection exactly like any other data-plane call) into
``obs/job/hosts/<host>/`` and then merges them:

- ``obs/job/events.jsonl`` — one event timeline ordered across hosts
  (exact-duplicate records collapse, so hosts sharing one filesystem —
  the LocalFabric case — contribute each record once);
- ``obs/job/metrics.json`` — every process's snapshot under ``procs``,
  a per-host merged view under ``hosts``, and the global ``merged``
  view (rendered to ``obs/job/metrics.prom``);
- ``obs/job/trace.json`` — a single Chrome trace: per-source pid
  remapping keeps one process row per (host, pid) even when real
  hosts' pids collide, with ``process_name`` metadata labeling each
  row by its origin.

Collection is best-effort per host: a lost host's missing artifacts
are recorded in the returned manifest (and surface as findings in
``obs/analyze.py``), never raised — telemetry must not fail the job.

Standard library only (the fabric is imported lazily, when the caller
passes none): the analytics and doctor layers import this module.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from dgl_operator_tpu_torch.obs._io import atomic_write, read_json
from dgl_operator_tpu_torch.obs.events import EVENTS_JSONL
from dgl_operator_tpu_torch.obs.metrics import (METRICS_JSON, METRICS_PROM,
                                                merge_snapshots,
                                                render_prometheus)
from dgl_operator_tpu_torch.obs.trace import TRACE_JSON

JOB_SUBDIR = "job"
HOSTS_SUBDIR = "hosts"
ARTIFACTS = (EVENTS_JSONL, METRICS_JSON, METRICS_PROM, TRACE_JSON)


def job_dir_of(obs_dir: str) -> str:
    return os.path.join(obs_dir, JOB_SUBDIR)


# ----------------------------------------------------------- collection
def collect_job(obs_dir: str, hosts: Sequence[str], fabric=None,
                remote_dir: Optional[str] = None,
                container: Optional[str] = None) -> Dict:
    """Fetch every host's obs artifacts into
    ``<obs_dir>/job/hosts/<host>/`` and merge them into the job view.
    ``remote_dir`` is the obs directory path on the workers (defaults
    to ``obs_dir`` — the operator stages the same workspace path in
    every pod). Returns a manifest: per-host fetched/missing artifacts
    plus the merge summary."""
    if fabric is None:
        from dgl_operator_tpu_torch.launcher.fabric import get_fabric
        fabric = get_fabric()
    remote_dir = remote_dir or obs_dir
    job_dir = job_dir_of(obs_dir)
    manifest: Dict = {"job_dir": job_dir, "hosts": {}}
    sources: List[Tuple[str, str]] = []
    for host in hosts:
        hdir = os.path.join(job_dir, HOSTS_SUBDIR, host)
        os.makedirs(hdir, exist_ok=True)
        rec: Dict = {"fetched": [], "errors": {}}
        for name in ARTIFACTS:
            try:
                fabric.fetch(host, os.path.join(remote_dir, name), hdir,
                             container=container)
                rec["fetched"].append(name)
            except Exception as exc:  # noqa: BLE001 — per-host record
                rec["errors"][name] = str(exc)[:300]
        manifest["hosts"][host] = rec
        if rec["fetched"]:
            sources.append((host, hdir))
    manifest.update(merge_job_view(job_dir, sources=sources))
    atomic_write(os.path.join(job_dir, "manifest.json"),
                 json.dumps(manifest, indent=2, sort_keys=True))
    return manifest


# ---------------------------------------------------------------- merge
def merge_job_view(job_dir: str,
                   sources: Optional[Sequence[Tuple[str, str]]] = None
                   ) -> Dict:
    """Merge ``(label, directory)`` sources — per-host fetches, or a
    single local obs dir — into the job view under ``job_dir``.
    Defaults to the directories under ``<job_dir>/hosts/``."""
    if sources is None:
        hroot = os.path.join(job_dir, HOSTS_SUBDIR)
        names = sorted(os.listdir(hroot)) if os.path.isdir(hroot) else []
        sources = [(n, os.path.join(hroot, n)) for n in names
                   if os.path.isdir(os.path.join(hroot, n))]
    os.makedirs(job_dir, exist_ok=True)
    docs = _read_trace_docs(sources)
    offsets = _trace_clock_offsets(docs)
    n_events, run_id = _merge_events(job_dir, sources, offsets)
    n_procs = _merge_metrics(job_dir, sources, run_id)
    n_trace = _merge_trace(job_dir, docs, offsets)
    return {"sources": [label for label, _ in sources],
            "run": run_id, "events": n_events, "procs": n_procs,
            "trace_events": n_trace,
            "clock_offsets_us": {k: round(v, 1)
                                 for k, v in offsets.items()}}


def _merge_events(job_dir, sources, offsets=None
                  ) -> Tuple[int, Optional[str]]:
    """One timeline across hosts: parse every source's events.jsonl,
    drop exact duplicates (hosts sharing a filesystem fetch the same
    file), clock-align each source by the trace-derived offset (the
    xray's heartbeat step windows must live on the same clock as the
    aligned trace spans), stable-sort by timestamp."""
    seen = set()
    records: List[Dict] = []
    run_id = None
    for label, d in sources:
        # offsets are trace µs; event timestamps are epoch seconds
        off_s = (offsets or {}).get(label, 0.0) / 1e6
        path = os.path.join(d, EVENTS_JSONL)
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line or line in seen:
                continue
            seen.add(line)
            try:
                rec = json.loads(line)
            except ValueError:
                continue   # torn tail line of a killed writer
            if isinstance(rec, dict):
                if off_s and isinstance(rec.get("ts"), (int, float)):
                    rec["ts"] = float(rec["ts"]) + off_s
                records.append(rec)
                if run_id is None and rec.get("run"):
                    run_id = rec["run"]
    records.sort(key=lambda r: (r.get("ts") or 0.0))
    atomic_write(os.path.join(job_dir, EVENTS_JSONL),
                 "".join(json.dumps(r, default=str) + "\n"
                         for r in records))
    return len(records), run_id


def _merge_metrics(job_dir, sources, run_id) -> int:
    """Global ``merged`` + per-host merged series + every process's
    snapshot. Procs are keyed ``host:pid:role`` already, so shared-dir
    duplicates collapse by key."""
    procs: Dict[str, dict] = {}
    hosts_view: Dict[str, dict] = {}
    for label, d in sources:
        data = read_json(os.path.join(d, METRICS_JSON), {})
        sprocs = data.get("procs") or {}
        if not isinstance(sprocs, dict):
            continue
        procs.update(sprocs)
        if sprocs:
            hosts_view[label] = merge_snapshots(
                sprocs[p] for p in sorted(sprocs))
    merged = merge_snapshots(procs[p] for p in sorted(procs))
    atomic_write(os.path.join(job_dir, METRICS_JSON), json.dumps(
        {"run": run_id, "hosts": hosts_view, "procs": procs,
         "merged": merged}, indent=2, sort_keys=True))
    atomic_write(os.path.join(job_dir, METRICS_PROM),
                 render_prometheus(merged))
    return len(procs)


def _trace_clock_offsets(docs: Sequence[Tuple[str, List[Dict]]]
                         ) -> Dict[str, float]:
    """Per-source clock offset (µs to ADD to every timestamp of the
    source) estimated from matched phase-barrier anchors. Hosts stamp
    spans on their own wall clocks, so raw cross-host merge order is
    wrong under skew — and any critical path read from it is fiction.

    The anchors are the driver's ``export_env`` phase spans
    (cat="tpurun", launcher/tpurun.py): the driver publishes its span
    ids into the environment of every subprocess it spawns inside the
    span, so a trainer span whose ``parent_id`` matches an anchor from
    a DIFFERENT source is causally fenced by it — the child cannot
    start before its parent started, nor end after its parent ended.
    An observed violation is provable skew; the correction is the
    minimal shift restoring both bounds (0 when causality already
    holds, so zero-skew runs — and the doctor's single-source local
    path — merge byte-identically to the pre-alignment behavior)."""
    anchors: Dict[str, Tuple[str, float, float]] = {}
    for label, evs in docs:
        for ev in evs:
            if ev.get("ph") != "X" or ev.get("cat") != "tpurun":
                continue
            sid = (ev.get("args") or {}).get("span_id")
            if sid and isinstance(ev.get("ts"), (int, float)):
                anchors[sid] = (label, float(ev["ts"]),
                                float(ev["ts"]) + float(ev.get("dur")
                                                        or 0.0))
    offsets: Dict[str, float] = {label: 0.0 for label, _ in docs}
    for label, evs in docs:
        lo = hi = None
        for ev in evs:
            if ev.get("ph") != "X" \
                    or not isinstance(ev.get("ts"), (int, float)):
                continue
            a = anchors.get((ev.get("args") or {}).get("parent_id"))
            if a is None or a[0] == label:
                continue       # only FOREIGN anchors carry skew signal
            s = float(ev["ts"])
            e = s + float(ev.get("dur") or 0.0)
            lo = max(lo, a[1] - s) if lo is not None else a[1] - s
            hi = min(hi, a[2] - e) if hi is not None else a[2] - e
        if lo is None:
            continue
        if lo > 0:             # host clock behind the driver's
            offsets[label] = lo
        elif hi is not None and hi < 0:   # host clock ahead
            offsets[label] = hi
    return offsets


def _read_trace_docs(sources) -> List[Tuple[str, List[Dict]]]:
    docs: List[Tuple[str, List[Dict]]] = []
    for label, d in sources:
        doc = read_json(os.path.join(d, TRACE_JSON), {})
        docs.append((label, [ev for ev in doc.get("traceEvents", [])
                             if isinstance(ev, dict)]))
    return docs


def _merge_trace(job_dir, docs, offsets) -> int:
    """One Chrome trace for the whole job. Events dedupe on exact
    content; surviving events remap pid by (origin source, pid) so two
    hosts' colliding pids get separate process rows, each labeled by a
    ``process_name`` metadata record carrying its origin. Timestamps
    are clock-aligned per source (:func:`_trace_clock_offsets`) during
    the remap."""
    seen = set()
    pid_map: Dict[Tuple[str, object], int] = {}
    named = set()
    out: List[Dict] = []
    extra_meta: List[Dict] = []

    def mapped(label, opid) -> int:
        key = (label, opid)
        if key not in pid_map:
            pid_map[key] = len(pid_map) + 1
        return pid_map[key]

    for label, evs in docs:
        off = offsets.get(label, 0.0)
        for ev in evs:
            # dedupe on the RAW record: hosts sharing one filesystem
            # fetch the same file under every label, and the copies
            # must collapse before any per-label offset can fork them
            key = json.dumps(ev, sort_keys=True, default=str)
            if key in seen:
                continue
            seen.add(key)
            ev = dict(ev)
            opid = ev.get("pid")
            ev["pid"] = mapped(label, opid)
            if off and isinstance(ev.get("ts"), (int, float)):
                ev["ts"] = round(float(ev["ts"]) + off, 1)
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                args = dict(ev.get("args") or {})
                args["name"] = f"{label}/{args.get('name', opid)}"
                ev["args"] = args
                named.add(ev["pid"])
            out.append(ev)
    for (label, opid), pid in sorted(pid_map.items(),
                                     key=lambda kv: kv[1]):
        if pid not in named:
            extra_meta.append({"name": "process_name", "ph": "M",
                               "pid": pid, "tid": 0,
                               "args": {"name": f"{label}/pid {opid}"}})
    doc = {"traceEvents": extra_meta + out, "displayTimeUnit": "ms"}
    atomic_write(os.path.join(job_dir, TRACE_JSON),
                 json.dumps(doc, indent=1))
    return len(out)
