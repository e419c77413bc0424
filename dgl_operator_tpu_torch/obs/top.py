"""``tpu-top`` — a refreshing per-host/per-role console view of a
running job.

The doctor diagnoses a run after the fact; ``tpu-top`` answers the
operator's live question — which worker is slow *right now* — by
polling the run's registered live sidecars (``<obs_dir>/live/`` →
``GET /livez``, :mod:`~.live`) and rendering one row per process:
step, step rate, heartbeat rate, qps, p50/p99 latency, halo-exchange
MiB/s, stall fraction, SLO state, and — when the run carries the
utilization profiler (obs/prof.py) — rolling MFU and the HBM
watermark. Workers without a reachable
sidecar fall back to the file plane (events.jsonl heartbeats — the
:func:`~.analyze.job_health` signal), marked ``file`` in the source
column so the operator knows how fresh the row is.

Usage::

    python -m dgl_operator_tpu_torch.obs.top [<obs-dir>] [--once] [--interval 2.0]
    python -m dgl_operator_tpu_torch.obs.top --workspace ws --once

Exit status: 0 (``--once``: also when the view rendered but carried no
workers — an empty job is not an error), 2 on usage errors.

Standard library only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

from dgl_operator_tpu_torch.obs import OBS_DIR_ENV
from dgl_operator_tpu_torch.obs.live import fetch_livez, live_endpoints

_COLUMNS = ("worker", "src", "state", "step", "loss", "gnorm",
            "step/s", "hb/s",
            "qps", "p50ms", "p99ms", "exMiB/s", "comMiB/s", "stall%",
            "ovl", "mfu", "hbmMiB", "crit")


def _fmt(v, nd: int = 2) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def _row_from_livez(snap: Dict) -> Dict:
    slo = snap.get("slo") or {}
    if snap.get("done"):
        state = "done"
    elif snap.get("shedding"):
        state = "SHED"
    elif slo and not slo.get("ok", True):
        state = "SLO!"
    else:
        state = "ok"
    stall = snap.get("stall_frac")
    return {
        "worker": f"{snap.get('host', '?')}:{snap.get('pid', '?')}:"
                  f"{snap.get('role', '?')}",
        "src": "live", "state": state,
        "step": snap.get("step"),
        # model-health columns (obs/quality.py riders on the live feed)
        "loss": snap.get("loss"),
        "gnorm": snap.get("grad_norm"),
        "step/s": snap.get("step_rate_hz"),
        "hb/s": snap.get("heartbeat_hz"),
        "qps": snap.get("qps"),
        "p50ms": snap.get("p50_ms"),
        "p99ms": snap.get("p99_ms"),
        "exMiB/s": snap.get("exchange_mib_per_s"),
        # watched-collective rate over ALL mesh axes (obs/comm.py
        # axis_bytes_total rider; the per-axis dict stays on /livez
        # as comm_axis_mib_per_s for drill-down)
        "comMiB/s": snap.get("comm_mib_per_s"),
        "stall%": (round(stall * 100, 1) if stall is not None
                   else None),
        "ovl": snap.get("overlap_ratio"),
        "mfu": snap.get("mfu"),
        "hbmMiB": snap.get("hbm_mib"),
        # dominant critical-path category over the rolling window
        # (obs/xray.py live_critpath rider on the live feed),
        # rendered "cat:frac" — the glanceable "what is this worker
        # spending its step on" column
        "crit": _crit_cell(snap.get("critpath_frac")),
    }


def _crit_cell(fracs: Optional[Dict]) -> Optional[str]:
    if not isinstance(fracs, dict) or not fracs:
        return None
    cat = max(fracs, key=fracs.get)
    return f"{cat}:{fracs[cat]:.2f}"


def _rows_from_files(obs_dir: str, seen: set) -> List[Dict]:
    """File-plane fallback rows for workers with no live sidecar: the
    events.jsonl heartbeat signal (``job_health``)."""
    from dgl_operator_tpu_torch.obs.analyze import job_health
    rows: List[Dict] = []
    for w, rec in job_health(obs_dir).get("workers", {}).items():
        if w in seen:
            continue
        rows.append({"worker": w, "src": "file",
                     "state": rec.get("status", "?"),
                     "step": rec.get("last_step"),
                     "loss": None, "gnorm": None,
                     "step/s": None, "hb/s": None, "qps": None,
                     "p50ms": None, "p99ms": None, "exMiB/s": None,
                     "comMiB/s": None, "stall%": None, "ovl": None,
                     "mfu": None, "hbmMiB": None, "crit": None})
    return rows


def gather_rows(obs_dir: str, timeout: float = 1.0) -> List[Dict]:
    """One refresh: every reachable live endpoint becomes a live row;
    everyone else the file plane still knows about rides along."""
    rows: List[Dict] = []
    seen: set = set()
    for ep in live_endpoints(obs_dir):
        snap = fetch_livez(ep, timeout=timeout)
        if snap is None:
            continue
        row = _row_from_livez(snap)
        rows.append(row)
        seen.add(row["worker"])
    rows.extend(_rows_from_files(obs_dir, seen))
    rows.sort(key=lambda r: (r["src"] != "live", r["worker"]))
    return rows


def render(rows: List[Dict], obs_dir: str) -> str:
    widths = {c: len(c) for c in _COLUMNS}
    table = []
    for r in rows:
        cells = {c: _fmt(r.get(c)) for c in _COLUMNS}
        for c, v in cells.items():
            widths[c] = max(widths[c], len(v))
        table.append(cells)
    lines = [f"tpu-top — {obs_dir}  "
             f"({len(rows)} worker(s), "
             f"{time.strftime('%H:%M:%S')})"]
    lines.append("  ".join(c.ljust(widths[c]) for c in _COLUMNS))
    for cells in table:
        lines.append("  ".join(cells[c].ljust(widths[c])
                               for c in _COLUMNS))
    if not rows:
        lines.append("(no workers yet — is the job running and "
                     "TPU_OPERATOR_LIVE_PORT exported?)")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-top",
        description="Live per-host/per-role view of a running job "
                    "(step rate, p99, exchange MiB/s, SLO state) from "
                    "the obs live sidecars, file-plane fallback.")
    ap.add_argument("obs_dir", nargs="?", default=None,
                    help="obs directory (default: $TPU_OPERATOR_OBS_DIR"
                         ", else <workspace>/obs)")
    ap.add_argument("--workspace", default=None,
                    help="workspace whose obs/ subdir to watch")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (CI / scripts)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds")
    ap.add_argument("--timeout", type=float, default=1.0,
                    help="per-endpoint /livez timeout")
    ap.add_argument("--json", action="store_true",
                    help="emit the rows as JSON instead of a table")
    args = ap.parse_args(argv)
    obs_dir = (args.obs_dir or os.environ.get(OBS_DIR_ENV)
               or (os.path.join(args.workspace, "obs")
                   if args.workspace else None))
    if not obs_dir:
        ap.error("no obs directory: pass one, set "
                 f"{OBS_DIR_ENV}, or use --workspace")
    obs_dir = os.path.abspath(obs_dir)
    if not os.path.isdir(obs_dir):
        print(f"tpu-top: no such obs directory: {obs_dir}",
              file=sys.stderr)
        return 2
    while True:
        rows = gather_rows(obs_dir, timeout=args.timeout)
        if args.json:
            print(json.dumps({"obs_dir": obs_dir, "rows": rows}))
        else:
            frame = render(rows, obs_dir)
            if not args.once:
                # clear + home, full-screen refresh (plain ANSI; tput
                # would drag in a terminfo dependency)
                frame = "\x1b[2J\x1b[H" + frame
            print(frame, flush=True)
        if args.once:
            return 0
        try:
            time.sleep(max(args.interval, 0.2))
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    raise SystemExit(main())
