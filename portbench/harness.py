"""One cell, one run, one result line.

:func:`main` reads ``--workload``, ``--seed``, ``--seconds`` and
``--trace``, refuses to run without as many CUDA cards as the cell asks
for, runs the cell's traffic driver, has each metric's reader read the
run, and prints the result: the compared numbers with their limits as
the last lines of standard error, then one JSON line on standard output
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``compared``). It exits non-zero,
and prints no result, when a module of JAX or of the JAX package is
loaded, at start-up and once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from typing import Dict, Iterable, List, Optional

from portbench import spec

# top-level module names that nothing the harness runs may load,
# compared whole: the port's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "dgl_operator_tpu")
# the program's modules the drivers use, loaded at start-up so that the
# first import check sees them
PROGRAM = ("dgl_operator_tpu_torch.runtime.loop",
           "dgl_operator_tpu_torch.graph.graph")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded modules (or ``names``) whose top-level name is one of
    ``FORBIDDEN``."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def process_start() -> float:
    """This process's start on the wall clock (Linux: from
    ``/proc/self/stat`` and the boot time); the current time elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, metrics: Optional[List[str]] = None,
             cell: Optional[spec.Cell] = None) -> Dict:
    """Run cell ``name`` on ``device`` and return its result (the
    printed line's object). ``metrics`` defaults to what
    ``BENCHMARK.json`` gives the cell for this kind of run; ``cell``, to
    the cell's files."""
    import torch

    cell = cell or spec.load_cell(name)
    device = torch.device(device)
    rec = cell.driver.run(cell, int(seed), float(seconds), bool(trace),
                          device, t_start)
    names = metrics if metrics is not None else spec.cell_metrics(name, trace)
    values = {}
    for m in names:
        reader = spec.metric_reader(m)
        v = reader.read(rec["ctx"])
        if v is not None:
            values[m] = {"value": float(v), "unit": reader.UNIT}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"correct": bool(rec["correct"]), "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": values, "device": dev}
    tr = rec.get("trace")
    if trace and tr:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["compared"] = rec["compared"]
    out["_notes"] = {"error": rec.get("error"),
                     "host_cuda_calls": (tr or {}).get("host_cuda_calls"),
                     "device_us_by_kind": (tr or {}).get("by_kind_us"),
                     "setup_phases": rec["ctx"].get("setup_phases"),
                     "window": rec["ctx"].get("window_note"),
                     "graph": rec["ctx"].get("graph"),
                     "call_gaps": len(rec["ctx"].get("call_gap_ms") or [])}
    return out


def emit(result: Dict) -> None:
    """Standard error's last lines (the compared numbers with their
    limits) and the result line on standard output."""
    notes = result.pop("_notes", {})
    if notes.get("error"):
        print(f"portbench: a call raised: {notes['error']}", file=sys.stderr)
    if notes.get("setup_phases"):
        print("portbench: set-up seconds "
              + json.dumps(notes["setup_phases"]), file=sys.stderr)
    if notes.get("graph"):
        print("portbench: graph " + json.dumps(notes["graph"]),
              file=sys.stderr)
    if notes.get("window"):
        print("portbench: window " + json.dumps(notes["window"]),
              file=sys.stderr)
    if notes.get("host_cuda_calls"):
        print("portbench: host seconds in CUDA calls, traced stretch "
              + json.dumps(notes["host_cuda_calls"]), file=sys.stderr)
    if notes.get("device_us_by_kind"):
        print("portbench: device us by kind, traced stretch "
              + json.dumps(notes["device_us_by_kind"]), file=sys.stderr)
    if notes.get("call_gaps"):
        print(f"portbench: call_ms_p95 over {notes['call_gaps']} gaps",
              file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv: List[str], t_start: float) -> int:
    import torch

    torch.set_num_threads(1)
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be >= 0")
    cell = spec.load_cell(args.workload)
    for mod in PROGRAM:
        importlib.import_module(mod)
    cell.driver, cell.kind      # load them before the first check
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX modules loaded at start-up: {bad}",
              file=sys.stderr)
        return 3
    chips = int(cell.traffic.get("chips", 1))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); {have} "
              "available", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX modules loaded by the run: {bad}",
              file=sys.stderr)
        return 3
    emit(result)
    return 0
