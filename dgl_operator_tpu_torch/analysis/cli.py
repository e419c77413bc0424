"""``python -m dgl_operator_tpu_torch.analysis`` — the port's lint
entry point, the counterpart of the JAX package's ``tpu-lint``.

Exit status: 0 clean (baselined/suppressed findings don't count),
1 any live finding or unparsable file, 2 usage error.

The baseline workflow mirrors every mature linter: ``--write-baseline``
records the current findings as accepted debt; later runs fail only on
NEW findings. The committed baseline
(dgl_operator_tpu_torch/analysis/baseline.json) is empty: the port's
surface lints clean, so rc 1 means a real regression, not noise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from dgl_operator_tpu_torch.analysis.core import (DEFAULT_PATHS, run_lint,
                                                  write_baseline)
from dgl_operator_tpu_torch.analysis.rules import RULES

DEFAULT_BASELINE = os.path.join("dgl_operator_tpu_torch", "analysis",
                                "baseline.json")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tpu-lint",
        description="Invariant-checking static analysis for "
                    "dgl_operator_tpu_torch (rules TPU001-TPU006 in "
                    "their torch meaning; --list-rules)")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: "
                         f"{' '.join(DEFAULT_PATHS)} under --root)")
    ap.add_argument("--root", default=None,
                    help="repo root for relative paths, the docs "
                         "catalogue, and report paths (default: cwd)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file of accepted findings "
                         f"(default: <root>/{DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding")
    ap.add_argument("--write-baseline", action="store_true",
                    help="record the current live findings into the "
                         "baseline file and exit 0")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for r in RULES:
            print(f"{r.code} {r.name}\n    {r.doc}\n")
        return 0
    root = os.path.abspath(args.root or os.getcwd())
    baseline = (None if args.no_baseline else
                args.baseline or os.path.join(root, DEFAULT_BASELINE))
    try:
        report = run_lint(paths=args.paths or None, root=root,
                          baseline_path=(None if args.write_baseline
                                         else baseline))
    except (OSError, ValueError) as exc:
        print(f"tpu-lint: {exc}", file=sys.stderr)
        return 2
    if args.write_baseline:
        path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
        write_baseline(path, report.findings)
        print(f"tpu-lint: baseline written to {path} "
              f"({len(report.findings)} finding(s))")
        return 0
    if args.as_json:
        print(json.dumps(report.as_dict(), indent=2, sort_keys=True))
    else:
        print(report.render())
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
