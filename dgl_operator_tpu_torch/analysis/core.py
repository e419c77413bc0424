"""Lint framework: rule base class, visitor driver, suppressions,
baseline and reports — the port's copy of the JAX package's
``analysis/core.py``, with the port's own lint surface.

- A :class:`Rule` sees one parsed module at a time through a
  :class:`ModuleContext` (source, AST, import-alias resolver) and
  yields :class:`Finding`\\ s.
- Suppression is per line: a ``# tpu-lint: disable=TPU001`` (or a
  comma list, or bare ``disable`` for all rules) on the flagged line
  or on a comment line directly above it. The syntax is the JAX
  package's, so one comment convention serves both trees.
- The baseline file records *accepted* findings by
  ``(rule, path, message)``; line numbers are deliberately not part of
  the identity, so unrelated edits that shift a baselined finding do
  not resurrect it. The committed baseline is empty: the port's
  surface lints clean, and a new finding exits 1.

Standard library only; the rules module may load the port's knob
registry (and with it torch) for TPU004.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence

BASELINE_VERSION = 1
REPORT_VERSION = 1

# the default lint surface when no paths are given (repo-root relative):
# the port's package and its card smoke, never the JAX package's files
DEFAULT_PATHS = ("dgl_operator_tpu_torch", "chip_smoke.py")
_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules"}

_SUPPRESS_RE = re.compile(
    r"#\s*tpu-lint:\s*disable(?:=(?P<rules>[A-Z0-9,\s]+))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation. ``key()`` is the baseline identity —
    line/col are display-only so baselined findings survive line
    drift."""

    rule: str          # e.g. "TPU001"
    path: str          # repo-root-relative, '/'-separated
    line: int
    col: int
    message: str

    def key(self) -> str:
        return f"{self.rule}|{self.path}|{self.message}"

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} {self.message}")


class ModuleContext:
    """One parsed module plus the helpers every rule needs: the
    import-alias resolver (``np`` → ``numpy``, ``from time import
    time`` → ``time.time``), a name→FunctionDef index, and the
    repo-relative path."""

    def __init__(self, path: str, relpath: str, source: str,
                 tree: ast.AST, root: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = tree
        self.root = root
        self._aliases: Dict[str, str] = {}
        self.functions: Dict[str, List[ast.AST]] = {}
        self._index()

    def _index(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self._aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self._aliases[a.asname or a.name] = (
                        f"{node.module}.{a.name}")
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                self.functions.setdefault(node.name, []).append(node)

    def qualname(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted path of a Name/Attribute chain with the
        leading import alias expanded: ``np.random.rand`` →
        ``numpy.random.rand``; unresolvable shapes (calls, subscripts)
        return None."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self._aliases.get(node.id, node.id))
        return ".".join(reversed(parts))

    def call_qualname(self, call: ast.Call) -> Optional[str]:
        return self.qualname(call.func)


class Rule:
    """Base class. Subclasses set ``code``/``name``/``doc`` (the
    runtime incident the rule encodes — rendered by ``--list-rules``
    and docs/static_analysis.md) and implement :meth:`check`."""

    code = "TPU000"
    name = "abstract"
    doc = ""

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(self.code, ctx.relpath,
                       getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0), message)


# ------------------------------------------------------- suppressions
def suppressed_lines(source: str) -> Dict[int, Optional[frozenset]]:
    """Map line number → suppressed rule set (None = all rules).
    A comment suppresses its own line; a comment-only line also
    suppresses the line directly below it (the conventional place
    when the flagged line has no room)."""
    out: Dict[int, Optional[frozenset]] = {}
    lines = source.splitlines()
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = m.group("rules")
        spec = (None if rules is None else
                frozenset(r.strip() for r in rules.split(",")
                          if r.strip()))

        def merge(lineno: int, s=spec) -> None:
            prev = out.get(lineno, frozenset())
            if s is None or prev is None:
                out[lineno] = None
            else:
                out[lineno] = prev | s

        merge(i)
        if text.lstrip().startswith("#"):
            merge(i + 1)
    return out


def is_suppressed(finding: Finding,
                  supp: Dict[int, Optional[frozenset]]) -> bool:
    spec = supp.get(finding.line, frozenset())
    return spec is None or finding.rule in spec


# ------------------------------------------------------------ baseline
def load_baseline(path: Optional[str]) -> Dict[str, Dict]:
    """Baseline file → {finding key: entry}. Missing file = empty
    baseline; a malformed file raises (a torn baseline must not
    silently accept every finding)."""
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"baseline {path}: version "
                         f"{data.get('version')!r} != {BASELINE_VERSION}")
    out = {}
    for e in data.get("findings", []):
        key = f"{e['rule']}|{e['path']}|{e['message']}"
        out[key] = e
    return out


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    payload = {
        "version": BASELINE_VERSION,
        "findings": [{"rule": f.rule, "path": f.path,
                      "message": f.message}
                     for f in sorted(findings,
                                     key=lambda f: (f.path, f.rule,
                                                    f.message))],
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


# -------------------------------------------------------------- driver
@dataclasses.dataclass
class LintReport:
    """The result of one lint run. ``findings`` are the live (non-
    baselined, non-suppressed) violations — rc 1 when any exist."""

    root: str
    findings: List[Finding]
    baselined: List[Finding]
    suppressed: List[Finding]
    errors: List[Finding]          # unparsable files (always live)
    files_checked: int

    @property
    def exit_code(self) -> int:
        return 1 if (self.findings or self.errors) else 0

    def as_dict(self) -> Dict:
        return {
            "version": REPORT_VERSION,
            "root": self.root,
            "files_checked": self.files_checked,
            "findings": [f.as_dict() for f in self.findings],
            "errors": [f.as_dict() for f in self.errors],
            "counts": {
                "findings": len(self.findings),
                "baselined": len(self.baselined),
                "suppressed": len(self.suppressed),
                "errors": len(self.errors),
            },
        }

    def render(self) -> str:
        lines = []
        for f in self.errors + self.findings:
            lines.append(f.render())
        lines.append(
            f"tpu-lint: {self.files_checked} file(s), "
            f"{len(self.findings)} finding(s), "
            f"{len(self.baselined)} baselined, "
            f"{len(self.suppressed)} suppressed, "
            f"{len(self.errors)} parse error(s)")
        return "\n".join(lines)


def iter_py_files(paths: Sequence[str], root: str) -> List[str]:
    out: List[str] = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(full):
            out.append(full)
        elif os.path.isdir(full):
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in _SKIP_DIRS)
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
    return out


def _read_source(path: str) -> str:
    # tokenize.open honors PEP-263 coding cookies, like the compiler
    with tokenize.open(path) as f:
        return f.read()


def run_lint(paths: Optional[Sequence[str]] = None,
             root: Optional[str] = None,
             rules: Optional[Sequence[Rule]] = None,
             baseline_path: Optional[str] = None) -> LintReport:
    """Lint ``paths`` (default: the repo surface ``DEFAULT_PATHS``)
    under ``root`` (default: cwd) with ``rules`` (default: the full
    TPU001–TPU006 pack) against ``baseline_path``."""
    from dgl_operator_tpu_torch.analysis.rules import RULES
    root = os.path.abspath(root or os.getcwd())
    rules = list(rules if rules is not None else RULES)
    files = iter_py_files(paths or DEFAULT_PATHS, root)
    baseline = load_baseline(baseline_path)
    live: List[Finding] = []
    baselined: List[Finding] = []
    suppressed: List[Finding] = []
    errors: List[Finding] = []
    for path in files:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            source = _read_source(path)
            tree = ast.parse(source, filename=path)
        except (SyntaxError, ValueError, OSError) as exc:
            errors.append(Finding(
                "TPU000", rel, getattr(exc, "lineno", 0) or 0, 0,
                f"unparsable file: {exc}"))
            continue
        ctx = ModuleContext(path, rel, source, tree, root)
        supp = suppressed_lines(source)
        for rule in rules:
            for f in rule.check(ctx):
                if is_suppressed(f, supp):
                    suppressed.append(f)
                elif f.key() in baseline:
                    baselined.append(f)
                else:
                    live.append(f)
    live.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintReport(root=root, findings=live, baselined=baselined,
                      suppressed=suppressed, errors=errors,
                      files_checked=len(files))
