"""The rule pack in its torch meaning — each rule encodes one runtime
invariant of the port, and each keeps the code and name of its
counterpart in the JAX package's ``analysis/rules.py``:

- TPU001: JAX's "traced" is the port's "captured": host code in a
  function captured into a CUDA graph (or compiled by ``torch.compile``
  / ``torch.jit.script``) runs once at capture and then disappears from
  every replay (``runtime/graphs.py``).
- TPU002: NCCL and gloo need every rank to issue its collectives in one
  order; a collective issued from a racing thread hangs the group, the
  same hazard as the JAX rendezvous.
- TPU003: torch has no donation; its counterpart is a tensor lent to an
  asynchronous collective, which the caller must not read until the
  handle is waited on.
- TPU004–TPU006 keep their meaning over the port's own registry, fabric
  and key catalogue.

All rules are AST-level and intentionally conservative: they resolve
import aliases (``np`` → ``numpy``), module-local names and a
``self.<method>`` of the enclosing class, but never chase imports
across files. Suppress a deliberate exception with
``# tpu-lint: disable=<RULE>`` on the flagged line.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from dgl_operator_tpu_torch.analysis.core import Finding, ModuleContext, Rule

# ---------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------

#: call targets whose first argument runs inside a captured CUDA graph
#: (``runtime/graphs.py``: the device sampler's step, a K-step call)
_CAPTURE_CALLS = ("DeviceRun", "GraphedCall")

#: calls and decorators that compile their function argument once
_COMPILE_QUALNAMES = ("torch.compile", "torch.jit.script")

#: ``torch.distributed`` collectives whose issue order matters
_DIST_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                     "reduce_scatter_tensor", "all_to_all_single",
                     "broadcast", "send", "recv", "isend", "irecv",
                     "batch_isend_irecv", "barrier"}

#: this port's collective wrappers (parallel/halo.py, collectives.py,
#: ring.py, dp.py)
_PORT_COLLECTIVES = {
    "alltoall_serve_rows", "alltoall_request_rows", "request_rows_start",
    "allreduce_host", "host_gather_rows", "broadcast_params", "barrier",
    "reduce_scatter_sum", "all_gather_flat", "send_recv",
    "ring_shift", "ring_lookup", "ring_push_adagrad",
    "param_allgather_start"}

#: point-to-point calls that are asynchronous whatever their keywords
_ALWAYS_ASYNC = {"isend", "irecv"}

#: the suffixes that end an async pair begun by ``<x>_start``
_END_SUFFIXES = ("_done", "_finish")

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")


def _terminal(qn: Optional[str]) -> Optional[str]:
    return qn.rsplit(".", 1)[-1] if qn else None


def _attr_chain(func: ast.AST) -> Tuple[List[str], Optional[str]]:
    """(attribute names outermost-first, base Name id or None) for a
    call target — handles call-rooted chains like
    ``get_obs().metrics.counter`` where qualname() gives up."""
    attrs: List[str] = []
    while isinstance(func, ast.Attribute):
        attrs.append(func.attr)
        func = func.value
    base = func.id if isinstance(func, ast.Name) else None
    return attrs, base


def _is_metric_call(call: ast.Call) -> Optional[str]:
    """Metric-registry family constructor → the metric name literal
    (``obs.metrics.counter("x", ...)``, ``self.metrics.gauge("x")``,
    ``get_obs().metrics.histogram("x", ...)``)."""
    attrs, base = _attr_chain(call.func)
    if not attrs or attrs[0] not in ("counter", "gauge", "histogram"):
        return None
    if not ((len(attrs) > 1 and attrs[1] == "metrics")
            or base == "metrics"):
        return None
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def _event_names(call: ast.Call) -> List[str]:
    """Event names this call emits: ``<...>.events.emit("x", ...)``
    and any ``event="x"`` keyword on a ``.log``/``.emit`` call (the
    drivers bind ``ev = get_obs().events`` first, so the keyword is the
    reliable signal there)."""
    out: List[str] = []
    attrs, base = _attr_chain(call.func)
    if attrs and attrs[0] == "emit" and (base == "events"
                                         or "events" in attrs[1:]):
        if call.args and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            out.append(call.args[0].value)
    if attrs and attrs[0] in ("log", "emit"):
        for kw in call.keywords:
            if kw.arg == "event" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                out.append(kw.value.value)
    return out


def _is_obs_emit(ctx: ModuleContext, call: ast.Call) -> bool:
    """Any telemetry emission (metric constructor, event log/emit,
    tracer span, get_obs attach) — the host-side I/O family TPU001
    bans inside captured functions."""
    if _is_metric_call(call) is not None or _event_names(call):
        return True
    qn = ctx.call_qualname(call)
    if qn and (qn == "get_obs" or qn.endswith(".get_obs")):
        return True
    attrs, base = _attr_chain(call.func)
    if attrs and attrs[0] in ("log", "emit", "console_line") \
            and (base == "events" or "events" in attrs[1:]):
        return True
    if attrs and attrs[0] in ("span", "complete") \
            and (base == "tracer" or "tracer" in attrs[1:]):
        return True
    return False


def _owner_classes(ctx: ModuleContext) -> Dict[int, ast.ClassDef]:
    """id(node) → its innermost enclosing class (ast.walk is breadth
    first, so an inner class's pass overwrites its outer one's); built
    once per module, on first use."""
    out = getattr(ctx, "_owner_classes", None)
    if out is None:
        out = {}
        for cls in ast.walk(ctx.tree):
            if isinstance(cls, ast.ClassDef):
                for node in ast.walk(cls):
                    out[id(node)] = cls
        ctx._owner_classes = out
    return out


def _self_method(ctx: ModuleContext, node: ast.AST) -> List[ast.AST]:
    """``self.<name>`` at ``node`` → the enclosing class's methods of
    that name (a bound method is passed as ``self.step`` where a JAX
    caller passes a module function)."""
    if not (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return []
    cls = _owner_classes(ctx).get(id(node))
    if cls is None:
        return []
    return [f for f in cls.body
            if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
            and f.name == node.attr]


def _lambda_or_defs(ctx: ModuleContext, node: ast.AST) -> List[ast.AST]:
    """Resolve a callable expression to its function bodies: a Lambda
    is itself; a Name resolves to every same-named module-level or
    nested def (over-approximation — rules accept it); ``self.<name>``
    resolves to the enclosing class's method."""
    if isinstance(node, ast.Lambda):
        return [node]
    if isinstance(node, ast.Name):
        return list(ctx.functions.get(node.id, ()))
    return _self_method(ctx, node)


def _enclosing_functions(tree: ast.AST) -> List[ast.AST]:
    """Every function scope plus the module itself — the bodies rules
    scan for sequential patterns."""
    out: List[ast.AST] = [tree]
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            out.append(node)
    return out


def _scope_walk(scope: ast.AST):
    """Walk one scope's own statements WITHOUT descending into nested
    function definitions — the scope-precise counterpart of ast.walk
    for rules that reason about local name bindings."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _bound_names(targets: Sequence[ast.AST]) -> Set[str]:
    """Names an assignment binds, tuple targets unpacked."""
    out: Set[str] = set()
    for t in targets:
        if isinstance(t, ast.Name):
            out.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            out |= {e.id for e in t.elts if isinstance(e, ast.Name)}
    return out


def _keyword_is(call: ast.Call, name: str, value) -> bool:
    return any(kw.arg == name and isinstance(kw.value, ast.Constant)
               and kw.value.value is value for kw in call.keywords)


# ---------------------------------------------------------------------
# TPU001 — capture purity
# ---------------------------------------------------------------------
class JitPurityRule(Rule):
    code = "TPU001"
    name = "jit-purity"
    doc = ("Functions captured into a CUDA graph (the first argument of "
           "DeviceRun / GraphedCall, the body of a torch.cuda.graph "
           "block, the callables of torch.cuda.make_graphed_callables) "
           "or compiled by torch.compile / torch.jit.script must be "
           "pure: host clocks (time.*), global-RNG draws (random.* / "
           "numpy.random.*), print, and obs emission run ONCE at "
           "capture, then silently disappear from every replay — the "
           "bit-identical K-step and deterministic-trajectory contracts "
           "(runtime/graphs.py) die without a test failing.")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        seen: Set[Tuple[int, int]] = set()
        for fname, body in self._captured_bodies(ctx):
            for node in ast.walk(body):
                if not isinstance(node, ast.Call):
                    continue
                msg = self._impurity(ctx, node)
                if msg is None:
                    continue
                loc = (node.lineno, node.col_offset)
                if loc in seen:
                    continue
                seen.add(loc)
                yield self.finding(
                    ctx, node,
                    f"{msg} inside captured function '{fname}' — runs "
                    "once at capture (CUDA graph / torch.compile), not "
                    "per replay")

    def _impurity(self, ctx: ModuleContext,
                  call: ast.Call) -> Optional[str]:
        qn = ctx.call_qualname(call)
        if qn == "print":
            return "print()"
        if qn:
            if qn.startswith("time."):
                return f"host clock/sleep '{qn}'"
            if qn.startswith("random."):
                return f"global-RNG call '{qn}'"
            if qn.startswith("numpy.random."):
                return f"numpy module-RNG call '{qn}'"
        if _is_obs_emit(ctx, call):
            return "obs telemetry emission"
        return None

    def _captured_bodies(self, ctx: ModuleContext
                         ) -> List[Tuple[str, ast.AST]]:
        out: List[Tuple[str, ast.AST]] = []

        def add(fns: Iterable[ast.AST]) -> None:
            out.extend((getattr(f, "name", "<lambda>"), f) for f in fns)

        # decorated defs: @torch.compile / @torch.compile(...) /
        # @partial(torch.compile, ...) / @torch.jit.script
        for defs in ctx.functions.values():
            for fn in defs:
                if any(self._is_compile_deco(ctx, d)
                       for d in getattr(fn, "decorator_list", ())):
                    add([fn])
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                # with torch.cuda.graph(g, ...): the block is captured
                if any(isinstance(it.context_expr, ast.Call)
                       and ctx.call_qualname(it.context_expr)
                       == "torch.cuda.graph" for it in node.items):
                    block = ast.Module(body=node.body, type_ignores=[])
                    out.append(("torch.cuda.graph block", block))
                continue
            if not isinstance(node, ast.Call) or not node.args:
                continue
            qn = ctx.call_qualname(node)
            first = node.args[0]
            if _terminal(qn) in _CAPTURE_CALLS \
                    or qn in _COMPILE_QUALNAMES:
                add(_lambda_or_defs(ctx, first))
            elif qn == "torch.cuda.make_graphed_callables":
                elts = (first.elts if isinstance(first, (ast.Tuple,
                                                         ast.List))
                        else [first])
                for e in elts:
                    add(_lambda_or_defs(ctx, e))
        return out

    @staticmethod
    def _is_compile_deco(ctx: ModuleContext, deco: ast.AST) -> bool:
        if ctx.qualname(deco) in _COMPILE_QUALNAMES:
            return True
        if isinstance(deco, ast.Call):
            fqn = ctx.call_qualname(deco)
            if fqn in _COMPILE_QUALNAMES:
                return True     # @torch.compile(mode=...)
            if fqn and _terminal(fqn) == "partial" and deco.args:
                return ctx.qualname(deco.args[0]) in _COMPILE_QUALNAMES
        return False


# ---------------------------------------------------------------------
# TPU002 — threaded collective dispatch
# ---------------------------------------------------------------------
class ThreadedCollectiveRule(Rule):
    code = "TPU002"
    name = "threaded-collective-dispatch"
    doc = ("Collectives (torch.distributed's all_reduce / all_gather / "
           "all_to_all_single / reduce_scatter_tensor / broadcast / "
           "send / recv / barrier ..., or this port's wrappers in "
           "parallel/halo.py, collectives.py, ring.py and dp.py) must "
           "be issued from ONE thread in ONE deterministic order: NCCL "
           "and gloo match every rank's calls by their order, so a "
           "collective issued from a racing host thread can pair with "
           "the wrong call on another rank and hang the whole group. "
           "Thread targets and executor submissions must therefore "
           "never issue them. The async pair has its own hazard: a "
           "'*_start' whose matching '*_done' / '*_finish' consumes "
           "the handle with NO intervening compute pins the wait right "
           "next to the issue — the collective serializes against the "
           "step's work and the overlap the pair exists for is "
           "defeated (parallel/halo.request_rows_start/finish, "
           "parallel/dp.param_allgather_start/done).")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        yield from self._check_start_done(ctx)
        hazardous = self._hazardous_names(ctx)
        if not hazardous and not self._has_collectives(ctx):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            target = self._thread_target(ctx, node)
            if target is None:
                continue
            name = self._hazard_of(ctx, target, hazardous)
            if name:
                yield self.finding(
                    ctx, node,
                    f"'{name}' issues collectives but is launched from "
                    "a thread (threading.Thread target / executor "
                    "submit) — a racing issue order hangs the process "
                    "group (NCCL/gloo match calls by order); issue it "
                    "from the loop thread")

    # -- async start/done adjacency ----------------------------------
    def _check_start_done(self, ctx: ModuleContext
                          ) -> Iterable[Finding]:
        """Flag ``h = <x>_start(...)`` immediately followed by a
        statement consuming ``h`` in the matching ``<x>_done`` or
        ``<x>_finish`` — the end scheduled right behind the start
        leaves no compute for the collective to hide under."""
        for stmts in self._stmt_lists(ctx.tree):
            for prev, nxt in zip(stmts, stmts[1:]):
                if not (isinstance(prev, ast.Assign)
                        and isinstance(prev.value, ast.Call)):
                    continue
                sterm = _terminal(ctx.call_qualname(prev.value)) or ""
                if not sterm.endswith("_start"):
                    continue
                handles = _bound_names(prev.targets)
                if not handles:
                    continue
                for call in ast.walk(nxt):
                    if not isinstance(call, ast.Call):
                        continue
                    dterm = _terminal(ctx.call_qualname(call)) or ""
                    if not any(dterm.endswith(s)
                               and dterm[:-len(s)] == sterm[:-6]
                               for s in _END_SUFFIXES):
                        continue
                    if any(isinstance(a, ast.Name) and a.id in handles
                           for a in call.args):
                        yield self.finding(
                            ctx, call,
                            f"'{dterm}' consumes the '{sterm}' handle "
                            "with no intervening compute — the wait "
                            "lands right next to the start, so the "
                            "collective serializes against the step "
                            "instead of running under it; move the "
                            "wait after the compute it should hide "
                            "under")

    @staticmethod
    def _stmt_lists(tree: ast.AST) -> Iterable[list]:
        for node in ast.walk(tree):
            for field in ("body", "orelse", "finalbody"):
                stmts = getattr(node, field, None)
                if isinstance(stmts, list) and len(stmts) > 1:
                    yield stmts

    # -- hazard set --------------------------------------------------
    def _hazardous_names(self, ctx: ModuleContext) -> Set[str]:
        """Module-local names that (transitively) issue a collective:
        names bound to a collective (``fn = dist.all_reduce``,
        ``fn = partial(alltoall_request_rows, ...)``), plus functions
        whose bodies call collectives or other hazardous names."""
        hazard: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) \
                    and self._is_collective_ref(ctx, node.value):
                hazard |= {t.id for t in node.targets
                           if isinstance(t, ast.Name)}
        changed = True
        while changed:
            changed = False
            for fname, defs in ctx.functions.items():
                if fname in hazard:
                    continue
                for fn in defs:
                    if self._body_dispatches(ctx, fn, hazard):
                        hazard.add(fname)
                        changed = True
                        break
        return hazard

    def _is_collective_ref(self, ctx: ModuleContext,
                           value: ast.AST) -> bool:
        """A collective named without being called, or bound into a
        ``functools.partial``."""
        if isinstance(value, ast.Call) and value.args \
                and _terminal(ctx.call_qualname(value)) == "partial":
            value = value.args[0]
        if not isinstance(value, (ast.Name, ast.Attribute)):
            return False
        return self._is_collective_qualname(ctx.qualname(value))

    @staticmethod
    def _is_collective_qualname(qn: Optional[str]) -> bool:
        term = _terminal(qn)
        if term in _PORT_COLLECTIVES:
            return True
        return bool(qn and qn.startswith("torch.distributed.")
                    and term in _DIST_COLLECTIVES)

    def _body_dispatches(self, ctx: ModuleContext, fn: ast.AST,
                         hazard: Set[str]) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and self._is_collective_call(ctx, node, hazard):
                return True
        return False

    def _is_collective_call(self, ctx: ModuleContext, call: ast.Call,
                            hazard: Set[str]) -> bool:
        if self._is_collective_qualname(ctx.call_qualname(call)):
            return True
        return isinstance(call.func, ast.Name) \
            and call.func.id in hazard

    def _has_collectives(self, ctx: ModuleContext) -> bool:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) \
                    and self._is_collective_call(ctx, node, set()):
                return True
        return False

    # -- thread-launch sites -----------------------------------------
    def _thread_target(self, ctx: ModuleContext,
                       call: ast.Call) -> Optional[ast.AST]:
        term = _terminal(ctx.call_qualname(call))
        if term == "Thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    return kw.value
            if call.args:          # Thread(group, target) is exotic;
                return None        # keyword form is the convention
        attrs, _ = _attr_chain(call.func)
        if attrs and attrs[0] == "submit" and call.args:
            return call.args[0]
        return None

    def _hazard_of(self, ctx: ModuleContext, target: ast.AST,
                   hazard: Set[str]) -> Optional[str]:
        if isinstance(target, ast.Name) and target.id in hazard:
            return target.id
        if isinstance(target, (ast.Name, ast.Attribute)):
            qn = ctx.qualname(target)
            if self._is_collective_qualname(qn):
                return qn
            # self.<method>: the enclosing class's method of that name
            for fn in _self_method(ctx, target):
                if self._body_dispatches(ctx, fn, hazard):
                    return f"self.{fn.name}"
            return None
        if isinstance(target, ast.Lambda):
            for node in ast.walk(target):
                if isinstance(node, ast.Call) \
                        and self._is_collective_call(ctx, node, hazard):
                    return ctx.call_qualname(node) or "<lambda>"
        return None


# ---------------------------------------------------------------------
# TPU003 — a buffer read while it is lent to an async collective
# ---------------------------------------------------------------------
class DonationAfterUseRule(Rule):
    code = "TPU003"
    name = "donation-after-use"
    doc = ("Torch has no buffer donation; its counterpart is a tensor "
           "lent to an asynchronous collective (a torch.distributed "
           "call with async_op=True, isend / irecv, or this port's "
           "'*_start' wrappers such as parallel/halo."
           "request_rows_start and parallel/dp.param_allgather_start). "
           "Until the handle's .wait() / '*_done' / '*_finish', NCCL "
           "reads and writes that buffer on its own stream: reading it "
           "meanwhile sees a half-reduced or half-received tensor, and "
           "writing it corrupts what the other ranks get. Read it "
           "after the wait, or pass async_op=False.")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for scope in _enclosing_functions(ctx.tree):
            yield from self._check_scope(ctx, scope)

    def _lending(self, ctx: ModuleContext,
                 call: ast.Call) -> Optional[str]:
        """The callee's name when ``call`` lends its arguments to an
        asynchronous collective, else None."""
        if _keyword_is(call, "async_op", False):
            return None
        qn = ctx.call_qualname(call)
        term = _terminal(qn) or ""
        if _keyword_is(call, "async_op", True) \
                or term.endswith("_start"):
            return term
        if qn and qn.startswith("torch.distributed.") \
                and term in _ALWAYS_ASYNC:
            return term
        return None

    def _check_scope(self, ctx: ModuleContext,
                     scope: ast.AST) -> Iterable[Finding]:
        for stmt in _scope_walk(scope):
            if not isinstance(stmt, (ast.Assign, ast.Expr,
                                     ast.AnnAssign)):
                continue
            call = stmt.value
            if not isinstance(call, ast.Call):
                continue
            callee = self._lending(ctx, call)
            if callee is None:
                continue
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target] if isinstance(stmt, ast.AnnAssign)
                       else [])
            handles = _bound_names(targets)
            end = getattr(stmt, "end_lineno", stmt.lineno)
            until = self._wait_line(ctx, scope, handles, end)
            for name in dict.fromkeys(
                    a.id for a in call.args if isinstance(a, ast.Name)):
                if name in handles:
                    continue
                use = self._read_between(scope, name, end, until)
                if use is not None:
                    yield self.finding(
                        ctx, use,
                        f"lent argument '{name}' is read while the "
                        f"async '{callee}' at line {call.lineno} may "
                        "still be using it — wait on its handle "
                        "(.wait() / *_done / *_finish) first, or pass "
                        "async_op=False")

    @staticmethod
    def _wait_line(ctx: ModuleContext, scope: ast.AST, handles: Set[str],
                   after_line: int) -> Optional[int]:
        """The first line after ``after_line`` that waits on one of
        ``handles`` (``h.wait()``, or a ``*_done`` / ``*_finish`` call
        taking it); None when the scope never waits."""
        best: Optional[int] = None
        for node in _scope_walk(scope):
            if not isinstance(node, ast.Call) \
                    or node.lineno <= after_line:
                continue
            f = node.func
            waits = (isinstance(f, ast.Attribute) and f.attr == "wait"
                     and isinstance(f.value, ast.Name)
                     and f.value.id in handles)
            if not waits:
                term = _terminal(ctx.call_qualname(node)) or ""
                waits = term.endswith(_END_SUFFIXES) and any(
                    isinstance(a, ast.Name) and a.id in handles
                    for a in node.args)
            if waits and (best is None or node.lineno < best):
                best = node.lineno
        return best

    @staticmethod
    def _read_between(scope: ast.AST, name: str, after_line: int,
                      until: Optional[int]) -> Optional[ast.AST]:
        best: Optional[ast.AST] = None
        for node in _scope_walk(scope):
            if isinstance(node, ast.Name) and node.id == name \
                    and isinstance(node.ctx, ast.Load) \
                    and node.lineno > after_line \
                    and (until is None or node.lineno < until):
                if best is None or node.lineno < best.lineno:
                    best = node
        return best


# ---------------------------------------------------------------------
# TPU004 — knob-registry bypass
# ---------------------------------------------------------------------
def _registry_knob_names() -> frozenset:
    try:
        from dgl_operator_tpu_torch.autotune.knobs import REGISTRY
        return frozenset(REGISTRY)
    except Exception:  # pragma: no cover — registry import must not
        # take the linter down; the frozen mirror keeps the rule alive
        return frozenset((
            "sampler", "feats_layout", "feat_dtype", "halo_cache_frac",
            "num_samplers", "prefetch", "steps_per_call", "donate",
            "resume", "cap_policy", "shard_rules", "neg_sampler",
            "num_client", "part_method", "refine_iters"))


class KnobRegistryBypassRule(Rule):
    code = "TPU004"
    name = "knob-registry-bypass"
    doc = ("autotune/knobs.py REGISTRY is the single validation "
           "source for every tunable: an inline "
           "``if knob not in (...): raise ValueError`` re-spells the "
           "legal range in a second place, so the registry, the "
           "search grid, and the consumer drift apart and a tuned "
           "manifest can pass the driver yet explode in a trainer. "
           "Delegate to knobs.validate(name, value) instead.")

    #: the registry module itself implements the checks
    _EXEMPT_SUFFIXES = ("autotune/knobs.py",)

    def __init__(self, knob_names: Optional[frozenset] = None):
        self._knobs = knob_names or _registry_knob_names()

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if ctx.relpath.endswith(self._EXEMPT_SUFFIXES):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.If):
                continue
            knob = self._range_checked_knob(node.test)
            if knob is None:
                continue
            for stmt in ast.walk(node):
                if isinstance(stmt, ast.Raise) \
                        and self._raises_value_error(ctx, stmt):
                    yield self.finding(
                        ctx, stmt,
                        f"inline range/choice validation of knob "
                        f"'{knob}' raises ValueError directly — "
                        "delegate to dgl_operator_tpu_torch.autotune."
                        f"knobs.validate('{knob}', ...) so the "
                        "registry stays the single source of truth")
                    break

    @staticmethod
    def _raises_value_error(ctx: ModuleContext, node: ast.Raise) -> bool:
        exc = node.exc
        if isinstance(exc, ast.Call):
            exc = exc.func
        qn = ctx.qualname(exc) if exc is not None else None
        return qn == "ValueError"

    # -- condition classification ------------------------------------
    def _range_checked_knob(self, test: ast.AST) -> Optional[str]:
        """The knob name when ``test`` is a pure range/choice check
        over exactly one knob-named expression, else None."""
        names = self._compare_names(test)
        if names is None or len(names) != 1:
            return None
        name = next(iter(names))
        return name if name in self._knobs else None

    def _compare_names(self, test: ast.AST) -> Optional[Set[str]]:
        """Terminal names compared against constants in ``test``;
        None when the test is not purely made of such comparisons
        (composition checks like ``K > 1 and not device_mode`` stay
        out of scope — the registry cannot express them)."""
        if isinstance(test, ast.UnaryOp) \
                and isinstance(test.op, ast.Not):
            return self._compare_names(test.operand)
        if isinstance(test, ast.BoolOp):
            out: Set[str] = set()
            for v in test.values:
                sub = self._compare_names(v)
                if sub is None:
                    return None
                out |= sub
            return out
        if isinstance(test, ast.Compare):
            names: Set[str] = set()
            for expr in (test.left, *test.comparators):
                t = self._terminal_name(expr)
                if t is not None:
                    names.add(t)
                elif not self._is_constant_ish(expr):
                    return None
            return names or None
        return None

    @staticmethod
    def _terminal_name(expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Attribute):
            return expr.attr
        if isinstance(expr, ast.Name):
            return expr.id
        return None

    @classmethod
    def _is_constant_ish(cls, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Constant):
            return True
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return all(cls._is_constant_ish(e) for e in expr.elts)
        if isinstance(expr, ast.UnaryOp):
            return cls._is_constant_ish(expr.operand)
        return False


# ---------------------------------------------------------------------
# TPU005 — naked subprocess
# ---------------------------------------------------------------------
class NakedSubprocessRule(Rule):
    code = "TPU005"
    name = "naked-subprocess"
    doc = ("Every subprocess outside the exec fabric must carry a "
           "timeout: a hung remote verb wedges whole jobs, which is "
           "why TPU_OPERATOR_EXEC_TIMEOUT_S bounds the fabric's — a "
           "bare subprocess.run in a driver, bench, or controller has "
           "the same failure mode with none of the retry layer's "
           "protection. launcher/fabric.py itself is exempt (it IS "
           "the timeout policy owner). Popen is accepted when the "
           "enclosing function demonstrably bounds it "
           "(communicate/wait with timeout, or a kill/terminate "
           "watchdog).")

    _EXEMPT_SUFFIXES = ("dgl_operator_tpu_torch/launcher/fabric.py",)
    _WRAPPED = ("run", "call", "check_call", "check_output")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if ctx.relpath.endswith(self._EXEMPT_SUFFIXES):
            return
        # innermost enclosing scope per Popen site: module last so a
        # function-local Popen is judged against ITS function's
        # watchdogs, not the whole module's
        scopes = [s for s in _enclosing_functions(ctx.tree)
                  if s is not ctx.tree] + [ctx.tree]
        seen: Set[Tuple[int, int]] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = ctx.call_qualname(node)
            if not qn or not qn.startswith("subprocess."):
                continue
            loc = (node.lineno, node.col_offset)
            if loc in seen:
                continue
            seen.add(loc)
            term = _terminal(qn)
            if term in self._WRAPPED:
                if not self._has_timeout(node):
                    yield self.finding(
                        ctx, node,
                        f"subprocess.{term} without timeout= — a "
                        "hung child wedges this process forever; "
                        "pass an explicit timeout (see launcher/"
                        "fabric.py TPU_OPERATOR_EXEC_TIMEOUT_S)")
            elif term == "Popen":
                scope = next(s for s in scopes
                             if any(n is node for n in ast.walk(s)))
                if not self._scope_bounds_popen(scope):
                    yield self.finding(
                        ctx, node,
                        "subprocess.Popen with no visible bound in "
                        "this function (no communicate/"
                        "wait(timeout=...) and no kill/terminate "
                        "watchdog) — a silent child pins the process")

    @staticmethod
    def _has_timeout(call: ast.Call) -> bool:
        for kw in call.keywords:
            if kw.arg == "timeout":
                return True
            if kw.arg is None:     # **kwargs may carry it — trust it
                return True
        return False

    @staticmethod
    def _scope_bounds_popen(scope: ast.AST) -> bool:
        for node in ast.walk(scope):
            if not isinstance(node, ast.Call):
                continue
            if not isinstance(node.func, ast.Attribute):
                continue
            attr = node.func.attr
            if attr in ("kill", "terminate"):
                return True
            if attr in ("communicate", "wait"):
                if any(kw.arg == "timeout" for kw in node.keywords) \
                        or node.args:
                    return True
        return False


# ---------------------------------------------------------------------
# TPU006 — pinned-key drift
# ---------------------------------------------------------------------
class PinnedKeyDriftRule(Rule):
    code = "TPU006"
    name = "pinned-key-drift"
    doc = ("The benchmark record keys (_SCALE_FULL_KEYS / "
           "_SCALING_KEYS / _TUNE_KEYS / _SERVE_KEYS) and every obs "
           "metric/event name are consumer contracts: renames strand "
           "the harnesses and dashboards that read the records. "
           "The key tuples live ONCE in dgl_operator_tpu_torch/"
           "benchkeys.py (everything else aliases them), and every "
           "telemetry name emitted in code must appear in the docs "
           "catalogue (docs/*.md backticked names, primarily "
           "docs/observability.md).")

    _PINNED = ("_SCALE_FULL_KEYS", "_SCALING_KEYS", "_TUNE_KEYS",
               "_SERVE_KEYS")
    _CANONICAL = "dgl_operator_tpu_torch/benchkeys.py"
    _doc_cache: Dict[str, Optional[frozenset]] = {}

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        yield from self._check_pinned_lists(ctx)
        yield from self._check_telemetry_names(ctx)

    # -- (a) one source of truth for the pinned tuples ----------------
    def _check_pinned_lists(self, ctx: ModuleContext
                            ) -> Iterable[Finding]:
        if ctx.relpath == self._CANONICAL \
                or ctx.relpath.endswith("/" + self._CANONICAL):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if not (isinstance(t, ast.Name)
                        and t.id in self._PINNED):
                    continue
                if isinstance(node.value, (ast.Tuple, ast.List,
                                           ast.Set)):
                    yield self.finding(
                        ctx, node,
                        f"'{t.id}' re-defines a pinned key list as a "
                        "literal — import it from dgl_operator_tpu_torch."
                        "benchkeys (the single source of truth) so "
                        "the copies cannot drift")

    # -- (b) telemetry names must be catalogued -----------------------
    def _check_telemetry_names(self, ctx: ModuleContext
                               ) -> Iterable[Finding]:
        catalogue = self._doc_names(ctx.root)
        if catalogue is None:       # no docs/ tree — nothing to check
            return
        reported: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            names = []
            metric = _is_metric_call(node)
            if metric:
                names.append(("metric", metric, node))
            for ev in _event_names(node):
                names.append(("event", ev, node))
            for kind, name, site in names:
                if not _NAME_RE.match(name) or name in reported:
                    continue
                if name not in catalogue:
                    reported.add(name)
                    yield self.finding(
                        ctx, site,
                        f"{kind} name '{name}' is emitted here but "
                        "absent from the docs catalogue — add it to "
                        "docs/observability.md (or the owning "
                        "docs/*.md page) so operators can find it")

    @classmethod
    def _doc_names(cls, root: str) -> Optional[frozenset]:
        if root in cls._doc_cache:
            return cls._doc_cache[root]
        docs_dir = os.path.join(root, "docs")
        names: Set[str] = set()
        if not os.path.isdir(docs_dir):
            cls._doc_cache[root] = None
            return None
        for dirpath, _, filenames in os.walk(docs_dir):
            for fn in filenames:
                if not fn.endswith(".md"):
                    continue
                try:
                    with open(os.path.join(dirpath, fn),
                              encoding="utf-8") as f:
                        text = f.read()
                except OSError:
                    continue
                for tick in re.findall(r"`([^`]+)`", text):
                    for tok in re.findall(r"[a-z][a-z0-9_]*", tick):
                        names.add(tok)
        out = frozenset(names)
        cls._doc_cache[root] = out
        return out


# ---------------------------------------------------------------------
RULES: Sequence[Rule] = (
    JitPurityRule(),
    ThreadedCollectiveRule(),
    DonationAfterUseRule(),
    KnobRegistryBypassRule(),
    NakedSubprocessRule(),
    PinnedKeyDriftRule(),
)


def rule_by_code(code: str) -> Rule:
    for r in RULES:
        if r.code == code:
            return r
    raise KeyError(f"unknown rule {code!r}; known: "
                   f"{', '.join(r.code for r in RULES)}")
