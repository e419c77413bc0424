"""The chaos plan — deterministic, seeded fault injection.

The port's own copy of the JAX package's ``launcher/chaos.py``:
``TPU_OPERATOR_CHAOS`` names a *fault plan*, and each plane of the
port that owns a fault reads its rule from the process's plan
(:func:`proc_plan`).

Plan grammar — ``;``-separated directives, each
``<verb>:<action>:<value>[@host=<name>]``:

    seed=<n>              jitter/flakiness RNG seed (default 0)
    exec:fail:<n>         fabric rules: fail the first n exec calls
    exec:timeout:<n>      (or time them out), the first n copy calls,
    copy:fail:<n>         any call, each call with probability p, or
    any:fail:<n>          sleep s seconds before each call. They parse
    exec:flaky:<p>        (flakiness drawn from the plan's seeded RNG).
    copy:flaky:<p>        ``get_fabric`` wraps the environment's plan
    exec:delay:<s>        in a :class:`ChaosFabric`, which calls
                          :meth:`ChaosPlan.before` ahead of every verb;
                          an injected fault is transient, so the retry
                          layer (``launcher/retry.py``) absorbs it
    train:kill:<step>     the training loops deliver a real SIGTERM to
                          themselves at global step <step>
                          (runtime/loop.py ``PreemptionGuard``): the
                          stand-in for a preemption
    host:die:<step>       the trainer on the matching host records its
                          death (a ``host_died`` event and a marker
                          under ``<workspace>/.chaos_dead/``) and
                          hard-exits with :data:`HOST_DIED_EXIT` at
                          step <step>, flushing nothing
    ckpt:corrupt:<step>   the first checkpoint published at global step
                          >= <step> has its npz bytes stomped after the
                          publish, the sha256 sidecar keeping the true
                          digest, so a restore must fall back past it
                          (runtime/checkpoint.py); fires once
    numerics:nan:<step>   at step <step> the loop poisons a parameter
                          with NaN (obs/quality.py ``NumericsInjector``);
                          fires once per workspace
    replica:die:<n>       the matching serve replica kills its HTTP
                          plane after accepting <n> predict requests
                          (serve/server.py)
    step:slow:<s>         the training loop sleeps <s> seconds at the top
                          of every call, billed to the ``stall`` phase
    promote:bad           the next checkpoint staged for canary
                          promotion is poisoned with NaN after its
                          checksum (runtime/checkpoint.py
                          ``ServingPromotion.stage``); fires once

``@host=<name>`` scopes a rule to one host: a trainer's hostfile name
(:func:`my_host_name`) or a serve replica's name.
"""

from __future__ import annotations

import os
import random
import re
import threading
import time
from typing import List, Optional

from dgl_operator_tpu_torch.launcher.fabric import (Fabric, FabricError,
                                                    FabricHostLost,
                                                    FabricTimeout)
from dgl_operator_tpu_torch.obs import get_obs
from dgl_operator_tpu_torch.parallel.bootstrap import (HOSTFILE_ENV,
                                                       RANK_ENV,
                                                       parse_hostfile)

CHAOS_ENV = "TPU_OPERATOR_CHAOS"
# the workspace root the dead-host markers live under
WORKSPACE_ENV = "TPU_OPERATOR_WORKSPACE"
DEAD_DIR = ".chaos_dead"
# the host:die exit status: distinct from 75 (the Preempted retryable
# exit), since a dead host must not look retryable
HOST_DIED_EXIT = 113

_RULE_RE = re.compile(
    r"^(?P<verb>exec|copy|any|train|host|ckpt|numerics|replica|promote"
    r"|step):"
    r"(?P<action>fail|timeout|"
    r"flaky|delay|kill|die|corrupt|nan|bad|slow)(?::(?P<value>[0-9.]+))?"
    r"(?:@host=(?P<host>[^;@]+))?$")

# each action below is legal only with its listed verbs, and each of
# these verbs accepts only its listed action
_PAIRED_ACTIONS = {"kill": ("train",), "die": ("host", "replica"),
                   "corrupt": ("ckpt",), "nan": ("numerics",),
                   "bad": ("promote",), "slow": ("step",)}
_PAIRED_VERBS = {v: a for a, verbs in _PAIRED_ACTIONS.items()
                 for v in verbs}
# directives whose value is optional (promote:bad is a one-shot latch)
_VALUE_OPTIONAL = ("promote",)


class ChaosPlanError(ValueError):
    pass


class ChaosRule:
    def __init__(self, verb: str, action: str, value: float,
                 host: Optional[str] = None):
        self.verb = verb
        self.action = action
        self.value = value
        self.host = host
        self.fired = False
        # fail/timeout budgets count down; delay/flaky never exhaust
        self.remaining = int(value) if action in ("fail", "timeout") \
            else None

    def matches(self, verb: str, host: str) -> bool:
        """A fabric rule's match of one fabric call."""
        if self.verb not in ("any", verb):
            return False
        return self.host is None or self.host == host

    def _scoped_to(self, host: Optional[str]) -> bool:
        """An unscoped rule matches every host; a scoped one only its
        named host."""
        return self.host is None or (host is not None and self.host == host)

    def __repr__(self):
        at = f"@host={self.host}" if self.host else ""
        return f"{self.verb}:{self.action}:{self.value:g}{at}"


class ChaosPlan:
    """A parsed fault plan. ``injected`` records every fault a plane
    took from it (rule, verb, host)."""

    def __init__(self, rules: List[ChaosRule], seed: int = 0):
        self.rules = rules
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected: List[tuple] = []

    @classmethod
    def parse(cls, spec: str) -> "ChaosPlan":
        rules, seed = [], 0
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            if part.startswith("seed="):
                seed = int(part[len("seed="):])
                continue
            m = _RULE_RE.match(part)
            if not m:
                raise ChaosPlanError(
                    f"bad chaos directive {part!r} (expected "
                    "<verb>:<action>:<value>[@host=<name>] or seed=<n>)")
            verb, action = m["verb"], m["action"]
            want = _PAIRED_VERBS.get(verb)
            if want is not None and action != want:
                raise ChaosPlanError(
                    f"bad chaos directive {part!r}: {want} pairs only "
                    f"with the {'/'.join(_PAIRED_ACTIONS[want])} verb")
            if want is None and action in _PAIRED_ACTIONS:
                raise ChaosPlanError(
                    f"bad chaos directive {part!r}: {action} pairs "
                    "only with the "
                    f"{'/'.join(_PAIRED_ACTIONS[action])} verb")
            if m["value"] is None and verb not in _VALUE_OPTIONAL:
                raise ChaosPlanError(
                    f"bad chaos directive {part!r}: {verb}:{action} "
                    "requires a numeric value")
            rules.append(ChaosRule(verb, action,
                                   float(m["value"] or 0), m["host"]))
        return cls(rules, seed=seed)

    def before(self, verb: str, host: str) -> None:
        """Apply every matching fabric rule to one fabric call: sleep
        the delays (outside the lock, so injected latency does not
        serialize the batch fan-out), then raise the first due fault
        (transient, so the retry layer owns recovery)."""
        delay, fault, fired = 0.0, None, None
        with self._lock:
            for rule in self.rules:
                if rule.verb in ("train", "host", "ckpt", "numerics",
                                 "replica", "promote", "step") \
                        or not rule.matches(verb, host):
                    continue
                if rule.action == "delay":
                    delay += rule.value
                elif rule.action == "flaky":
                    if self._rng.random() < rule.value:
                        self.injected.append((repr(rule), verb, host))
                        fired = rule
                        fault = FabricError(
                            f"chaos: injected flaky {verb} failure on "
                            f"{host} ({rule})", transient=True)
                        break
                elif rule.remaining and rule.remaining > 0:
                    rule.remaining -= 1
                    self.injected.append((repr(rule), verb, host))
                    fired = rule
                    exc_cls = (FabricTimeout if rule.action == "timeout"
                               else FabricError)
                    fault = exc_cls(
                        f"chaos: injected {verb} failure on {host} "
                        f"({rule}, {rule.remaining} left)",
                        transient=True)
                    break
        if delay:
            time.sleep(delay)
        if fault is not None:
            count_fault(verb, fired.action)
            get_obs().emit("chaos_fault", verb=verb, host=host,
                           action=fired.action, rule=repr(fired))
            raise fault

    def _first(self, verb: str, action: str,
               host: Optional[str] = None, scoped: bool = False
               ) -> Optional[ChaosRule]:
        for rule in self.rules:
            if rule.verb == verb and rule.action == action and (
                    not scoped or rule._scoped_to(host)):
                return rule
        return None

    def train_kill_step(self) -> Optional[int]:
        """The step at which a training loop preempts itself
        (``train:kill:<step>``), or None."""
        rule = self._first("train", "kill")
        return None if rule is None else int(rule.value)

    def numerics_nan_step(self) -> Optional[int]:
        """The step at which a training loop poisons a parameter with
        NaN (``numerics:nan:<step>``), or None."""
        rule = self._first("numerics", "nan")
        return None if rule is None else int(rule.value)

    def host_die_step(self, host: Optional[str]) -> Optional[int]:
        """The step at which the trainer on ``host`` hard-dies
        (``host:die:<step>``), or None. A trainer that cannot resolve
        its hostfile name matches unscoped rules only."""
        rule = self._first("host", "die", host, scoped=True)
        return None if rule is None else int(rule.value)

    def step_slow_seconds(self, host: Optional[str]) -> Optional[float]:
        """The drag in seconds a call of the trainer on ``host`` takes
        (``step:slow:<s>``), or None; scoped as :meth:`host_die_step`."""
        rule = self._first("step", "slow", host, scoped=True)
        return None if rule is None else float(rule.value)

    def replica_die_after(self, replica: Optional[str]) -> Optional[int]:
        """The accepted-request count after which the serve replica
        named ``replica`` kills its HTTP plane (``replica:die:<n>``), or
        None; replica names scope as hostfile names do."""
        rule = self._first("replica", "die", replica, scoped=True)
        return None if rule is None else int(rule.value)

    def take_promote_bad(self) -> Optional[ChaosRule]:
        """Consume the ``promote:bad`` rule (fires once); thread-safe."""
        with self._lock:
            for rule in self.rules:
                if rule.verb != "promote" or rule.fired:
                    continue
                rule.fired = True
                self.injected.append((repr(rule), "promote", "?"))
                return rule
        return None

    def take_ckpt_corrupt(self, step: int, host: Optional[str] = None
                          ) -> Optional[ChaosRule]:
        """Consume a due ``ckpt:corrupt:<step>`` rule (fires once, on the
        first checkpoint published at global step >= <step>); thread-safe,
        since the checkpoint writer calls it off the loop thread."""
        with self._lock:
            for rule in self.rules:
                if rule.verb != "ckpt" or rule.fired:
                    continue
                if step < rule.value:
                    continue
                if rule.host is not None and rule.host != host:
                    continue
                rule.fired = True
                self.injected.append((repr(rule), "ckpt", host or "?"))
                return rule
        return None


def plan_from_env(env=None) -> Optional[ChaosPlan]:
    """A fresh plan of ``TPU_OPERATOR_CHAOS`` (fresh budgets), or None."""
    spec = (os.environ if env is None else env).get(CHAOS_ENV)
    return ChaosPlan.parse(spec) if spec else None


# the process's plan for the stateful directives, whose fire-once budget
# every consumer in the process shares; rebuilt when the spec changes
_PROC_PLAN: Optional[tuple] = None
_PROC_LOCK = threading.Lock()


def proc_plan(env=None) -> Optional[ChaosPlan]:
    """The process's plan of ``TPU_OPERATOR_CHAOS``, or None."""
    global _PROC_PLAN
    spec = (os.environ if env is None else env).get(CHAOS_ENV)
    if not spec:
        return None
    with _PROC_LOCK:
        if _PROC_PLAN is None or _PROC_PLAN[0] != spec:
            _PROC_PLAN = (spec, ChaosPlan.parse(spec))
        return _PROC_PLAN[1]


def my_host_name(env=None) -> Optional[str]:
    """The hostfile name this process runs as: the entry at
    ``TPU_OPERATOR_RANK`` of the hostfile at
    ``TPU_OPERATOR_HOSTFILE_PATH``; None when either is missing."""
    env = os.environ if env is None else env
    hf, rank = env.get(HOSTFILE_ENV), env.get(RANK_ENV)
    if not hf or rank in (None, ""):
        return None
    try:
        entries = parse_hostfile(hf)
        i = int(rank)
        return entries[i].name if 0 <= i < len(entries) else None
    except (OSError, ValueError, IndexError):
        return None


# ------------------------------------------------- dead-host registry
def dead_marker_dir(workspace: Optional[str] = None) -> Optional[str]:
    """``<workspace>/.chaos_dead/``: one empty file per dead host."""
    ws = workspace or os.environ.get(WORKSPACE_ENV)
    return os.path.join(ws, DEAD_DIR) if ws else None


def mark_host_dead(host: str, workspace: Optional[str] = None) -> None:
    d = dead_marker_dir(workspace)
    if not d:
        return
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, host), "w") as f:
        f.write(f"pid={os.getpid()}\n")


def dead_hosts(workspace: Optional[str] = None) -> List[str]:
    d = dead_marker_dir(workspace)
    if not d or not os.path.isdir(d):
        return []
    try:
        return sorted(os.listdir(d))
    except OSError:
        return []


def readmit_host(host: str, workspace: Optional[str] = None) -> bool:
    """Clear a host's dead marker; returns whether one was removed."""
    d = dead_marker_dir(workspace)
    if not d:
        return False
    try:
        os.remove(os.path.join(d, host))
        return True
    except OSError:
        return False


def count_fault(verb: str, action: str, **event) -> None:
    """Count one delivered fault in ``chaos_faults_injected_total
    {verb, action}`` and record a ``chaos_<verb>_<action>`` event."""
    obs = get_obs()
    obs.metrics.counter(
        "chaos_faults_injected_total",
        "faults the chaos plan actually delivered",
        labels=("verb", "action")).inc(verb=verb, action=action)
    obs.emit(f"chaos_{verb}_{action}", **event)


class ChaosFabric(Fabric):
    """Any fabric with a fault plan in front of it. Batch verbs use the
    base fan-out, so each host's call passes :meth:`ChaosPlan.before`
    on its own (a rule scoped to a host hits exactly that host's
    thread)."""

    def __init__(self, inner: Fabric, plan: ChaosPlan):
        self.inner = inner
        self.plan = plan

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _check_dead(self, verb: str, host: str) -> None:
        """Any verb against a host with a dead marker (``host:die``)
        fails fatally: no retry revives it."""
        if host not in dead_hosts():
            return
        count_fault(verb, "die")
        get_obs().emit("chaos_dead_host", verb=verb, host=host)
        raise FabricHostLost(
            f"chaos: host {host} is dead (host:die) — permanent "
            "failure, no retry revives it", host=host)

    def exec(self, host, cmd, env=None, container=None):
        self._check_dead("exec", host)
        self.plan.before("exec", host)
        self.inner.exec(host, cmd, env=env, container=container)

    def copy(self, src, host, target_dir, container=None):
        self._check_dead("copy", host)
        self.plan.before("copy", host)
        self.inner.copy(src, host, target_dir, container=container)

    def fetch(self, host, src, target_dir, container=None):
        # the pull direction is the same data-plane verb
        self._check_dead("copy", host)
        self.plan.before("copy", host)
        self.inner.fetch(host, src, target_dir, container=container)
