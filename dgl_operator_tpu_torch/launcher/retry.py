"""Retry / backoff / deadline layer over the exec-copy fabric.

The reference operator survives a hostile cluster at the *pod* level
(phase machine with Evicted/Failed states, watcher-loop barriers), but
its data-plane verbs are fire-once: one flaky `kubexec.sh` call fails
the whole dglrun phase. On preemptible TPU slices transient exec/copy
failures are the common case, so every fabric verb here runs under a
:class:`RetryPolicy` — exponential backoff with bounded jitter and an
overall deadline — and batch verbs retry only the hosts that failed.

Classification contract (fabric.py): a :class:`~.fabric.FabricError`
carries ``transient``; only transient errors are retried. Timeouts and
remote non-zero exits are transient (the next attempt may land on a
healthy pod); misconfiguration (unknown fabric kind, missing wrapper
script, exit 126/127 = command not runnable) is fatal and surfaces
immediately.

Env surface (read by :meth:`RetryPolicy.from_env`, applied by
``get_fabric``):

    TPU_OPERATOR_RETRIES            extra attempts after the first
                                    (default 2; 0 disables wrapping)
    TPU_OPERATOR_RETRY_BASE_S       first backoff delay (default 0.25)
    TPU_OPERATOR_RETRY_MAX_S        per-delay cap (default 30)
    TPU_OPERATOR_RETRY_DEADLINE_S   overall budget per verb, sleeps
                                    included (default: none)

The port's copy of the JAX package's ``launcher/retry.py``, torch-free;
its decisions are counted in the in-memory ``Obs``.
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, Dict, List, Optional, Sequence

from dgl_operator_tpu_torch.launcher.fabric import (BatchFabricError, Fabric,
                                                    FabricError, FabricTimeout,
                                                    is_transient)
from dgl_operator_tpu_torch.obs import get_obs

RETRIES_ENV = "TPU_OPERATOR_RETRIES"
RETRY_BASE_ENV = "TPU_OPERATOR_RETRY_BASE_S"
RETRY_MAX_ENV = "TPU_OPERATOR_RETRY_MAX_S"
RETRY_DEADLINE_ENV = "TPU_OPERATOR_RETRY_DEADLINE_S"


class DeadlineExceeded(FabricError):
    """The overall retry deadline ran out; carries the last error as
    ``__cause__``. Fatal by construction — retrying more is exactly
    what the deadline forbids."""

    transient = False


class RetryPolicy:
    """Exponential backoff + jitter + overall deadline.

    ``clock`` / ``sleep`` are injectable so tests drive time by hand;
    ``rng`` seeds the jitter stream (deterministic fault plans need
    deterministic schedules).
    """

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.25,
                 max_delay: float = 30.0, multiplier: float = 2.0,
                 jitter: float = 0.5, deadline: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 seed: Optional[int] = None):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1: {max_attempts}")
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.multiplier = multiplier
        self.jitter = jitter
        self.deadline = deadline
        self.clock = clock
        self.sleep = sleep
        self._rng = random.Random(seed)

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None,
                 **overrides) -> "RetryPolicy":
        env = os.environ if env is None else env

        def f(name, default):
            v = env.get(name)
            return default if v in (None, "") else float(v)

        kw = dict(max_attempts=1 + int(f(RETRIES_ENV, 2)),
                  base_delay=f(RETRY_BASE_ENV, 0.25),
                  max_delay=f(RETRY_MAX_ENV, 30.0),
                  deadline=f(RETRY_DEADLINE_ENV, 0) or None)
        kw.update(overrides)
        return cls(**kw)

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (0-based): capped
        exponential plus uniform jitter in [0, jitter * delay]."""
        d = min(self.base_delay * (self.multiplier ** attempt),
                self.max_delay)
        return d * (1.0 + self.jitter * self._rng.random())

    def call(self, fn: Callable, *args, describe: str = "",
             retryable: Callable[[BaseException], bool] = is_transient,
             **kwargs):
        """Run ``fn`` under this policy: retry transient failures up to
        ``max_attempts`` total tries, never sleeping past ``deadline``
        (measured from the first attempt, sleeps included)."""
        start = self.clock()
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except Exception as exc:
                self._backoff_or_raise(exc, attempt, start, retryable,
                                       describe)

    def _backoff_or_raise(self, exc, attempt, start, retryable,
                          describe) -> None:
        """Shared retry bookkeeping: re-raise fatal / exhausted /
        over-deadline errors, otherwise sleep the backoff. Every
        decision is counted/evented (obs) — recovery firing silently
        is how a degrading cluster hides until it fails outright."""
        obs = get_obs()
        verb = (describe.split() or ["call"])[0]
        if isinstance(exc, FabricTimeout):
            obs.metrics.counter(
                "fabric_timeouts_total",
                "fabric verbs that hit a per-call timeout",
                labels=("verb",)).inc(verb=verb)
        if not retryable(exc):
            raise exc
        if attempt + 1 >= self.max_attempts:
            obs.metrics.counter(
                "fabric_retry_exhausted_total",
                "transient failures that ran out of attempts",
                labels=("verb",)).inc(verb=verb)
            obs.emit("fabric_retry_exhausted", verb=verb,
                     attempts=attempt + 1, describe=describe,
                     error=str(exc)[:300])
            raise exc
        d = self.delay(attempt)
        if self.deadline is not None and \
                (self.clock() - start) + d > self.deadline:
            obs.metrics.counter(
                "fabric_retry_deadline_total",
                "retry loops cut off by the overall deadline",
                labels=("verb",)).inc(verb=verb)
            obs.emit("fabric_retry_deadline", verb=verb,
                     attempts=attempt + 1,
                     deadline_s=self.deadline, describe=describe)
            raise DeadlineExceeded(
                f"retry deadline ({self.deadline:.1f}s) exceeded after "
                f"{attempt + 1} attempt(s)"
                + (f" of {describe}" if describe else "")) from exc
        obs.metrics.counter(
            "fabric_retries_total",
            "transient fabric failures retried after backoff",
            labels=("verb",)).inc(verb=verb)
        obs.emit("fabric_retry", verb=verb, attempt=attempt + 1,
                 delay_s=round(d, 4), describe=describe,
                 error=str(exc)[:300])
        self.sleep(d)


class RetryingFabric(Fabric):
    """Transparent retry wrapper over any :class:`~.fabric.Fabric`.

    Single verbs re-run whole; batch verbs re-run only the failed
    subset of hosts (``BatchFabricError`` reports every failure with
    its index, so a 100-host fan-out with one flaky pod re-execs one
    host, not 100). Unknown attributes delegate to the wrapped fabric
    (``.log``, ``.control``, ``.store`` stay reachable for tests and
    callers that introspect)."""

    def __init__(self, inner: Fabric, policy: Optional[RetryPolicy] = None):
        self.inner = inner
        self.policy = policy or RetryPolicy.from_env()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    # -- single verbs ---------------------------------------------------
    def exec(self, host, cmd, env=None, container=None):
        self.policy.call(self.inner.exec, host, cmd, env=env,
                         container=container,
                         describe=f"exec on {host}")

    def copy(self, src, host, target_dir, container=None):
        self.policy.call(self.inner.copy, src, host, target_dir,
                         container=container,
                         describe=f"copy {src} to {host}")

    def fetch(self, host, src, target_dir, container=None):
        self.policy.call(self.inner.fetch, host, src, target_dir,
                         container=container,
                         describe=f"fetch {src} from {host}")

    # -- batch verbs: retry only the failed subset ----------------------
    def exec_batch(self, hosts: Sequence[str], cmd, env=None,
                   per_host_env=None, container=None):
        def run(sub_hosts, sub_idx):
            phe = ([per_host_env[i] for i in sub_idx]
                   if per_host_env else None)
            self.inner.exec_batch(sub_hosts, cmd, env=env,
                                  per_host_env=phe, container=container)

        self._batch(list(hosts), run, "exec_batch")

    def copy_batch(self, srcs, hosts: Sequence[str], target_dir,
                   container=None):
        def run(sub_hosts, sub_idx):
            self.inner.copy_batch(srcs, sub_hosts, target_dir,
                                  container=container)

        self._batch(list(hosts), run, "copy_batch")

    def _batch(self, hosts: List[str], run, describe: str) -> None:
        """Drive ``run`` over a shrinking host subset: after a batch
        attempt, only hosts that failed transiently are retried (their
        original indices preserved for per-host env)."""
        idx = list(range(len(hosts)))
        pol = self.policy
        start = pol.clock()
        for attempt in range(pol.max_attempts):
            try:
                run([hosts[i] for i in idx], idx)
                return
            except BatchFabricError as exc:
                obs = get_obs()
                obs.metrics.counter(
                    "fabric_host_failures_total",
                    "per-host failures inside batch fabric verbs",
                    labels=("verb",)).inc(len(exc.failures),
                                          verb=describe)
                obs.emit("fabric_batch_failure", verb=describe,
                         attempt=attempt + 1, hosts=exc.hosts,
                         transient=bool(exc.transient))
                pol._backoff_or_raise(
                    exc, attempt, start, is_transient,
                    f"{describe} on {exc.hosts}")
                # positions in exc are into the subset we just ran
                idx = [idx[i] for i, _, _ in exc.failures]
