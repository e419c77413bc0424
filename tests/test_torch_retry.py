"""The port's retry, backoff and deadline layer
(``dgl_operator_tpu_torch/launcher/retry.py``) and the fabric error
taxonomy it depends on: the JAX package's ``tests/test_retry.py`` cases
on the port's copy, then the delays of both packages' ``RetryPolicy``
under one seeded clock.

All timing runs against a fake clock/sleep — no test here waits on
wall time.
"""

import pytest

from dgl_operator_tpu.launcher import retry as jax_retry
from dgl_operator_tpu_torch.launcher.fabric import (BatchFabricError, Fabric,
                                                    FabricError,
                                                    FabricExecError,
                                                    FabricTimeout,
                                                    LocalFabric,
                                                    is_transient)
from dgl_operator_tpu_torch.launcher.retry import (DeadlineExceeded,
                                                   RetryPolicy,
                                                   RetryingFabric)


class FakeClock:
    """Injectable clock + sleep: sleep() advances the clock."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def __call__(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s


def _policy(clk, **kw):
    kw.setdefault("max_attempts", 4)
    kw.setdefault("base_delay", 1.0)
    kw.setdefault("jitter", 0.5)
    kw.setdefault("seed", 0)
    return RetryPolicy(clock=clk, sleep=clk.sleep, **kw)


# ------------------------------------------------------------- policy
def test_retry_policy_retries_transient_until_success():
    clk = FakeClock()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise FabricError("flake", transient=True)
        return "ok"

    assert _policy(clk).call(flaky) == "ok"
    assert len(calls) == 3 and len(clk.sleeps) == 2


def test_retry_policy_backoff_grows_and_jitter_bounded():
    clk = FakeClock()
    pol = _policy(clk, max_attempts=5, base_delay=1.0, multiplier=2.0,
                  jitter=0.5, max_delay=100.0)
    calls = []

    def always():
        calls.append(1)
        raise FabricError("flake", transient=True)

    with pytest.raises(FabricError):
        pol.call(always)
    assert len(calls) == 5 and len(clk.sleeps) == 4
    # each delay is base*2^k .. base*2^k*(1+jitter), monotone bases
    for k, d in enumerate(clk.sleeps):
        lo, hi = 1.0 * 2 ** k, 1.0 * 2 ** k * 1.5
        assert lo <= d <= hi, (k, d)


def test_retry_policy_caps_delay():
    clk = FakeClock()
    pol = _policy(clk, max_attempts=6, base_delay=10.0, max_delay=15.0,
                  jitter=0.0)

    def always():
        raise FabricError("x", transient=True)

    with pytest.raises(FabricError):
        pol.call(always)
    assert clk.sleeps == [10.0, 15.0, 15.0, 15.0, 15.0]


def test_retry_policy_fatal_not_retried():
    clk = FakeClock()
    calls = []

    def fatal():
        calls.append(1)
        raise FabricError("misconfigured", transient=False)

    with pytest.raises(FabricError, match="misconfigured"):
        _policy(clk).call(fatal)
    assert len(calls) == 1 and clk.sleeps == []


def test_retry_policy_deadline_honored():
    """The overall deadline wins over remaining attempts: a retry whose
    backoff would cross the deadline raises DeadlineExceeded (chained to
    the last real error) instead of sleeping past it."""
    clk = FakeClock()
    pol = _policy(clk, max_attempts=10, base_delay=4.0, jitter=0.0,
                  deadline=10.0)
    calls = []

    def always():
        calls.append(1)
        clk.now += 1.0          # each attempt costs wall time too
        raise FabricError("flake", transient=True)

    with pytest.raises(DeadlineExceeded) as ei:
        pol.call(always, describe="exec on w0")
    assert isinstance(ei.value.__cause__, FabricError)
    assert not is_transient(ei.value)      # deadline errors are final
    # attempts: t=1 (+4 sleep) -> t=6 (+8 sleep would cross 10) -> stop
    assert len(calls) == 2


def test_retry_policy_rejects_bad_attempts():
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)


def test_retry_policy_from_env(monkeypatch):
    monkeypatch.setenv("TPU_OPERATOR_RETRIES", "5")
    monkeypatch.setenv("TPU_OPERATOR_RETRY_BASE_S", "0.125")
    monkeypatch.setenv("TPU_OPERATOR_RETRY_DEADLINE_S", "60")
    pol = RetryPolicy.from_env()
    assert pol.max_attempts == 6
    assert pol.base_delay == 0.125
    assert pol.deadline == 60.0
    monkeypatch.setenv("TPU_OPERATOR_RETRIES", "0")
    assert RetryPolicy.from_env().max_attempts == 1   # disables wrapping


# ----------------------------------------------------- error taxonomy
def test_fabric_error_classification():
    assert not is_transient(FabricError("plain"))
    assert is_transient(FabricError("flagged", transient=True))
    assert is_transient(FabricTimeout("hung"))
    assert is_transient(FabricExecError("exit 1", 1))
    # 126/127 = command not runnable -> misconfiguration, fatal
    assert not is_transient(FabricExecError("exit 126", 126))
    assert not is_transient(FabricExecError("exit 127", 127))
    assert not is_transient(RuntimeError("not a fabric error"))


def test_local_fabric_timeout_is_transient(tmp_path):
    f = LocalFabric(timeout=0.2)
    with pytest.raises(FabricTimeout) as ei:
        f.exec("w0", "sleep 30")
    assert is_transient(ei.value)
    f.exec("w0", "true")    # fabric still usable after a timeout


def test_batch_error_reports_all_failed_hosts():
    f = LocalFabric()
    with pytest.raises(BatchFabricError) as ei:
        f.exec_batch(["a", "b", "c"], "exit 9")
    assert ei.value.hosts == ["a", "b", "c"]
    assert is_transient(ei.value)           # exit 9 is retryable
    # mixed transient/fatal -> the batch is fatal (retrying can't fix
    # the fatal member, and re-running it would double-execute)
    class Half(Fabric):
        def exec(self, host, cmd, env=None, container=None):
            raise FabricError(host, transient=(host != "bad"))

    with pytest.raises(BatchFabricError) as ei:
        Half().exec_batch(["ok1", "bad", "ok2"], "x")
    assert not is_transient(ei.value)
    assert ei.value.hosts == ["ok1", "bad", "ok2"]


# --------------------------------------------------- retrying fabric
class ScriptedFabric(Fabric):
    """Fails each (verb, host) the scripted number of times, then
    succeeds; records every attempted call."""

    def __init__(self, fail):
        self.fail = dict(fail)     # (verb, host) -> remaining failures
        self.calls = []

    def _maybe_fail(self, verb, host):
        self.calls.append((verb, host))
        left = self.fail.get((verb, host), 0)
        if left > 0:
            self.fail[(verb, host)] = left - 1
            raise FabricError(f"{verb} {host} flake", transient=True)

    def exec(self, host, cmd, env=None, container=None):
        self._maybe_fail("exec", host)

    def copy(self, src, host, target_dir, container=None):
        self._maybe_fail("copy", host)


def _retrying(inner, attempts=4):
    clk = FakeClock()
    return RetryingFabric(inner, _policy(clk, max_attempts=attempts)), clk


def test_retrying_fabric_exec_and_copy_retry_transient():
    inner = ScriptedFabric({("exec", "w0"): 2, ("copy", "w1"): 1})
    fab, clk = _retrying(inner)
    fab.exec("w0", "x")
    fab.copy("/src", "w1", "/dst")
    assert inner.calls.count(("exec", "w0")) == 3
    assert inner.calls.count(("copy", "w1")) == 2


def test_retrying_fabric_batch_retries_only_failed_subset():
    inner = ScriptedFabric({("exec", "w2"): 2})
    fab, clk = _retrying(inner)
    seen_env = {}

    # wrap to also capture per-host env routing across subset retries
    orig = inner.exec

    def spy(host, cmd, env=None, container=None):
        seen_env.setdefault(host, []).append(dict(env or {}))
        orig(host, cmd, env=env, container=container)

    inner.exec = spy
    fab.exec_batch(["w0", "w1", "w2"], "cmd",
                   per_host_env=[{"R": "0"}, {"R": "1"}, {"R": "2"}])
    # healthy hosts ran exactly once; only w2 was re-run
    assert [h for v, h in inner.calls if v == "exec"].count("w0") == 1
    assert [h for v, h in inner.calls if v == "exec"].count("w1") == 1
    assert [h for v, h in inner.calls if v == "exec"].count("w2") == 3
    # w2 kept ITS env on every retry (index mapping preserved)
    assert all(e.get("R") == "2" for e in seen_env["w2"])


def test_retrying_fabric_batch_exhaustion_raises_with_failed_hosts():
    inner = ScriptedFabric({("exec", "w1"): 99})
    fab, clk = _retrying(inner, attempts=3)
    with pytest.raises(BatchFabricError) as ei:
        fab.exec_batch(["w0", "w1"], "cmd")
    assert ei.value.hosts == ["w1"]
    assert [h for v, h in inner.calls].count("w1") == 3
    assert [h for v, h in inner.calls].count("w0") == 1


def test_retrying_fabric_copy_batch_retries_failed_host_only(tmp_path):
    inner = ScriptedFabric({("copy", "w1"): 1})
    fab, clk = _retrying(inner)
    fab.copy_batch(["/a", "/b"], ["w0", "w1"], "/dst")
    # w0's pair of copies ran once; w1's batch re-ran after its flake
    assert inner.calls.count(("copy", "w0")) == 2
    w1 = inner.calls.count(("copy", "w1"))
    assert 2 <= w1 <= 3     # flaked on first copy, whole host re-ran


def test_retrying_fabric_delegates_unknown_attrs():
    inner = LocalFabric()
    fab = RetryingFabric(inner, RetryPolicy(max_attempts=1))
    assert fab.log is inner.log
    assert fab.host_env is inner.host_env


# ------------------------------------------------------ parity with JAX
@pytest.mark.parametrize("seed", [0, 7])
def test_retry_delays_match_jax_under_one_seeded_clock(seed):
    """Both packages' policies, one failing call each under a fake
    clock: the same sleeps, attempt for attempt, and the same
    exhaustion."""
    def sleeps(cls):
        clk = FakeClock()
        pol = cls(max_attempts=5, base_delay=0.5, multiplier=3.0,
                  max_delay=4.0, jitter=0.5, seed=seed, clock=clk,
                  sleep=clk.sleep)
        calls = []

        def flaky():
            calls.append(1)
            raise FabricError("x", transient=True)

        with pytest.raises(Exception):
            pol.call(flaky, describe="exec on w0")
        return clk.sleeps, len(calls)

    got, want = sleeps(RetryPolicy), sleeps(jax_retry.RetryPolicy)
    assert got == want and got[1] == 5 and len(got[0]) == 4
