"""The fabric half of the port's chaos plan
(``dgl_operator_tpu_torch/launcher/chaos.py``): ``ChaosPlan.before`` and
``ChaosFabric``, the fabric cases of the JAX package's
``tests/test_chaos.py`` on the port's copy, ``get_fabric`` wrapping the
environment's plan under the retry layer, the dead-host gate, and the
faults both packages' ``ChaosFabric`` deliver over one plan and one
sequence of calls.
"""

import pytest

from dgl_operator_tpu.launcher import chaos as jax_chaos
from dgl_operator_tpu.launcher import fabric as jax_fabric
from dgl_operator_tpu_torch.launcher.chaos import (CHAOS_ENV, WORKSPACE_ENV,
                                                   ChaosFabric, ChaosPlan,
                                                   ChaosPlanError,
                                                   mark_host_dead,
                                                   plan_from_env)
from dgl_operator_tpu_torch.launcher.fabric import (Fabric, FabricError,
                                                    FabricHostLost,
                                                    FabricTimeout,
                                                    get_fabric, is_transient)
from dgl_operator_tpu_torch.launcher.retry import RetryingFabric


class NullFabric(Fabric):
    """Verbs always succeed; records calls."""

    def __init__(self):
        self.calls = []

    def exec(self, host, cmd, env=None, container=None):
        self.calls.append(("exec", host))

    def copy(self, src, host, target_dir, container=None):
        self.calls.append(("copy", host))


# -------------------------------------------------------------- plans
def test_chaos_plan_parse():
    p = ChaosPlan.parse(
        "seed=7; exec:fail:2@host=w1; copy:flaky:0.5; exec:delay:0.01;"
        "train:kill:8")
    assert p.seed == 7 and len(p.rules) == 4
    assert p.train_kill_step() == 8
    assert ChaosPlan.parse("").rules == []
    with pytest.raises(ChaosPlanError):
        ChaosPlan.parse("exec:explode:1")
    with pytest.raises(ChaosPlanError):
        ChaosPlan.parse("exec:kill:1")       # kill is train-only
    with pytest.raises(ChaosPlanError):
        ChaosPlan.parse("train:fail:1")      # train pairs only with kill


def test_chaos_env_helpers(monkeypatch):
    monkeypatch.delenv(CHAOS_ENV, raising=False)
    assert plan_from_env() is None
    monkeypatch.setenv(CHAOS_ENV, "exec:fail:1;train:kill:12")
    assert len(plan_from_env().rules) == 2
    assert plan_from_env().train_kill_step() == 12


def test_chaos_fail_first_n_and_fail_host():
    fab = ChaosFabric(NullFabric(), ChaosPlan.parse("exec:fail:2"))
    for _ in range(2):
        with pytest.raises(FabricError) as ei:
            fab.exec("w0", "x")
        assert is_transient(ei.value)
    fab.exec("w0", "x")                      # budget exhausted
    assert len(fab.plan.injected) == 2

    # host-scoped: only w1 sees faults
    fab = ChaosFabric(NullFabric(), ChaosPlan.parse("exec:fail:2@host=w1"))
    fab.exec("w0", "x")
    with pytest.raises(FabricError):
        fab.exec("w1", "x")
    fab.exec("w2", "x")
    assert [h for _, _, h in fab.plan.injected] == ["w1"]


def test_chaos_timeout_action_raises_fabric_timeout():
    fab = ChaosFabric(NullFabric(), ChaosPlan.parse("exec:timeout:1"))
    with pytest.raises(FabricTimeout):
        fab.exec("w0", "x")
    fab.exec("w0", "x")


def test_chaos_flaky_copy_is_seed_deterministic():
    def failures(seed):
        fab = ChaosFabric(NullFabric(),
                          ChaosPlan.parse(f"seed={seed};copy:flaky:0.5"))
        out = []
        for i in range(30):
            try:
                fab.copy("/s", "w0", "/d")
                out.append(False)
            except FabricError:
                out.append(True)
        return out

    a, b, c = failures(11), failures(11), failures(12)
    assert a == b                  # same seed -> identical fault train
    assert a != c                  # different seed -> different train
    assert 3 < sum(a) < 27         # p=0.5 actually flaky, not constant


def test_chaos_batch_faults_hit_per_host_threads():
    """Batch fan-out passes each per-host call through the plan: a
    fail-host rule fails exactly that host's thread, and the batch
    error carries it."""
    from dgl_operator_tpu_torch.launcher.fabric import BatchFabricError

    fab = ChaosFabric(NullFabric(), ChaosPlan.parse("exec:fail:1@host=w1"))
    with pytest.raises(BatchFabricError) as ei:
        fab.exec_batch(["w0", "w1", "w2"], "x")
    assert ei.value.hosts == ["w1"]
    fab.exec_batch(["w0", "w1", "w2"], "x")  # budget spent -> clean


def test_get_fabric_retries_absorb_chaos_plan(monkeypatch):
    """The acceptance wiring: a TPU_OPERATOR_CHAOS fail-first-N plan on
    one host is invisible to the caller — get_fabric's retry layer
    re-runs the failed host until the plan budget is spent."""
    monkeypatch.setenv(CHAOS_ENV, "exec:fail:2@host=w1")
    monkeypatch.setenv("TPU_OPERATOR_RETRY_BASE_S", "0.01")
    fab = get_fabric("local")
    assert isinstance(fab, RetryingFabric)
    assert isinstance(fab.inner, ChaosFabric)
    fab.exec_batch(["w0", "w1"], "true")     # no raise
    assert len(fab.inner.plan.injected) == 2


def test_get_fabric_rejects_bad_chaos_plan(monkeypatch):
    monkeypatch.setenv(CHAOS_ENV, "exec:frobnicate:1")
    with pytest.raises(ChaosPlanError):
        get_fabric("local")


def test_dead_host_is_fatal_and_not_retried(tmp_path, monkeypatch):
    monkeypatch.setenv(WORKSPACE_ENV, str(tmp_path))
    monkeypatch.setenv(CHAOS_ENV, "exec:delay:0")
    mark_host_dead("w1")
    fab = get_fabric("local")
    with pytest.raises(FabricHostLost):
        fab.exec("w1", "true")
    assert not is_transient(FabricHostLost("x", host="w1"))
    fab.exec("w0", "true")


def _jax_null():
    class JaxNull(jax_fabric.Fabric):
        def exec(self, host, cmd, env=None, container=None):
            pass

        def copy(self, src, host, target_dir, container=None):
            pass

    return JaxNull()


@pytest.mark.parametrize("spec", [
    "seed=3;exec:flaky:0.4;copy:fail:2@host=w1",
    "any:fail:3;exec:timeout:1@host=w2",
    "seed=9;copy:flaky:0.7;exec:fail:1"])
def test_chaos_faults_match_jax(spec):
    """One plan, one sequence of calls over three hosts: both packages'
    ``ChaosFabric`` fail the same calls with the same error types and
    record the same injections."""
    calls = [("exec" if i % 3 else "copy", f"w{i % 3}") for i in range(40)]

    def run(fab):
        out = []
        for verb, host in calls:
            try:
                (fab.exec(host, "x") if verb == "exec"
                 else fab.copy("/s", host, "/d"))
                out.append(None)
            except Exception as exc:   # noqa: BLE001 — compared by type
                out.append((type(exc).__name__, is_transient(exc)))
        return out, fab.plan.injected

    got = run(ChaosFabric(NullFabric(), ChaosPlan.parse(spec)))
    want = run(jax_chaos.ChaosFabric(_jax_null(),
                                     jax_chaos.ChaosPlan.parse(spec)))
    assert got == want
    assert any(x is not None for x in got[0])
