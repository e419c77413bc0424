"""Remote exec / copy fabric.

The reference reaches workers exclusively through a generated
``kubexec.sh`` (``sh kubexec.sh <pod> '<cmd>'``, written by the
controller, dgljob_controller.go:875-879) and ``kubectl cp``
(tools/launch.py:14-50, tools/dispatch.py:13-20) — i.e. every control
and bulk-data action funnels through the k8s API server. Here the same
two verbs (exec, copy) are an interface with two implementations:

- :class:`LocalFabric` — hosts share one filesystem; exec is a local
  subprocess, copy is a filesystem copy. This is both the test fabric
  and the real fabric for single-node / same-NFS TPU pods.
- :class:`ShellFabric` — exec/copy delegate to wrapper scripts with the
  exact calling convention of the reference's kubexec.sh / kubectl cp,
  so a k8s (or ssh) deployment drops in via two small scripts rendered
  by the control plane (native/controller renders exec.sh the way
  buildConfigMap renders kubexec.sh).
- :class:`~.objstore.ObjectStoreFabric` — bulk copies staged through a
  bucket (SURVEY §2: GCS dispatch replaces kubectl-cp as the data
  plane); exec passes through to one of the two control fabrics above.
  Selected via ``TPU_OPERATOR_OBJECT_STORE`` / kind 'object' in
  :func:`get_fabric`.

Batch variants fan out over daemon threads and join, matching
``kubexec_multi`` + thread join semantics (tools/launch.py:14-24,
submit_jobs join :154-155).

The port's copy of the JAX package's ``launcher/fabric.py``,
torch-free, with its names, environment variables and error taxonomy,
so the operator's pods start either package's driver unchanged.
:func:`get_fabric` wraps the ``TPU_OPERATOR_CHAOS`` plan's
:class:`~.chaos.ChaosFabric` and the retry policy as the JAX one does.
"""

from __future__ import annotations

import os
import shlex
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

EXEC_PATH_ENV = "TPU_OPERATOR_EXEC_PATH"    # kubexec.sh equivalent
COPY_PATH_ENV = "TPU_OPERATOR_COPY_PATH"    # kubectl-cp equivalent
EXEC_TIMEOUT_ENV = "TPU_OPERATOR_EXEC_TIMEOUT_S"
DEFAULT_EXEC_TIMEOUT = 3600.0   # a verb that runs an hour is hung, not slow


class FabricError(RuntimeError):
    """Fabric verb failure. ``transient`` classifies it for the retry
    layer (launcher/retry.py): transient = the same call may succeed on
    a later attempt (pod restarting, network flake); fatal = retrying
    cannot help (misconfiguration). Base errors are fatal."""

    transient = False

    def __init__(self, msg: str, transient: Optional[bool] = None):
        super().__init__(msg)
        if transient is not None:
            self.transient = transient


class FabricTimeout(FabricError):
    """A verb exceeded its per-call timeout — always transient (the
    hang is on the remote side; a fresh attempt gets a fresh process)."""

    transient = True


class FabricExecError(FabricError):
    """Remote command exited non-zero. Transient unless the shell
    itself could not run the command (126 not executable / 127 not
    found — misconfiguration that no retry heals) or the numerics
    sentry halted the trainer (76, ``obs/quality.NUMERICS_FAULT_EXIT``
    — the DRIVER owns that recovery: ``tpurun --numerics-retries``
    consumes the workspace fault marker and relaunches from the
    last-known-good checkpoint; a fabric-level retry would resume the
    job without burning the bounded rollback budget or leaving the
    ``numerics_rollback`` audit trail)."""

    def __init__(self, msg: str, returncode: int,
                 transient: Optional[bool] = None):
        if transient is None:
            transient = returncode not in (126, 127, 76)
        super().__init__(msg, transient=transient)
        self.returncode = returncode


class FabricHostLost(FabricError):
    """A host has been declared permanently gone (chaos ``host:die``,
    or an operator marking a machine dead). Fatal by construction: no
    retry revives dead hardware. The recovery path is the elastic
    control plane (launcher/elastic.py), which re-places the dead
    host's partitions over the survivors."""

    transient = False

    def __init__(self, msg: str, host: Optional[str] = None):
        super().__init__(msg, transient=False)
        self.host = host


class BatchFabricError(FabricError):
    """A batch verb failed on one or more hosts. Carries EVERY failure
    as ``(index, host, exc)`` (index into the batch's host list, so the
    retry layer can re-run exactly the failed subset); transient iff
    all per-host failures are transient."""

    def __init__(self, failures):
        self.failures = sorted(failures, key=lambda f: f[0])
        hosts = ", ".join(f"{h}: {e}" for _, h, e in self.failures)
        super().__init__(
            f"{len(self.failures)} host(s) failed: {hosts}",
            transient=all(is_transient(e) for _, _, e in self.failures))

    @property
    def hosts(self):
        return [h for _, h, _ in self.failures]


def is_transient(exc: BaseException) -> bool:
    """The retry layer's classification gate."""
    return bool(getattr(exc, "transient", False))


def env_exec_timeout(timeout: Optional[float] = None) -> Optional[float]:
    """Resolve a per-call timeout: explicit arg wins, else the env
    knob, else the default. 0 disables (explicitly unbounded). Public:
    the non-fabric subprocess sites (tpurun phases, objstore copies)
    share this policy so TPU_OPERATOR_EXEC_TIMEOUT_S is the one knob
    that bounds every child process (tpu-lint rule TPU005)."""
    if timeout is None:
        timeout = float(os.environ.get(EXEC_TIMEOUT_ENV,
                                       DEFAULT_EXEC_TIMEOUT) or 0)
    return timeout or None


_env_timeout = env_exec_timeout   # historical internal name


class Fabric:
    """Two verbs against a named host: run a shell command, copy a file.
    ``fetch`` is the copy verb's pull direction (``kubectl cp
    pod:path dst``) — the obs collector uses it to bring every
    worker's telemetry artifacts back to the driver, so the chaos and
    retry layers wrapped around copy cover collection too."""

    def exec(self, host: str, cmd: str, env: Optional[Dict[str, str]] = None,
             container: Optional[str] = None) -> None:
        raise NotImplementedError

    def copy(self, src: str, host: str, target_dir: str,
             container: Optional[str] = None) -> None:
        raise NotImplementedError

    def fetch(self, host: str, src: str, target_dir: str,
              container: Optional[str] = None) -> None:
        """Pull ``src`` FROM ``host`` into the local ``target_dir``."""
        raise NotImplementedError

    # -- batch forms (daemon-thread fan-out, tools/launch.py:14-24) ----
    def exec_batch(self, hosts: Sequence[str], cmd: str,
                   env: Optional[Dict[str, str]] = None,
                   per_host_env: Optional[List[Dict[str, str]]] = None,
                   container: Optional[str] = None) -> None:
        self._join(self._spawn_exec(hosts, cmd, env, per_host_env, container))

    @staticmethod
    def _fan_out(hosts: Sequence[str],
                 per_host_fn) -> List[threading.Thread]:
        """Daemon-thread fan-out over hosts; errors collected into the
        trailing _ErrorCheck sentinel and raised at _join."""
        threads, errors = [], []

        def run(i, h):
            try:
                per_host_fn(i, h)
            except Exception as exc:  # surfaced after join
                errors.append((i, h, exc))

        for i, h in enumerate(hosts):
            t = threading.Thread(target=run, args=(i, h), daemon=True)
            t.start()
            threads.append(t)
        threads.append(_ErrorCheck(errors))
        return threads

    def _spawn_exec(self, hosts, cmd, env=None, per_host_env=None,
                    container=None) -> List[threading.Thread]:
        def one(i, h):
            e = dict(env or {})
            if per_host_env:
                e.update(per_host_env[i])
            self.exec(h, cmd, env=e, container=container)

        return self._fan_out(hosts, one)

    def copy_batch(self, srcs: Sequence[str], hosts: Sequence[str],
                   target_dir: str, container: Optional[str] = None) -> None:
        def one(i, h):
            self.exec(h, f"mkdir -p {shlex.quote(target_dir)}",
                      container=container)
            for s in srcs:
                self.copy(s, h, target_dir, container=container)

        self._join(self._fan_out(hosts, one))

    @staticmethod
    def _join(threads: List[threading.Thread]) -> None:
        errors: List = []
        for t in threads:
            if isinstance(t, _ErrorCheck):
                errors = t.errors
            else:
                t.join()
        if errors:
            exc = BatchFabricError(errors)
            raise exc from errors[0][2]


class _ErrorCheck:
    """Sentinel carrying batch errors through the thread list."""

    def __init__(self, errors):
        self.errors = errors


class LocalFabric(Fabric):
    """Shared-filesystem fabric: every host is this machine.

    ``host_env`` lets tests / single-node runs give each logical host
    extra env (e.g. a distinct workspace root) — the moral equivalent of
    each pod having its own /dgl_workspace emptyDir.
    """

    def __init__(self, host_env: Optional[Dict[str, Dict[str, str]]] = None,
                 timeout: Optional[float] = None):
        self.host_env = host_env or {}
        self.timeout = _env_timeout(timeout)
        self.log: List = []   # (verb, host, payload) for tests/tracing

    def exec(self, host, cmd, env=None, container=None):
        full = dict(os.environ)
        full.update(self.host_env.get(host, {}))
        full.update(env or {})
        self.log.append(("exec", host, cmd))
        try:
            res = subprocess.run(cmd, shell=True, env=full,
                                 capture_output=True, text=True,
                                 timeout=self.timeout)
        except subprocess.TimeoutExpired as exc:
            raise FabricTimeout(
                f"exec on {host} timed out after {self.timeout:.0f}s: "
                f"{cmd}") from exc
        if res.returncode != 0:
            raise FabricExecError(
                f"exec on {host} failed ({res.returncode}): {cmd}\n"
                f"stdout: {res.stdout[-2000:]}\nstderr: {res.stderr[-2000:]}",
                res.returncode)

    def copy(self, src, host, target_dir, container=None):
        self.log.append(("copy", host, (src, target_dir)))
        os.makedirs(target_dir, exist_ok=True)
        dst = os.path.join(target_dir, os.path.basename(src))
        if os.path.abspath(src) == os.path.abspath(dst):
            return
        if os.path.isdir(src):
            shutil.copytree(src, dst, dirs_exist_ok=True)
        else:
            shutil.copy2(src, dst)

    def fetch(self, host, src, target_dir, container=None):
        # shared filesystem: the "remote" path is a local path. A
        # missing source is fatal, not transient — the host never
        # produced the artifact; retrying cannot conjure it (the
        # collector records it as a lost-artifact host instead)
        self.log.append(("fetch", host, (src, target_dir)))
        if not os.path.exists(src):
            raise FabricError(f"fetch on {host}: {src} does not exist",
                              transient=False)
        os.makedirs(target_dir, exist_ok=True)
        dst = os.path.join(target_dir, os.path.basename(src))
        if os.path.abspath(src) == os.path.abspath(dst):
            return
        if os.path.isdir(src):
            shutil.copytree(src, dst, dirs_exist_ok=True)
        else:
            shutil.copy2(src, dst)


class ShellFabric(Fabric):
    """Wrapper-script fabric (kubexec.sh calling convention).

    exec:  ``sh <exec_path> <host> '<cmd>'`` — and with a container,
           ``sh <exec_path> '<host> -c <container>' '<cmd>'`` (the exact
           shapes of tools/launch.py:14-31).
    copy:  ``sh <copy_path> <src> <host> <target_dir> [container]``.
    fetch: ``sh <copy_path> <host>:<src> - <target_dir> [container]`` —
           the pull direction: a ``host:path`` first argument plus a
           literal ``-`` in the host slot mark a download, mirroring
           ``kubectl cp <pod>:<src> <dst>``.
    """

    def __init__(self, exec_path: Optional[str] = None,
                 copy_path: Optional[str] = None,
                 timeout: Optional[float] = None):
        self.exec_path = exec_path or os.environ.get(EXEC_PATH_ENV)
        self.copy_path = copy_path or os.environ.get(COPY_PATH_ENV)
        self.timeout = _env_timeout(timeout)
        if not self.exec_path:
            raise FabricError(f"ShellFabric needs {EXEC_PATH_ENV}")

    def _check(self, cmd: str) -> None:
        try:
            res = subprocess.run(cmd, shell=True, capture_output=True,
                                 text=True, timeout=self.timeout)
        except subprocess.TimeoutExpired as exc:
            raise FabricTimeout(f"fabric command timed out after "
                                f"{self.timeout:.0f}s: {cmd}") from exc
        if res.returncode != 0:
            raise FabricExecError(
                f"fabric command failed ({res.returncode}): "
                f"{cmd}\nstderr: {res.stderr[-2000:]}", res.returncode)

    def exec(self, host, cmd, env=None, container=None):
        if env:
            prefix = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
            cmd = f"{prefix} {cmd}"
        target = f"{host} -c {container}" if container else host
        self._check(f"sh {shlex.quote(self.exec_path)} "
                    f"{shlex.quote(target)} {shlex.quote(cmd)}")

    def copy(self, src, host, target_dir, container=None):
        if not self.copy_path:
            raise FabricError(f"ShellFabric needs {COPY_PATH_ENV} to copy")
        extra = f" {shlex.quote(container)}" if container else ""
        self._check(f"sh {shlex.quote(self.copy_path)} {shlex.quote(src)} "
                    f"{shlex.quote(host)} {shlex.quote(target_dir)}{extra}")

    def fetch(self, host, src, target_dir, container=None):
        if not self.copy_path:
            raise FabricError(f"ShellFabric needs {COPY_PATH_ENV} to fetch")
        extra = f" {shlex.quote(container)}" if container else ""
        self._check(f"sh {shlex.quote(self.copy_path)} "
                    f"{shlex.quote(f'{host}:{src}')} - "
                    f"{shlex.quote(target_dir)}{extra}")


def get_fabric(kind: Optional[str] = None, retry=None) -> Fabric:
    """Fabric factory: explicit kind, else ShellFabric when the operator
    rendered an exec wrapper (TPU_OPERATOR_EXEC_PATH set — parity with
    DGL_OPERATOR_KUBEXEC_PATH, dgljob_controller.go:58-63), else local.

    When ``TPU_OPERATOR_OBJECT_STORE`` names a bucket root (or kind is
    'object'), bulk copies are staged through the object store
    (SURVEY §2: GCS dispatch replaces kubectl-cp as the data plane) —
    the control fabric resolved above still carries exec.

    Composition (inside out): control fabric → ChaosFabric when
    ``TPU_OPERATOR_CHAOS`` names a fault plan (launcher/chaos.py) →
    ObjectStoreFabric → RetryingFabric (launcher/retry.py; pass
    ``retry`` to override the env policy, or set TPU_OPERATOR_RETRIES=0
    to disable). Chaos sits *under* retry so every injected fault
    exercises the recovery path the production flake would."""
    kind = kind or os.environ.get("TPU_OPERATOR_FABRIC")
    # the store applies over ANY control fabric: kind selects how exec
    # reaches workers, TPU_OPERATOR_OBJECT_STORE independently selects
    # the bulk-data plane (so kind='shell' + a bucket stages through
    # the bucket, as the docstring promises)
    store_url = os.environ.get("TPU_OPERATOR_OBJECT_STORE")
    if kind == "object" and not store_url:
        raise FabricError("fabric kind 'object' needs "
                          "TPU_OPERATOR_OBJECT_STORE to name the bucket")
    if kind == "object":
        kind = None                       # resolve the control fabric
    if kind == "local":
        control: Fabric = LocalFabric()
    elif kind == "shell" or (kind is None
                             and os.environ.get(EXEC_PATH_ENV)):
        control = ShellFabric()
    elif kind is not None:
        raise FabricError(f"unknown fabric kind {kind!r} "
                          "(expected 'local', 'shell' or 'object')")
    else:
        control = LocalFabric()
    from dgl_operator_tpu_torch.launcher.chaos import plan_from_env
    plan = plan_from_env()
    if plan is not None:
        from dgl_operator_tpu_torch.launcher.chaos import ChaosFabric
        control = ChaosFabric(control, plan)
    fab: Fabric = control
    if store_url:
        from dgl_operator_tpu_torch.launcher.objstore import (
            ObjectStoreFabric, store_from_url)
        fab = ObjectStoreFabric(store_from_url(store_url), control)
    from dgl_operator_tpu_torch.launcher.retry import (RetryPolicy,
                                                       RetryingFabric)
    policy = retry if retry is not None else RetryPolicy.from_env()
    if policy.max_attempts > 1:
        fab = RetryingFabric(fab, policy)
    return fab
