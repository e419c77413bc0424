"""Shared file plumbing for the telemetry artifacts.

The obs artifacts are updated by SEVERAL processes of one run (the
tpurun driver plus every trainer subprocess it launches share one
``obs/`` directory), so the two rules here are: every publish is
atomic (tmp + rename — a reader never sees a torn file), and every
read-merge-write update runs under an advisory cross-process lock so
concurrent flushes from two trainers can't lose each other's update.

The lock is two-layered:

- an ``flock`` on ``.obs.lock`` serializes same-host flushers and is
  released by the kernel when the holder dies — it can never wedge;
- a pid-stamped lock DIRECTORY (``.obs.lock.d``) makes the holder
  visible across hosts sharing the obs volume (flock is unreliable on
  network filesystems). A holder killed mid-flush — exactly what the
  chaos plan's ``train:kill:<step>`` SIGTERM can do — orphans the
  directory; later flushers detect the stale lock (dead owner pid on
  this host, or over-age) and BREAK it instead of wedging forever,
  counting ``obs_lock_broken_total``.

Standard library only: the port's copy of the JAX package's
``obs/_io.py``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import socket
import time
from typing import Optional

LOCK_NAME = ".obs.lock"
LOCK_DIR_NAME = ".obs.lock.d"
OWNER_NAME = "owner"
# a cross-host holder silent this long is presumed dead (flushes are
# sub-second; this bounds how long a lost remote host can block)
STALE_LOCK_S = 30.0
_POLL_S = 0.005


def atomic_write(path: str, data: str) -> None:
    """Publish ``data`` at ``path`` atomically (tmp + rename); the pid
    suffix keeps concurrent writers' tmp files from colliding."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(data)
    os.replace(tmp, path)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        pass   # exists but not ours — alive
    return True


def lock_stale_reason(lock_dir: str,
                      host: Optional[str] = None,
                      stale_s: float = STALE_LOCK_S) -> Optional[str]:
    """Why ``lock_dir`` is safe to break, or None while its holder may
    still be alive: ``dead-pid`` when the stamped owner pid is gone on
    this host, ``over-age`` when the stamp (or, with no owner file yet,
    the directory itself) is older than ``stale_s``."""
    host = host or socket.gethostname()
    owner = read_json(os.path.join(lock_dir, OWNER_NAME), {})
    pid = owner.get("pid")
    if owner.get("host") == host and isinstance(pid, int):
        if not _pid_alive(pid):
            return "dead-pid"
    ts = owner.get("ts")
    if not isinstance(ts, (int, float)):
        try:   # killed between mkdir and the owner stamp
            ts = os.stat(lock_dir).st_mtime
        except OSError:
            return None   # raced with the holder's own release
    if time.time() - ts > stale_s:
        return "over-age"
    return None


def _count_broken(reason: str, lock_dir: str) -> None:
    """Best-effort telemetry for a broken lock (lazy import — this
    module sits beneath the obs package)."""
    try:
        from dgl_operator_tpu_torch.obs import get_obs
        obs = get_obs()
        obs.metrics.counter(
            "obs_lock_broken_total",
            "stale obs flush locks broken (orphaned by a killed "
            "flusher)", labels=("reason",)).inc(reason=reason)
        obs.emit("obs_lock_broken", reason=reason, path=lock_dir)
    except Exception:   # noqa: BLE001 — telemetry never fails the job
        pass


def break_stale_lock(lock_dir: str, host: Optional[str] = None,
                     stale_s: float = STALE_LOCK_S) -> Optional[str]:
    """Break ``lock_dir`` iff it is provably stale; returns the reason
    or None (lock still live)."""
    reason = lock_stale_reason(lock_dir, host=host, stale_s=stale_s)
    if reason is None:
        return None
    shutil.rmtree(lock_dir, ignore_errors=True)
    _count_broken(reason, lock_dir)
    return reason


@contextlib.contextmanager
def dir_lock(directory: str, timeout: float = STALE_LOCK_S):
    """Advisory exclusive lock on ``directory``'s obs artifacts,
    serializing read-merge-write updates across the run's processes.
    flock degrades to a no-op where unavailable; the lock directory
    degrades (loudly never — silently) when the obs directory itself
    vanished mid-run. Stale lock directories are broken, not waited
    on; a live foreign lock still held past ``timeout`` is treated as
    stale too (wedging every later flush is the worse failure)."""
    flock_f = None
    try:
        import fcntl
        flock_f = open(os.path.join(directory, LOCK_NAME), "a")
        fcntl.flock(flock_f, fcntl.LOCK_EX)
    except ImportError:   # pragma: no cover — non-POSIX fallback
        fcntl = None
    except OSError:       # obs dir deleted under us
        flock_f = None
        fcntl = None
    lock_dir = os.path.join(directory, LOCK_DIR_NAME)
    held = False
    deadline = time.monotonic() + timeout
    while True:
        try:
            os.mkdir(lock_dir)
            held = True
            break
        except FileExistsError:
            if break_stale_lock(lock_dir) is not None:
                continue
            if time.monotonic() > deadline:
                shutil.rmtree(lock_dir, ignore_errors=True)
                _count_broken("timeout", lock_dir)
                continue
            time.sleep(_POLL_S)
        except OSError:   # obs dir deleted — flock alone must do
            break
    if held:
        try:
            with open(os.path.join(lock_dir, OWNER_NAME), "w") as f:
                json.dump({"pid": os.getpid(),
                           "host": socket.gethostname(),
                           "ts": time.time()}, f)
        except OSError:
            pass
    try:
        yield
    finally:
        if held:
            shutil.rmtree(lock_dir, ignore_errors=True)
        if flock_f is not None:
            try:
                fcntl.flock(flock_f, fcntl.LOCK_UN)
            except OSError:
                pass
            flock_f.close()


def read_json(path: str, default):
    """Best-effort JSON read: a missing or torn file yields ``default``
    (telemetry merges must survive a crashed previous writer)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return default
