"""Training checkpoints and params-only serving exports.

Both are ``.npz`` archives whose keys are the '/'-joined paths of a
nested dict (``params/layers.0.self.weight``, ...), written atomically
(a temporary file, ``fsync``, then ``os.replace``), with a ``.sha256``
sidecar written after the publish.

- :class:`CheckpointManager` keeps step-indexed training checkpoints
  (``ckpt_<step>.npz``), at most one background write in flight, the
  newest ``max_keep``; :meth:`~CheckpointManager.restore` verifies every
  candidate and falls back past a corrupt newest one. This is the JAX
  package's npz path; its orbax backend, incarnation fences,
  ``quarantine_from`` and ``ServingPromotion`` are not ported
  (``ROADMAP.md``). :class:`RankZeroCheckpoints` shares one manager
  between the processes of a ``torch.distributed`` group.
- :func:`export_for_serving` / :func:`load_params` write and read the
  params tree alone, in the flax layout, so either package reads what
  the other wrote (``models/sage.py`` converts it to and from a
  ``state_dict``).
- :func:`save_state_npz` / :func:`load_state_npz` write and read a
  whole state tree by path.

Leaves are stored under their names, so a restore never depends on the
order of the archive's members.
"""

from __future__ import annotations

import hashlib
import os
import re
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dgl_operator_tpu_torch.obs import get_obs
from dgl_operator_tpu_torch.parallel.collectives import barrier

SERVING_EXPORT = "serving_params.npz"
_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz")
_ORPHAN_RE = re.compile(r"ckpt_\d+\.npz(\.sha256)?\.tmp")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint or export failed verification (checksum mismatch
    against its sidecar, an unreadable archive, or leaves that do not
    match the state skeleton) and nothing older could stand in. A
    partial restore is refused loudly."""


def _sha256_of(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """Host copies of ``tree``'s leaves under their '/'-joined paths
    (copies: a background write must not see later in-place updates)."""
    if isinstance(tree, dict):
        # sorted keys: the leaf order jax's tree flattening gives
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k), out)
        return
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    out[prefix] = np.array(tree)


def _write_tree_npz(path: str, tree: Any) -> int:
    """Atomic path-keyed npz write of a nested dict of arrays (numpy or
    tensors); returns the leaf count."""
    arrays: Dict[str, np.ndarray] = {}
    _flatten(tree, "", arrays)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _write_npz(path, arrays)
    return len(arrays)


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Atomic publish: a temporary file, ``fsync``, then ``os.replace``
    (a write cut short never leaves a truncated archive at ``path``)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_tree_npz(path: str) -> Any:
    """Rebuild the nested dict a :func:`_write_tree_npz` archive
    describes (keys split on '/')."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return out


def _write_sidecar(path: str) -> str:
    """(Re)write ``path``'s sha256 sidecar atomically; returns the
    digest."""
    digest = _sha256_of(path)
    stmp = path + ".sha256.tmp"
    with open(stmp, "w") as f:
        f.write(digest + "\n")
    os.replace(stmp, path + ".sha256")
    return digest


def _check_sidecar(path: str, what: str) -> None:
    """Raise :class:`CheckpointCorrupt` when ``path`` disagrees with its
    sha256 sidecar; a file without one passes unverified."""
    sidecar = path + ".sha256"
    if not os.path.exists(sidecar):
        return
    try:
        with open(sidecar) as f:
            expected = f.read().strip().split()[0]
    except (OSError, IndexError):
        expected = ""
    if expected and _sha256_of(path) != expected:
        raise CheckpointCorrupt(f"{path}: sha256 mismatch against its "
                                f"sidecar (torn or corrupted {what})")


def _unflatten_like(like: Any, prefix: str, flat: Dict[str, np.ndarray]):
    """``like``'s structure with each leaf taken from ``flat`` by path: a
    tensor leaf comes back as a tensor of its dtype on its device, any
    other leaf as the stored array."""
    if isinstance(like, dict):
        return {k: _unflatten_like(v, f"{prefix}/{k}" if prefix else str(k),
                                   flat) for k, v in like.items()}
    arr = flat[prefix]
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
    return arr


class CheckpointManager:
    """Step-indexed training checkpoints under ``directory``; keeps the
    newest ``max_keep``.

    ``save``/``close`` are called from one thread (the training loop);
    the background writer has one worker, and every save drains the
    previous write first, so at most one write is in flight.
    """

    def __init__(self, directory: str, max_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_keep = int(max_keep)
        self._writer: Optional[ThreadPoolExecutor] = None
        self._last: Optional[Future] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, wait: bool = True) -> None:
        """Persist ``state`` (a nested dict of tensors or arrays) as
        ``ckpt_<step>.npz``. The leaves are copied to the host before
        this returns; with ``wait=False`` the disk write finishes on a
        background thread, and its error, if any, is raised by the next
        ``save`` or by :meth:`close`."""
        mode = "sync" if wait else "async"
        obs = get_obs()
        obs.metrics.counter("ckpt_saves_total", "checkpoint saves",
                            labels=("mode",)).inc(mode=mode)
        obs.emit("ckpt_save", step=int(step), mode=mode)
        arrays: Dict[str, np.ndarray] = {}
        _flatten(state, "", arrays)
        # joining the previous write bounds the host copies at two and
        # surfaces a failing writer within one checkpoint interval
        self._drain()
        if wait:
            self._write(int(step), arrays)
            return
        if self._writer is None:
            self._writer = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer")
        self._last = self._writer.submit(self._write, int(step), arrays)

    def _drain(self) -> None:
        fut, self._last = self._last, None
        if fut is not None:
            fut.result()

    def _write(self, step: int, arrays: Dict[str, np.ndarray]) -> None:
        t0 = time.perf_counter()
        path = os.path.join(self.directory, f"ckpt_{step}.npz")
        _write_npz(path, arrays)
        # the sidecar comes after the publish: a crash in between leaves
        # a sidecar-less archive, which restore reads unverified
        _write_sidecar(path)
        self._gc()
        get_obs().metrics.histogram(
            "ckpt_save_seconds",
            "checkpoint write wall-clock (disk time)").observe(
                time.perf_counter() - t0)

    def close(self) -> None:
        """Drain the in-flight background write, re-raising its error
        (idempotent)."""
        if self._writer is None:
            return
        try:
            self._drain()
        finally:
            self._writer.shutdown(wait=True)
            self._writer = None

    # ------------------------------------------------------------------
    def _candidates(self) -> List[Tuple[int, str]]:
        """``(step, path)`` of every checkpoint, oldest first."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted((int(m.group(1)), os.path.join(self.directory, fn))
                      for fn in names if (m := _CKPT_RE.fullmatch(fn)))

    def latest_step(self) -> Optional[int]:
        cands = self._candidates()
        return cands[-1][0] if cands else None

    @staticmethod
    def _load_verified(path: str, want: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
        """One archive, checked against its sidecar and against the
        skeleton's leaf names and shapes; any failure raises
        :class:`CheckpointCorrupt`."""
        _check_sidecar(path, "write")
        try:
            with np.load(path) as data:
                flat = {k: data[k] for k in data.files}
        except Exception as exc:   # zip, key and value errors alike
            raise CheckpointCorrupt(
                f"{path}: unreadable npz archive ({exc})") from exc
        if flat.keys() != want.keys():
            raise CheckpointCorrupt(
                f"{path}: partial restore refused — the archive holds "
                f"{len(flat)} leaves, the state skeleton {len(want)}; "
                f"missing {sorted(want.keys() - flat.keys())[:5]}, "
                f"unexpected {sorted(flat.keys() - want.keys())[:5]}")
        bad = [k for k in want if flat[k].shape != want[k].shape]
        if bad:
            raise CheckpointCorrupt(
                f"{path}: leaf shapes differ from the state skeleton at "
                f"{bad[:5]}")
        return flat

    def restore(self, step: Optional[int], like: Any) -> Tuple[int, Any]:
        """Restore ``step`` (the newest good one when None) into the
        structure of ``like``; returns ``(step, state)``, or ``(0,
        like)`` when there is no checkpoint and ``step`` is None.

        Every candidate is verified against its sidecar and the
        skeleton's leaves. With ``step=None`` a corrupt newest
        checkpoint falls back to the previous one (counted in
        ``ckpt_restore_fallback_total``, an ``ckpt_restore_fallback``
        event each); when no candidate is good, or an explicit step is
        corrupt, :class:`CheckpointCorrupt` is raised. An explicit step
        that does not exist raises ``FileNotFoundError``."""
        t0 = time.perf_counter()
        cands = self._candidates()
        if step is not None:
            cands = [c for c in cands if c[0] == int(step)]
            if not cands:
                raise FileNotFoundError(f"no checkpoint for step {step} "
                                        f"under {self.directory}")
        elif not cands:
            return 0, like
        want: Dict[str, np.ndarray] = {}
        _flatten(like, "", want)
        obs = get_obs()
        last_err: Optional[CheckpointCorrupt] = None
        for s, path in reversed(cands):
            try:
                flat = self._load_verified(path, want)
            except CheckpointCorrupt as exc:
                last_err = exc
                obs.metrics.counter(
                    "ckpt_restore_fallback_total",
                    "restores that skipped a corrupt/partial "
                    "checkpoint and fell back to an older one").inc()
                obs.emit("ckpt_restore_fallback", step=s, path=path,
                         error=str(exc)[:300])
                continue
            seconds = time.perf_counter() - t0
            obs.metrics.counter("ckpt_restores_total",
                                "checkpoint restores").inc()
            obs.metrics.histogram(
                "ckpt_restore_seconds",
                "checkpoint restore wall-clock").observe(seconds)
            obs.emit("ckpt_restore", step=s, seconds=round(seconds, 4))
            return s, _unflatten_like(like, "", flat)
        raise CheckpointCorrupt(
            f"no restorable checkpoint under {self.directory}: all "
            f"{len(cands)} candidate(s) failed verification — last "
            f"error: {last_err}") from last_err

    def _gc(self) -> None:
        """Keep the newest ``max_keep`` checkpoints; sweep temporary
        files a write cut short left behind."""
        steps = []
        for fn in os.listdir(self.directory):
            if (m := _CKPT_RE.fullmatch(fn)):
                steps.append(int(m.group(1)))
            elif _ORPHAN_RE.fullmatch(fn):
                try:
                    os.remove(os.path.join(self.directory, fn))
                except OSError:
                    pass
        for s in sorted(steps)[: -self.max_keep]:
            for suffix in ("", ".sha256"):
                try:
                    os.remove(os.path.join(self.directory,
                                           f"ckpt_{s}.npz{suffix}"))
                except OSError:
                    pass


class RankZeroCheckpoints:
    """The processes of a ``torch.distributed`` group sharing one
    checkpoint directory: rank 0 writes each checkpoint synchronously,
    then every rank waits at a barrier. So a checkpoint that any rank
    can read is whole on disk before any rank steps past it, and a
    resume finds the same newest step on every rank."""

    def __init__(self, manager: CheckpointManager, rank: int):
        self.manager = manager
        self.rank = int(rank)

    def save(self, step: int, state: Any, wait: bool = True) -> None:
        """Publish ``state`` as ``ckpt_<step>.npz`` from rank 0 and wait
        for every rank; ``wait`` is ignored (the write is synchronous)."""
        if self.rank == 0:
            self.manager.save(step, state, wait=True)
        barrier()

    def close(self) -> None:
        if self.rank == 0:
            self.manager.close()


# ----------------------------------------------------------------------
def train_state(model: torch.nn.Module,
                optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The checkpointed state of a trainer: ``{"params": the model's
    state dict, "opt": {"<i>": Adam's per-parameter state}}``. A
    parameter Adam has not stepped yet gets zero moments at step 0, the
    state Adam would start from, so the tree is also the skeleton a
    restore is checked against."""
    opt: Dict[str, Any] = {}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for i, p in enumerate(params):
        st = optimizer.state.get(p) or {}
        opt[str(i)] = {
            "step": st.get("step", torch.zeros((), dtype=torch.float32)),
            "exp_avg": st.get("exp_avg", torch.zeros_like(p)),
            "exp_avg_sq": st.get("exp_avg_sq", torch.zeros_like(p))}
    return {"params": model.state_dict(), "opt": opt}


def load_train_state(model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer,
                     state: Dict[str, Any]) -> None:
    """Load a :func:`train_state` tree back into ``model`` and
    ``optimizer`` (Adam's step counters stay float32 host scalars, as
    Adam keeps them)."""
    model.load_state_dict(state["params"])
    sd = optimizer.state_dict()
    sd["state"] = {
        int(i): {"step": st["step"].detach().cpu().to(torch.float32),
                 "exp_avg": st["exp_avg"],
                 "exp_avg_sq": st["exp_avg_sq"]}
        for i, st in state["opt"].items()}
    optimizer.load_state_dict(sd)


# ----------------------------------------------------------------------
def export_for_serving(path: str, params: Any) -> str:
    """Write the params tree alone, keyed by tree path, atomically, plus
    a sha256 sidecar. ``path`` may be a directory (the file is then
    ``serving_params.npz`` inside it). Returns the file path written."""
    if path.endswith(os.sep) or os.path.isdir(path):
        path = os.path.join(path, SERVING_EXPORT)
    n = _write_tree_npz(path, params)
    _write_sidecar(path)
    get_obs().emit("serving_export", path=path, leaves=n)
    return path


def load_params(path: str) -> Any:
    """Load an export back into the nested params dict of numpy arrays.
    ``path`` may be the file or its directory. A sha256 sidecar, when
    present, is verified; sidecar-less archives load unverified."""
    if os.path.isdir(path):
        path = os.path.join(path, SERVING_EXPORT)
    _check_sidecar(path, "serving export")
    return _read_tree_npz(path)


def save_state_npz(path: str, state: Any) -> str:
    """Path-keyed save of a whole state tree (params and optimizer
    moments; tensors are copied to the host). Returns ``path``."""
    n = _write_tree_npz(path, state)
    get_obs().emit("sharded_state_save", path=path, leaves=n)
    return path


def load_state_npz(path: str) -> Any:
    """Read a :func:`save_state_npz` archive back into nested dicts of
    numpy arrays."""
    return _read_tree_npz(path)
