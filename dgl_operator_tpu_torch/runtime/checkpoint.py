"""Training checkpoints, params-only serving exports and their fences.

Both are ``.npz`` archives whose keys are the '/'-joined paths of a
nested dict (``params/layers.0.self.weight``, ...), written atomically
(a temporary file, ``fsync``, then ``os.replace``), with a ``.sha256``
sidecar written after the publish.

- :class:`CheckpointManager` keeps step-indexed training checkpoints
  (``ckpt_<step>.npz``), at most one background write in flight, the
  newest ``max_keep``; :meth:`~CheckpointManager.restore` verifies every
  candidate and falls back past a corrupt newest one. With an
  incarnation epoch (``fence_epoch``, or the elastic launcher's
  ``TPU_OPERATOR_ELASTIC_EPOCH``) checkpoints publish under
  ``epoch-<k>/`` and the manager claims ``fence.json`` at open: a
  zombie of an older incarnation is refused at open and at every
  publish (:class:`FencedOut`), and a restore falls back across the
  older epochs' directories. :meth:`~CheckpointManager.quarantine_from`
  moves every checkpoint at or past a numerics fault's step aside.
  :class:`RankZeroCheckpoints` shares one manager between the
  processes of a ``torch.distributed`` group. The chaos plan's
  ``ckpt:corrupt`` stomps a published archive's bytes after its sidecar
  (the restore then falls back past it), and ``promote:bad`` poisons a
  staged serving candidate after its checksum (``launcher/chaos.py``).
  The JAX package's orbax backend is a JAX library and is not ported.
- :func:`export_for_serving` / :func:`load_params` write and read the
  params tree alone, in the flax layout, so either package reads what
  the other wrote (``models/sage.py`` converts it to and from a
  ``state_dict``). :class:`ServingPromotion` walks a candidate export
  through stage → canary → commit or rollback behind the promotion
  directory's fence; its ``fence.json`` and ``promotion.json`` are the
  JAX package's format, so each package reads the other's.
- :func:`save_state_npz` / :func:`load_state_npz` write and read a
  whole state tree by path.

Leaves are stored under their names, so a restore never depends on the
order of the archive's members. A trainer with sharded state
(``parallel/dp.py::ShardPlan``) writes the logical tree of
:func:`train_state`: each weight and moment reassembled from its shards
and de-padded by ``parallel/shardrules.py::unpad_leaf``, the bits a
replicated run writes, so any mesh shape restores it.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dgl_operator_tpu_torch.launcher import chaos
from dgl_operator_tpu_torch.obs import get_obs
from dgl_operator_tpu_torch.parallel.bootstrap import FENCE_EPOCH_ENV
from dgl_operator_tpu_torch.parallel.collectives import barrier

SERVING_EXPORT = "serving_params.npz"
FENCE_FILE = "fence.json"
PROMOTION_LOG = "promotion.json"
_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz")
_ORPHAN_RE = re.compile(r"ckpt_\d+\.npz(\.sha256)?\.tmp")
_EPOCH_RE = re.compile(r"epoch-(\d+)")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint or export failed verification (checksum mismatch
    against its sidecar, an unreadable archive, or leaves that do not
    match the state skeleton) and nothing older could stand in. A
    partial restore is refused loudly."""


class FencedOut(RuntimeError):
    """This manager's incarnation lost the directory fence: a newer
    incarnation (or promoter) owns it, and this one must stop
    publishing."""


def read_fence(directory: str) -> Optional[dict]:
    """The directory's fence record (``{"epoch", "token"}``) or None."""
    try:
        with open(os.path.join(directory, FENCE_FILE)) as f:
            d = json.load(f)
        return d if isinstance(d, dict) and "epoch" in d else None
    except (OSError, ValueError):
        return None


def resolve_fence_epoch(explicit: Optional[int] = None) -> Optional[int]:
    """The incarnation epoch this process checkpoints under: ``explicit``
    when given, else the elastic launcher's ``TPU_OPERATOR_ELASTIC_EPOCH``,
    else None (the unfenced flat layout)."""
    if explicit is not None:
        return int(explicit)
    v = os.environ.get(FENCE_EPOCH_ENV)
    return int(v) if v not in (None, "") else None


def _write_fence(directory: str, epoch: int, token: str) -> None:
    tmp = os.path.join(directory, FENCE_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"epoch": epoch, "token": token}, f)
    os.replace(tmp, os.path.join(directory, FENCE_FILE))


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


def _write_npz(path: str, arrays: Dict[str, np.ndarray],
               gate: Optional[Callable[[], None]] = None) -> None:
    """Atomic publish: a temporary file, ``fsync``, then ``os.replace``
    (a write cut short never leaves a truncated archive at ``path``).
    ``gate()``, when given, runs right before the rename and may refuse
    the publish by raising."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    if gate is not None:
        gate()
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


def _maybe_chaos_corrupt(path: str, step: int) -> None:
    """The chaos ``ckpt:corrupt:<step>`` edge: stomp the just-published
    archive's first bytes while its sidecar keeps the true digest, so
    the next restore detects the mismatch and falls back."""
    plan = chaos.proc_plan()
    if plan is None:
        return
    rule = plan.take_ckpt_corrupt(step, chaos.my_host_name())
    if rule is None:
        return
    with open(path, "r+b") as f:
        f.seek(0)
        f.write(b"\x00CHAOS-CKPT-CORRUPT\x00")
    chaos.count_fault("ckpt", "corrupt", step=step, path=path,
                      rule=repr(rule))


def _maybe_chaos_poison(path: str) -> None:
    """The chaos ``promote:bad`` edge: rewrite the staged candidate with
    NaN in every float leaf and refresh its sidecar, so the archive
    passes its checksum and only the canary's detectors can catch it."""
    plan = chaos.proc_plan()
    if plan is None:
        return
    rule = plan.take_promote_bad()
    if rule is None:
        return
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    _write_npz(path, {k: (np.full_like(a, np.nan)
                          if np.issubdtype(a.dtype, np.floating) else a)
                      for k, a in flat.items()})
    _write_sidecar(path)
    chaos.count_fault("promote", "bad", path=path, rule=repr(rule))


class CheckpointManager:
    """Step-indexed training checkpoints under ``directory``; keeps the
    newest ``max_keep`` of the active directory.

    With ``fence_epoch`` (or ``TPU_OPERATOR_ELASTIC_EPOCH``) set,
    checkpoints publish under ``epoch-<k>/`` and the manager claims
    ``fence.json`` (epoch and a random token) at open; a newer epoch's
    fence refuses the open, and every publish re-reads the fence right
    before its rename (:class:`FencedOut` for a zombie).

    ``save``/``close`` are called from one thread (the training loop);
    the background writer has one worker, and every save drains the
    previous write first, so at most one write is in flight.
    """

    def __init__(self, directory: str, max_keep: int = 3,
                 fence_epoch: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_keep = int(max_keep)
        self.fence_epoch = resolve_fence_epoch(fence_epoch)
        self._writer: Optional[ThreadPoolExecutor] = None
        self._last: Optional[Future] = None
        self._fence_token: Optional[str] = None
        if self.fence_epoch is not None:
            self._fence_token = os.urandom(8).hex()
            self._claim_fence()
            self._active_dir = os.path.join(
                self.directory, f"epoch-{self.fence_epoch}")
            os.makedirs(self._active_dir, exist_ok=True)
        else:
            self._active_dir = self.directory

    # ---------------------------------------------------------- fence
    def _claim_fence(self) -> None:
        """Refuse to open when a newer epoch holds the fence (a zombie
        dies before it restores anything); else stamp ``fence.json``
        with this incarnation's epoch and token (the last same-epoch
        opener wins the token, so a superseded twin is fenced out at
        publish)."""
        cur = read_fence(self.directory)
        if cur is not None and int(cur.get("epoch", -1)) > self.fence_epoch:
            raise FencedOut(
                f"checkpoint dir {self.directory} is fenced at epoch "
                f"{cur['epoch']}; this trainer's incarnation epoch "
                f"{self.fence_epoch} is stale — a newer incarnation "
                "owns the directory")
        _write_fence(self.directory, self.fence_epoch, self._fence_token)
        get_obs().emit("ckpt_fenced", epoch=self.fence_epoch,
                       dir=self.directory)

    def _check_fence(self) -> None:
        """The publication gate: a fence that moved on (a newer epoch, or
        a fresher same-epoch claim) rejects the publish."""
        if self.fence_epoch is None:
            return
        cur = read_fence(self.directory)
        if (cur is not None
                and int(cur.get("epoch", -1)) == self.fence_epoch
                and cur.get("token") == self._fence_token):
            return
        obs = get_obs()
        obs.metrics.counter(
            "ckpt_fence_rejections_total",
            "checkpoint publications rejected by the fencing token "
            "(zombie incarnations)").inc()
        obs.emit("ckpt_fence_rejected", epoch=self.fence_epoch,
                 current_epoch=(cur or {}).get("epoch"))
        raise FencedOut(
            f"checkpoint publication rejected: fence is at epoch "
            f"{(cur or {}).get('epoch')} (ours: {self.fence_epoch}) — "
            "a zombie incarnation must not overwrite newer state")

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
        obs.emit("ckpt_save", step=int(step), mode=mode,
                 epoch=self.fence_epoch)
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
        path = os.path.join(self._active_dir, f"ckpt_{step}.npz")
        # the fence gate sits right before the rename: the publish, not
        # the wasted write, is what a zombie is denied
        _write_npz(path, arrays, gate=self._check_fence)
        # the sidecar comes after the publish: a crash in between leaves
        # a sidecar-less archive, which restore reads unverified
        _write_sidecar(path)
        _maybe_chaos_corrupt(path, step)
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
    def _candidates(self) -> List[Tuple[int, int, str]]:
        """``(epoch, step, path)`` of every checkpoint under the root,
        ascending; the flat (unfenced) layout sorts as epoch -1. Epoch
        outranks step: a newer incarnation's checkpoint is the job's
        trajectory even at a lower step."""
        out: List[Tuple[int, int, str]] = []

        def scan(d: str, epoch: int) -> None:
            try:
                names = os.listdir(d)
            except OSError:
                return
            out.extend((epoch, int(m.group(1)), os.path.join(d, fn))
                       for fn in names if (m := _CKPT_RE.fullmatch(fn)))

        scan(self.directory, -1)
        try:
            subs = os.listdir(self.directory)
        except OSError:
            subs = []
        for fn in subs:
            if (m := _EPOCH_RE.fullmatch(fn)) and \
                    os.path.isdir(os.path.join(self.directory, fn)):
                scan(os.path.join(self.directory, fn), int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        cands = self._candidates()
        return cands[-1][1] if cands else None

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
        checkpoint falls back to the previous one, across older epoch
        directories too (counted in ``ckpt_restore_fallback_total``, an
        ``ckpt_restore_fallback`` event each); when no candidate is
        good, or an explicit step is corrupt, :class:`CheckpointCorrupt`
        is raised. An explicit step that does not exist raises
        ``FileNotFoundError``."""
        t0 = time.perf_counter()
        cands = self._candidates()
        if step is not None:
            cands = [c for c in cands if c[1] == int(step)]
            if not cands:
                raise FileNotFoundError(f"no checkpoint for step {step} "
                                        f"under {self.directory}")
        elif not cands:
            return 0, like
        want: Dict[str, np.ndarray] = {}
        _flatten(like, "", want)
        obs = get_obs()
        last_err: Optional[CheckpointCorrupt] = None
        for epoch, s, path in reversed(cands):
            try:
                flat = self._load_verified(path, want)
            except CheckpointCorrupt as exc:
                last_err = exc
                obs.metrics.counter(
                    "ckpt_restore_fallback_total",
                    "restores that skipped a corrupt/partial "
                    "checkpoint and fell back to an older one").inc()
                obs.emit("ckpt_restore_fallback", step=s, epoch=epoch,
                         path=path, error=str(exc)[:300])
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

    def quarantine_from(self, step: int) -> Optional[int]:
        """The numerics-fault rollback: every checkpoint at global step
        >= ``step`` may hold post-fault state, so it is moved aside
        (``ckpt_<s>.npz`` -> ``ckpt_<s>.npz.bad``, sidecar included;
        kept as evidence, never a restore candidate) and restore lands
        on the last good one. Drains the in-flight background write
        first (it may be publishing a bad step). Returns the newest
        surviving step, or None."""
        self._drain()
        quarantined = []
        for _, s, path in self._candidates():
            if s < step:
                continue
            for suffix in ("", ".sha256"):
                try:
                    os.replace(path + suffix, path + suffix + ".bad")
                except OSError:
                    pass
            quarantined.append(int(s))
        obs = get_obs()
        if quarantined:
            obs.metrics.counter(
                "ckpt_quarantined_total",
                "checkpoints moved aside by a numerics-fault "
                "rollback").inc(len(quarantined))
        survivor = self.latest_step()
        obs.emit("ckpt_quarantined", from_step=int(step),
                 steps=quarantined, rolled_back_to=survivor)
        return survivor

    def _gc(self) -> None:
        """Keep the newest ``max_keep`` checkpoints of the active
        directory (older epochs' last checkpoints are the fallback
        history and no longer grow); sweep temporary files a write cut
        short left behind."""
        steps = []
        for fn in os.listdir(self._active_dir):
            if (m := _CKPT_RE.fullmatch(fn)):
                steps.append(int(m.group(1)))
            elif _ORPHAN_RE.fullmatch(fn):
                try:
                    os.remove(os.path.join(self._active_dir, fn))
                except OSError:
                    pass
        for s in sorted(steps)[: -self.max_keep]:
            for suffix in ("", ".sha256"):
                try:
                    os.remove(os.path.join(self._active_dir,
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

    @property
    def directory(self) -> str:
        return self.manager.directory

    def save(self, step: int, state: Any, wait: bool = True) -> None:
        """Publish ``state`` as ``ckpt_<step>.npz`` from rank 0 and wait
        for every rank; ``wait`` is ignored (the write is synchronous)."""
        if self.rank == 0:
            self.manager.save(step, state, wait=True)
        barrier()

    def quarantine_from(self, step: int) -> Optional[int]:
        """Rank 0 moves the checkpoints at or past ``step`` aside
        (:meth:`CheckpointManager.quarantine_from`) and returns the
        survivor; the other ranks touch nothing and return None. No
        barrier: a faulting rank must not wait on one still stepping."""
        if self.rank == 0:
            return self.manager.quarantine_from(step)
        return None

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


# ----------------------------------------------------------------------
class ServingPromotion:
    """Fenced rolling promotion of a serving export.

    ``fence.json`` in the promotion directory records the epoch of the
    live params, and a candidate walks stage → canary → commit to
    advance it. :meth:`stage` writes the candidate under
    ``candidate-epoch-<k>/`` (k = incumbent epoch + 1) with its sha256
    sidecar; the router's canary serves it to a slice of traffic;
    :meth:`commit` advances the fence to k and publishes the candidate
    as the live export, :meth:`rollback` quarantines it (``.bad``) and
    leaves the incumbent untouched. A commit whose fence moved since the
    stage (a concurrent promoter won) raises :class:`FencedOut`."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        cur = read_fence(self.directory)
        self.incumbent_epoch = int(cur["epoch"]) if cur else 0
        self._token = os.urandom(8).hex()
        self.candidate_epoch: Optional[int] = None
        self.candidate_dir: Optional[str] = None

    def stage(self, params: Any) -> str:
        """Write ``params`` as the epoch-(incumbent + 1) candidate
        export; returns its npz path (a canary loads it with
        :func:`load_params`, which verifies the sidecar)."""
        self.candidate_epoch = self.incumbent_epoch + 1
        self.candidate_dir = os.path.join(
            self.directory, f"candidate-epoch-{self.candidate_epoch}")
        os.makedirs(self.candidate_dir, exist_ok=True)
        path = export_for_serving(self.candidate_dir, params)
        _maybe_chaos_poison(path)
        get_obs().emit("ckpt_promote_staged", epoch=self.candidate_epoch,
                       path=path)
        return path

    def _log_outcome(self, action: str, reason: str = "") -> None:
        log_path = os.path.join(self.directory, PROMOTION_LOG)
        history = promotion_history(self.directory)
        history.append({"epoch": self.candidate_epoch, "action": action,
                        "reason": reason, "ts": time.time()})
        tmp = log_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(history, f)
        os.replace(tmp, log_path)
        get_obs().metrics.counter(
            "ckpt_promotions_total",
            "serving-checkpoint promotion outcomes",
            labels=("result",)).inc(result=action)

    def commit(self) -> str:
        """Advance the fence to the candidate's epoch and publish the
        candidate as the live export (an atomic rename within the
        promotion directory). Returns the live export's path."""
        if self.candidate_epoch is None or self.candidate_dir is None:
            raise RuntimeError("no candidate staged")
        cur = read_fence(self.directory)
        if cur is not None and int(cur.get("epoch", 0)) \
                >= self.candidate_epoch:
            get_obs().metrics.counter(
                "ckpt_fence_rejections_total",
                "checkpoint publications rejected by the fencing "
                "token (zombie incarnations)").inc()
            raise FencedOut(
                f"promotion fence moved to epoch {cur['epoch']} since "
                f"stage (candidate epoch {self.candidate_epoch}) — a "
                "concurrent promoter won; this candidate is stale")
        _write_fence(self.directory, self.candidate_epoch, self._token)
        live = os.path.join(self.directory, SERVING_EXPORT)
        cand = os.path.join(self.candidate_dir, SERVING_EXPORT)
        os.replace(cand, live)
        try:
            os.replace(cand + ".sha256", live + ".sha256")
        except OSError:
            pass
        self._log_outcome("promoted")
        get_obs().emit("ckpt_promote_committed",
                       epoch=self.candidate_epoch, path=live)
        self.incumbent_epoch = self.candidate_epoch
        self.candidate_epoch = self.candidate_dir = None
        return live

    def rollback(self, reason: str = "") -> None:
        """Quarantine the candidate (``.bad`` rename, evidence kept)
        without touching the fence or the live export."""
        if self.candidate_epoch is None or self.candidate_dir is None:
            raise RuntimeError("no candidate staged")
        try:
            os.replace(self.candidate_dir, self.candidate_dir + ".bad")
        except OSError:
            pass
        self._log_outcome("rolled_back", reason=reason)
        get_obs().emit("ckpt_promote_rolled_back",
                       epoch=self.candidate_epoch, reason=reason)
        self.candidate_epoch = self.candidate_dir = None


def promotion_history(directory: str) -> List[dict]:
    """The promotion directory's outcome ledger, newest last."""
    try:
        with open(os.path.join(directory, PROMOTION_LOG)) as f:
            h = json.load(f)
        return h if isinstance(h, list) else []
    except (OSError, ValueError):
        return []
