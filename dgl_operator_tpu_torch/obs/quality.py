"""Model-health plane — the numerics sentry, divergence detection and
the halt → rollback response, as the JAX package's ``obs/quality.py``.

- **In-step stats** (:func:`grad_stats`, :func:`dp_slot_stats`): each
  training step computes a few device scalars — the global gradient
  and parameter norms, the update ratio, the count of non-finite
  gradient elements and, for the partition-parallel step, each slot's
  loss and non-finite count, so a fault names its partition. They are
  plain torch ops on the step's tensors: no host sync, no tensor made on
  the host, so a CUDA graph of K steps captures them, and they only
  read what the step computed, so a trajectory is bit-identical with
  the sentry on or off.
- **Off-critical-path fetch** (:class:`StatsTap`): the loop pushes each
  call's stats; the push packs them into one tensor, starts its copy
  into pinned host memory and records a ``torch.cuda.Event`` behind it.
  :meth:`StatsTap.poll` reads only entries whose event has completed
  (``query()``), so reading the stats never waits for the call in
  flight, except past ``max_lag`` entries. On the CPU an entry is
  always ready.
- **Rolling detectors and the response** (:class:`QualityMonitor`): a
  NaN/Inf sentry with first-bad-step and partition attribution, an EWMA
  loss-divergence z-score, a grad-norm explosion check against the
  rolling median, and a plateau detector. A non-finite detection acts
  by ``quality_action``: ``warn`` keeps training, ``halt`` raises
  :class:`NumericsFault`, ``rollback`` also quarantines every
  checkpoint at or past the first bad step
  (``CheckpointManager.quarantine_from``) and leaves a workspace fault
  marker (:func:`halt_for_rollback`).

- **The chaos ``numerics:nan`` drill** (:class:`NumericsInjector`): at
  the plan's step the loop poisons one parameter with NaN in place, so
  the next step's backward produces non-finite gradients through the
  real kernels; it fires once per workspace.

- **The analytics roll-up** (:func:`model_health_summary`): a job
  view's faults, divergences, rollbacks and last quality gauges, which
  ``obs/analyze.py`` reports.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dgl_operator_tpu_torch.autotune.knobs import validate
from dgl_operator_tpu_torch.obs import get_obs
from dgl_operator_tpu_torch.parallel.bootstrap import RANK_ENV

# the workspace fault marker a halting trainer writes for the launcher's
# relaunch loop (the JAX package's file name and format)
FAULT_MARKER = ".numerics_fault.json"
# the shared workspace directory the launcher exports
WORKSPACE_ENV = "TPU_OPERATOR_WORKSPACE"
# the workspace marker of a numerics:nan drill that has fired
NUMERICS_FIRED_MARKER = ".chaos_numerics_fired"
# retryable exit status for entry scripts that catch NumericsFault
NUMERICS_FAULT_EXIT = 76
# the scalar stats of every step, in the order steps return them
STAT_KEYS = ("grad_norm", "param_norm", "update_ratio", "nonfinite")
# counts, returned to the host as integers
_COUNT_KEYS = ("nonfinite", "part_nonfinite")

_EPS = 1e-12


class NumericsFault(RuntimeError):
    """The sentry saw non-finite training state and ``quality_action``
    is ``halt`` or ``rollback``: the trainer stops at the call boundary.
    ``step`` is the first bad global step observed, ``partition`` the
    attributed partition (None when nothing sharper than "everywhere"
    was found)."""

    def __init__(self, msg: str, step: int,
                 partition: Optional[int] = None,
                 kind: str = "nonfinite"):
        super().__init__(msg)
        self.step = int(step)
        self.partition = partition
        self.kind = kind


# ---------------------------------------------------------------------
# in-step stats: device tensors, no host sync
# ---------------------------------------------------------------------
def _flat(tensors: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """Every tensor of ``tensors`` (Nones skipped) as one float32
    vector (the tensor itself, flattened, when there is one)."""
    parts = [t.detach().reshape(-1) for t in tensors if t is not None]
    parts = [t if t.dtype == torch.float32 else t.float() for t in parts]
    if not parts:
        return torch.zeros(0)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _nonfinite(flat: torch.Tensor) -> torch.Tensor:
    return flat.numel() - torch.isfinite(flat).sum()


def nonfinite_count(tensors) -> torch.Tensor:
    """The non-finite elements of ``tensors`` (a slot's raw gradients
    and its loss, for ``part_nonfinite``), as a 0-d tensor."""
    return _nonfinite(_flat(tensors))


def grad_part(grads, loss: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
    """``grad_norm`` and ``nonfinite`` of ``grads`` (a sequence of
    tensors), the loss counted too when given, from one copy of them
    (taken before the optimizer's step)."""
    tail = [] if loss is None else [loss.reshape(1)]
    flat = _flat(list(grads) + tail)
    g = flat[:-1] if tail else flat
    return {"grad_norm": torch.linalg.vector_norm(g),
            "nonfinite": _nonfinite(flat)}


def update_part(updates, params) -> Dict[str, torch.Tensor]:
    """``param_norm`` and ``update_ratio`` of the parameters after the
    update and of the update."""
    pn = torch.linalg.vector_norm(_flat(params))
    return {"param_norm": pn,
            "update_ratio": torch.linalg.vector_norm(_flat(updates))
            / (pn + _EPS)}


def grad_stats(loss: torch.Tensor, grads, updates, params
               ) -> Dict[str, torch.Tensor]:
    """The single-replica stats (``SampledTrainer``'s steps): global
    gradient and parameter norms, the update ratio, and the non-finite
    element count over the raw gradients and the loss. ``grads``,
    ``updates`` and ``params`` are sequences of tensors (the parameters
    after the update, as in the JAX package)."""
    return {**grad_part(grads, loss), **update_part(updates, params)}


def dp_slot_stats(loss_local: torch.Tensor, grads_raw, grads_reduced,
                  updates, params) -> Dict[str, torch.Tensor]:
    """One data-parallel slot's stats: ``part_loss`` / ``part_nonfinite``
    are the slot's own (``[1]`` each; the partition-parallel step stacks
    its slots' into ``[P]``), while the norms and ``nonfinite`` come
    from the reduced gradients and the updated parameters."""
    return {**grad_part(grads_reduced), **update_part(updates, params),
            "part_loss": loss_local.detach().float().reshape(1),
            "part_nonfinite": nonfinite_count(
                [*grads_raw, loss_local.reshape(1)]).reshape(1)}


class ParamDelta:
    """The update an optimizer step applies, without touching a
    parameter or gradient: :meth:`before` copies the parameters into one
    flat buffer (allocated at its first call, which a trainer makes
    eagerly, before any CUDA graph capture), :meth:`stats` gives the
    parameters' norm and the update ratio after the step. The
    parameters are read through flat views of their storage, taken
    once, which in-place updates and ``load_state_dict`` keep valid."""

    def __init__(self, params: Sequence[torch.Tensor]):
        self.params = list(params)
        self._buf: Optional[torch.Tensor] = None
        self.rebind()

    def rebind(self) -> None:
        """Take the flat views anew, after the parameters were rebound
        to fresh storage (``DistTrainer`` with ``donate=False``)."""
        self._views = [p.detach().view(-1) for p in self.params]

    def before(self) -> None:
        if self._buf is None:
            self._buf = torch.cat(self._views)
        else:
            torch.cat(self._views, out=self._buf)

    def stats(self) -> Dict[str, torch.Tensor]:
        flat = torch.cat(self._views)
        return update_part([flat - self._buf], [flat])


def stat_vector(stats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A step's stats as one float32 vector in a fixed order
    (:data:`STAT_KEYS`, then ``part_loss``, then ``part_nonfinite``):
    what a K-step call writes into its static output buffer."""
    parts = [torch.stack([stats[k].float().reshape(()) for k in STAT_KEYS])]
    parts += [stats[k].float().reshape(-1)
              for k in ("part_loss", "part_nonfinite") if k in stats]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def stats_of_rows(rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stat_vector` on a ``[n]`` tensor (views)."""
    out = {k: rows[i] for i, k in enumerate(STAT_KEYS)}
    rest = rows[len(STAT_KEYS):]
    if len(rest):
        half = len(rest) // 2
        out["part_loss"] = rest[:half]
        out["part_nonfinite"] = rest[half:]
    return out


# ---------------------------------------------------------------------
# off-critical-path fetch
# ---------------------------------------------------------------------
def _pack(loss, stats: Optional[Dict]) -> Tuple[torch.Tensor, list]:
    """``loss`` and ``stats`` as one float32 vector and its layout."""
    loss = torch.as_tensor(loss).detach()
    parts = [loss.float().reshape(-1)[-1:]]
    layout = []
    for k, v in (stats or {}).items():
        v = torch.as_tensor(v).detach()
        parts.append(v.to(device=loss.device,
                          dtype=torch.float32).reshape(-1))
        layout.append((k, tuple(v.shape)))
    return torch.cat(parts), layout


class _Entry:
    __slots__ = ("step", "host", "event", "layout", "has_stats")

    def __init__(self, step: int, loss, stats: Optional[Dict]):
        flat, self.layout = _pack(loss, stats)
        self.step = int(step)
        self.has_stats = stats is not None
        self.event = None
        if flat.is_cuda:
            self.host = torch.empty(flat.shape, dtype=flat.dtype,
                                    pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = flat

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def fetch(self) -> Tuple[int, float, Optional[Dict]]:
        if self.event is not None:
            self.event.synchronize()
        vals = self.host.numpy()
        loss = float(vals[0])
        if not self.has_stats:
            return self.step, loss, None
        out, off = {}, 1
        for k, shape in self.layout:
            n = int(np.prod(shape)) if shape else 1
            a = vals[off:off + n].reshape(shape)
            off += n
            out[k] = (np.rint(a).astype(np.int64) if k in _COUNT_KEYS
                      else a.astype(np.float32))
        return self.step, loss, out


class StatsTap:
    """Delayed host fetch of the in-step stats: the loop pushes each
    call's ``(step, loss, stats)``, and :meth:`poll_all` fetches only
    entries older than ``delay`` pushes whose copy has completed on the
    card, never the call just dispatched. The trainers observe every
    fetched entry, so two entries that ripen together (on the card) are
    both seen and the first bad step is the one reported. The sentry so trails training
    by ``delay`` calls (at most ``max_lag``), which is why the rollback
    quarantine starts at the first observed bad step."""

    def __init__(self, delay: int = 1, max_lag: int = 8):
        self.delay = max(int(delay), 0)
        # bounded staleness: past this many unfetched pushes the oldest
        # is fetched even if that waits on the card
        self.max_lag = max(int(max_lag), self.delay + 1)
        self._pending: deque = deque()

    def push(self, step: int, loss, stats: Optional[Dict]) -> None:
        """Queue one call's last loss and stats (tensors on any device,
        or host values); on the card this enqueues their copy to the
        host and returns at once."""
        self._pending.append(_Entry(step, loss, stats))

    def poll_all(self) -> List[Tuple[int, float, Optional[Dict]]]:
        """Every ripe entry (older than ``delay`` pushes and already
        copied), oldest first, fetched to the host; empty when nothing
        is ripe. Past ``max_lag`` pending entries the oldest is fetched
        even if that waits."""
        out = []
        while len(self._pending) > self.delay:
            head = self._pending[0]
            if len(self._pending) <= self.max_lag and not head.ready():
                break
            self._pending.popleft()
            out.append(head.fetch())
        return out

    def poll(self) -> Optional[Tuple[int, float, Optional[Dict]]]:
        """The newest of :meth:`poll_all`'s entries (the JAX tap's
        ``poll``); None when nothing is ripe."""
        out = self.poll_all()
        return out[-1] if out else None

    def drain_all(self) -> List[Tuple[int, float, Optional[Dict]]]:
        """Fetch every pending entry, oldest first (an epoch's end): the
        last steps must not escape the sentry because the loop ended."""
        out = []
        while self._pending:
            out.append(self._pending.popleft().fetch())
        return out

    def drain(self) -> Optional[Tuple[int, float, Optional[Dict]]]:
        """The newest of :meth:`drain_all`'s entries (the JAX tap's
        ``drain``)."""
        out = self.drain_all()
        return out[-1] if out else None


# ---------------------------------------------------------------------
# rolling detectors
# ---------------------------------------------------------------------
class QualityMonitor:
    """Host-side rolling detectors over the stats stream, one per
    trainer process; :meth:`observe` takes the tap's fetched ``(step,
    loss, stats)``.

    - **NaN/Inf sentry**: any non-finite loss or gradient element gives
      a ``numerics_fault`` event with the step and the attributed
      partition (argmax of ``part_nonfinite``, else the first partition
      whose ``part_loss`` is non-finite, else the only one of a
      single-partition trainer); raises :class:`NumericsFault` unless
      ``action="warn"``.
    - **loss divergence**: EWMA z-score of the loss over ``z_max`` gives
      a ``loss_divergence`` event on the rising edge.
    - **grad explosion**: grad norm over ``grad_ratio_max`` × the
      rolling median gives a ``grad_explosion`` event on the rising
      edge.
    - **plateau**: the loss range over ``plateau_window`` steps below
      ``plateau_rel`` of its magnitude gives a ``loss_plateau`` event
      (0 disables).

    Every observation sets the ``train_quality_*`` gauges and adds a
    ``model_health`` event (the JAX package's Chrome counter track)."""

    def __init__(self, window: int = 32, z_max: float = 6.0,
                 grad_ratio_max: float = 50.0,
                 plateau_window: int = 0, plateau_rel: float = 1e-3,
                 action: str = "rollback",
                 parts: Optional[Sequence[int]] = None,
                 min_samples: int = 8):
        self.window = validate("quality_window", int(window))
        self.z_max = validate("quality_z_max", float(z_max))
        self.grad_ratio_max = validate("quality_grad_ratio_max",
                                       float(grad_ratio_max))
        self.plateau_window = validate("quality_plateau_window",
                                       int(plateau_window))
        self.plateau_rel = validate("quality_plateau_rel",
                                    float(plateau_rel))
        self.action = validate("quality_action", action)
        self.parts = list(parts) if parts is not None else None
        self.min_samples = int(min_samples)
        self._alpha = 2.0 / (self.window + 1.0)
        self._ewma_mean: Optional[float] = None
        self._ewma_var: float = 0.0
        self._n = 0
        self._loss_hist: deque = deque(maxlen=max(
            self.window, self.plateau_window or 1))
        self._grad_hist: deque = deque(maxlen=self.window)
        self._diverging = False
        self._exploding = False
        self._plateaued = False
        self.fault: Optional[NumericsFault] = None
        self.last: Dict = {}

    @classmethod
    def from_config(cls, cfg, parts: Optional[Sequence[int]] = None
                    ) -> "QualityMonitor":
        """Built from a ``TrainConfig``'s ``quality_*`` fields."""
        return cls(window=cfg.quality_window, z_max=cfg.quality_z_max,
                   grad_ratio_max=cfg.quality_grad_ratio_max,
                   plateau_window=cfg.quality_plateau_window,
                   plateau_rel=cfg.quality_plateau_rel,
                   action=cfg.quality_action, parts=parts)

    def _part(self, i: int) -> int:
        return (self.parts[i] if self.parts is not None
                and i < len(self.parts) else i)

    def _attribute(self, stats: Optional[Dict]) -> Optional[int]:
        if stats:
            arr = stats.get("part_nonfinite")
            if arr is not None:
                arr = np.asarray(arr).reshape(-1)
                if len(arr) and arr.max() > 0:
                    return self._part(int(arr.argmax()))
            pl = stats.get("part_loss")
            if pl is not None:
                bad = np.nonzero(~np.isfinite(np.asarray(pl).reshape(-1)))[0]
                if len(bad):
                    return self._part(int(bad[0]))
        if self.parts is not None and len(self.parts) == 1:
            # a single-partition trainer: the fault is this partition
            return self.parts[0]
        return None

    def observe(self, step: int, loss: float,
                stats: Optional[Dict] = None) -> Dict:
        """One fetched observation. Returns the verdict (also kept as
        ``self.last``); raises :class:`NumericsFault` when the sentry
        trips and the action is halt or rollback."""
        obs = get_obs()
        m = obs.metrics
        gnorm = pnorm = uratio = None
        nonfin = 0
        if stats:
            if stats.get("grad_norm") is not None:
                gnorm = float(np.asarray(stats["grad_norm"]))
            if stats.get("param_norm") is not None:
                pnorm = float(np.asarray(stats["param_norm"]))
            if stats.get("update_ratio") is not None:
                uratio = float(np.asarray(stats["update_ratio"]))
            if stats.get("nonfinite") is not None:
                nonfin = int(np.asarray(stats["nonfinite"]).sum())
            elif stats.get("part_nonfinite") is not None:
                nonfin = int(np.asarray(stats["part_nonfinite"]).sum())
        bad = nonfin > 0 or not math.isfinite(loss)
        if gnorm is not None and not math.isfinite(gnorm):
            bad = True
        # gauges first: the stream stays visible on the step that trips
        if gnorm is not None and math.isfinite(gnorm):
            m.gauge("train_quality_grad_norm",
                    "global L2 gradient norm at the last observed "
                    "step").set(round(gnorm, 6))
        if pnorm is not None and math.isfinite(pnorm):
            m.gauge("train_quality_param_norm",
                    "global L2 parameter norm at the last observed "
                    "step").set(round(pnorm, 6))
        if uratio is not None and math.isfinite(uratio):
            m.gauge("train_quality_update_ratio",
                    "L2(update)/L2(params) of the last observed "
                    "step").set(round(uratio, 8))
        if nonfin:
            m.counter("train_quality_nonfinite_total",
                      "non-finite gradient/loss elements observed by "
                      "the numerics sentry").inc(nonfin)
        track = {}
        if math.isfinite(loss):
            track["loss"] = round(loss, 6)
        if gnorm is not None and math.isfinite(gnorm):
            track["grad_norm"] = round(gnorm, 6)
        if track:
            obs.emit("model_health", step=int(step), **track)
        verdict: Dict = {"step": int(step), "loss": loss,
                         "grad_norm": gnorm, "param_norm": pnorm,
                         "update_ratio": uratio, "nonfinite": nonfin,
                         "ok": not bad}
        if bad:
            part = self._attribute(stats)
            verdict["partition"] = part
            self.last = verdict
            self._fault(step, loss, part, nonfin)
            return verdict            # action "warn" falls through
        self._divergence(step, loss)
        self._explosion(step, gnorm)
        self._plateau(step, loss)
        verdict["loss_z"] = self._z(loss)
        self.last = verdict
        self._loss_hist.append(loss)
        if gnorm is not None:
            self._grad_hist.append(gnorm)
        self._update_ewma(loss)
        return verdict

    def _fault(self, step: int, loss: float, part: Optional[int],
               nonfin: int) -> None:
        obs = get_obs()
        kind = "nonfinite_loss" if not math.isfinite(loss) \
            else "nonfinite_grad"
        obs.metrics.counter(
            "train_quality_faults_total",
            "numerics-sentry detections (non-finite loss/grads)",
            labels=("kind",)).inc(kind=kind)
        # the fault's kind as ``fault_kind``: ``kind`` names the event
        obs.emit("numerics_fault", step=int(step), partition=part,
                 fault_kind=kind, nonfinite=int(nonfin), action=self.action,
                 loss=(loss if math.isfinite(loss) else None))
        t = time.perf_counter()
        obs.complete("numerics_fault", t, t, cat="quality", step=int(step))
        obs.flush()
        fault = NumericsFault(
            f"numerics sentry: {kind} at step {step}"
            + (f" on partition {part}" if part is not None else "")
            + f" ({nonfin} non-finite element(s); action="
            f"{self.action})", step, partition=part, kind=kind)
        self.fault = fault
        if self.action != "warn":
            raise fault

    def _z(self, loss: float) -> Optional[float]:
        if self._ewma_mean is None or self._n < self.min_samples:
            return None
        std = math.sqrt(max(self._ewma_var, 0.0))
        return (loss - self._ewma_mean) / max(std, _EPS)

    def _update_ewma(self, loss: float) -> None:
        if self._ewma_mean is None:
            self._ewma_mean = loss
            self._ewma_var = 0.0
        else:
            d = loss - self._ewma_mean
            self._ewma_mean += self._alpha * d
            self._ewma_var = ((1.0 - self._alpha)
                              * (self._ewma_var + self._alpha * d * d))
        self._n += 1

    def _divergence(self, step: int, loss: float) -> None:
        z = self._z(loss)
        if z is None:
            return
        obs = get_obs()
        obs.metrics.gauge(
            "train_quality_loss_z",
            "EWMA z-score of the last observed loss").set(round(z, 4))
        if z > self.z_max and not self._diverging:
            self._diverging = True
            obs.metrics.counter(
                "train_quality_divergences_total",
                "loss-divergence detections (EWMA z-score over "
                "quality_z_max)").inc()
            obs.emit("loss_divergence", step=int(step),
                     loss=round(loss, 6), z=round(z, 4), z_max=self.z_max,
                     mean=round(self._ewma_mean, 6))
        elif z <= self.z_max:
            self._diverging = False

    def _explosion(self, step: int, gnorm: Optional[float]) -> None:
        if gnorm is None or self.grad_ratio_max <= 0:
            return
        if len(self._grad_hist) < self.min_samples:
            return
        med = float(np.median(np.asarray(self._grad_hist)))
        if med <= 0:
            return
        if gnorm > self.grad_ratio_max * med and not self._exploding:
            self._exploding = True
            obs = get_obs()
            obs.metrics.counter(
                "train_quality_grad_explosions_total",
                "grad-norm explosion detections (norm over "
                "quality_grad_ratio_max x rolling median)").inc()
            obs.emit("grad_explosion", step=int(step),
                     grad_norm=round(gnorm, 6), median=round(med, 6),
                     ratio=round(gnorm / med, 3),
                     ratio_max=self.grad_ratio_max)
        elif gnorm <= self.grad_ratio_max * med:
            self._exploding = False

    def _plateau(self, step: int, loss: float) -> None:
        w = self.plateau_window
        if not w or len(self._loss_hist) < w:
            return
        recent = list(self._loss_hist)[-w:] + [loss]
        spread = max(recent) - min(recent)
        scale = max(abs(sum(recent) / len(recent)), _EPS)
        if spread <= self.plateau_rel * scale and not self._plateaued:
            self._plateaued = True
            get_obs().emit("loss_plateau", step=int(step),
                           loss=round(loss, 6), window=w,
                           spread=round(spread, 8))
        elif spread > self.plateau_rel * scale:
            self._plateaued = False


# ---------------------------------------------------------------------
# the response (trainer side)
# ---------------------------------------------------------------------
def write_fault_marker(fault: NumericsFault,
                       workspace: Optional[str] = None) -> Optional[str]:
    """Record the fault as ``<workspace>/.numerics_fault.json``, the
    signal a launcher's bounded relaunch reads. Without a workspace
    (``TPU_OPERATOR_WORKSPACE`` unset) nothing is written."""
    ws = workspace or os.environ.get(WORKSPACE_ENV)
    if not ws:
        return None
    path = os.path.join(ws, FAULT_MARKER)
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": fault.step, "partition": fault.partition,
                       "kind": fault.kind, "pid": os.getpid()}, f)
        os.replace(tmp, path)
        return path
    except OSError:
        return None


def take_fault_marker(workspace: str) -> Optional[Dict]:
    """Consume (read and delete) the workspace fault marker; None when
    no trainer faulted."""
    path = os.path.join(workspace, FAULT_MARKER)
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    try:
        os.remove(path)
    except OSError:
        pass
    return rec if isinstance(rec, dict) else None


def my_partition() -> int:
    """The partition this single-partition trainer process runs as (the
    launcher's ``TPU_OPERATOR_RANK``); 0 when standalone."""
    try:
        return int(os.environ.get(RANK_ENV, "0") or 0)
    except ValueError:
        return 0


def halt_for_rollback(fault: NumericsFault, ckpt=None,
                      action: str = "rollback") -> None:
    """The trainers' epilogue for a tripped sentry: with
    ``action="rollback"`` quarantine every checkpoint at or past the
    first bad step and leave the workspace fault marker; ``"halt"``
    does neither. Either way the halt is an event and the fault is
    re-raised."""
    obs = get_obs()
    rolled = None
    marker = None
    if action == "rollback":
        if ckpt is not None:
            try:
                rolled = ckpt.quarantine_from(fault.step)
            except Exception as exc:  # noqa: BLE001 — must not mask the fault
                obs.emit("ckpt_quarantine_failed", error=str(exc)[:300])
        marker = write_fault_marker(fault)
    obs.emit("numerics_halt", step=fault.step, partition=fault.partition,
             fault_kind=fault.kind, action=action, rolled_back_to=rolled,
             marker=bool(marker))
    obs.flush()
    raise fault


# ---------------------------------------------------------------------
# chaos: numerics:nan:<step>
# ---------------------------------------------------------------------
class NumericsInjector:
    """The chaos ``numerics:nan:<step>`` drill: at the first call
    boundary at or past ``<step>`` the trainer's parameter that holds
    the first leaf of the JAX package's params tree (flatten order,
    ``models/flax_layout.py::first_flax_param``) is multiplied by NaN in
    place, so the next step's backward produces non-finite gradients.
    In place, under ``torch.no_grad()``: a captured K-step graph reads
    the storage it was captured on, so a rebound tensor would never be
    poisoned. Fires once per workspace (``.chaos_numerics_fired``),
    since a rollback resumes below the step; a run that starts at or
    past the step is never poisoned."""

    def __init__(self, start_step: int = 0):
        from dgl_operator_tpu_torch.launcher.chaos import proc_plan
        plan = proc_plan()
        at = plan.numerics_nan_step() if plan else None
        self.at = at if at is not None and at > start_step else None
        if self.at is not None and self._fired_marker_exists():
            self.at = None

    @staticmethod
    def _fired_path() -> Optional[str]:
        ws = os.environ.get(WORKSPACE_ENV)
        return os.path.join(ws, NUMERICS_FIRED_MARKER) if ws else None

    def _fired_marker_exists(self) -> bool:
        p = self._fired_path()
        return bool(p) and os.path.exists(p)

    def _mark_fired(self) -> None:
        p = self._fired_path()
        if not p:
            return
        try:
            with open(p, "w") as f:
                f.write(f"pid={os.getpid()}\n")
        except OSError:
            pass

    def maybe_poison(self, gstep: int, model: torch.nn.Module) -> bool:
        """Once a call, after the checkpoint and heartbeat epilogue (the
        last checkpoint before the poison stays the last-known-good).
        Returns whether it poisoned."""
        if self.at is None or gstep < self.at:
            return False
        self.at = None
        self._mark_fired()
        from dgl_operator_tpu_torch.launcher.chaos import count_fault
        from dgl_operator_tpu_torch.models.flax_layout import \
            first_flax_param
        name, param = first_flax_param(model)
        with torch.no_grad():
            param.mul_(float("nan"))
        count_fault("numerics", "nan", step=int(gstep), param=name)
        return True


def maybe_injector(start_step: int = 0) -> Optional[NumericsInjector]:
    """An armed injector, or None when the chaos plan has no due
    ``numerics:nan`` rule."""
    inj = NumericsInjector(start_step)
    return inj if inj.at is not None else None


# ---------------------------------------------------------------------
# the analytics' face (obs/analyze.py reads it)
# ---------------------------------------------------------------------
def model_health_summary(events: List[Dict],
                         procs: Dict[str, dict]) -> Optional[Dict]:
    """The model-health roll-up of a job view: numerics faults (with
    step/partition attribution), divergence/explosion/plateau counts,
    rollbacks, and the last observed quality gauges. None when the
    run never carried the sentry (pre-quality runs are unchanged)."""
    faults = [e for e in events if e.get("event") == "numerics_fault"]
    div = [e for e in events if e.get("event") == "loss_divergence"]
    exp = [e for e in events if e.get("event") == "grad_explosion"]
    plat = [e for e in events if e.get("event") == "loss_plateau"]
    rb = [e for e in events if e.get("event") == "numerics_rollback"]

    def gauge(name: str) -> Optional[float]:
        best = None
        for snap in (procs or {}).values():
            for s in ((snap or {}).get(name) or {}).get("samples", []):
                v = float(s["value"])
                best = v if best is None else max(best, v)
        return best

    gnorm = gauge("train_quality_grad_norm")
    uratio = gauge("train_quality_update_ratio")
    loss = gauge("train_loss")
    if not (faults or div or exp or plat or rb) and gnorm is None:
        return None
    return {
        "faults": [{"step": e.get("step"),
                    "partition": e.get("partition"),
                    "kind": e.get("kind"),
                    "action": e.get("action")} for e in faults],
        "divergences": len(div),
        "grad_explosions": len(exp),
        "plateaus": len(plat),
        "rollbacks": len(rb),
        "last_loss": loss,
        "last_grad_norm": gnorm,
        "last_update_ratio": uratio,
    }
