"""The sampled trainer — ``SampledTrainer``.

The counterpart of ``dgl_operator_tpu/runtime/loop.py::SampledTrainer``
(the reference's ``train_dist.py`` run loop): each epoch permutes the
training ids with one seeded numpy stream, cuts them into batches and
takes one step per batch on the card: the input rows are gathered by
the hand-written ``gather_rows`` kernel, the model (``DistSAGE``,
``DistGAT`` or ``DistGATv2``) aggregates with ``fanout_agg`` (SAGE) or
gathers each neighbour slot with ``gather_rows`` (GAT), its backward
runs ``scatter_add_rows``, and Adam updates the weights. Two samplers
(``TrainConfig.sampler``):

- ``"host"``: each batch is sampled on the host through the C++ graph
  core and padded (on a thread pipeline when ``prefetch > 0``; the
  graph core releases the interpreter lock, so sampler threads
  overlap), and shipped with the transpose plans of its blocks.
- ``"device"``: the graph's CSR lives on the card and each step samples
  tree-form blocks there (``ops/device_sample.py``), its draws keyed on
  ``(cfg.seed, global step)``, with the plans built on the card too.
  The epoch's permuted seeds are staged once into a device buffer that
  the step indexes with a device step counter.

``steps_per_call = K`` groups the steps into calls of K (the JAX
trainer's ``lax.scan``), then single steps for the epoch's tail
(:func:`chunk_calls`). With the device sampler on the card a call is
one replay of a CUDA graph of the K steps (``runtime/graphs.py``); with
the host sampler a call is K single steps, since the batches' plans
differ in size. Evaluation runs the model's layer-wise inference over
the full graph (``models.full_graph_inference``). The blocks carry the
transpose plans the model's backward needs on the card (its
``slot_plans``). :func:`train_full_graph` is the
full-graph loop (GCN or GAT on one ``DeviceGraph``). With
``ckpt_dir`` the model and Adam's state are checkpointed every
``ckpt_every`` steps (at the end of the call that crosses the mark) and
at each epoch's end, and a new run resumes from the newest good
checkpoint (``resume="auto"``).

The numerics sentry (``TrainConfig.sentry``, on by default;
``obs/quality.py``): every step also computes the global gradient and
parameter norms, the update ratio and the count of non-finite
gradient elements on the device, a K-step call reporting its last
step's at the call's end (captured in its CUDA graph on the card).
:func:`run_epochs` pushes them to a ``StatsTap`` after each call and
feeds a ``QualityMonitor`` whatever is ready; a non-finite step raises
``NumericsFault`` and, with ``quality_action="rollback"``, quarantines
the checkpoints at or past it (``halt_for_rollback``). The stats only
read the step's tensors, so the trajectory is bit-identical with the
sentry on or off.

The live, chaos and preemption planes (:func:`run_epochs`, around
every call, in the JAX loop's order): the chaos ``step:slow`` drag
before the call (:class:`StepSlowInjector`), then the periodic
checkpoint, the stats tap, :func:`heartbeat` (a tick into the live feed
that the ``TPU_OPERATOR_LIVE_PORT`` sidecar serves, ``obs/live.py``),
:class:`PreemptionGuard` (a SIGTERM, or the chaos ``train:kill`` and
``host:die``, flushes a final checkpoint and raises :class:`Preempted`,
or hard-exits) and last the chaos ``numerics:nan`` injector
(``obs/quality.py``). The heartbeat carries the JAX loop's riders: the
``critpath_frac{category}`` gauge (``obs/xray.py::live_critpath``), a
profiler tick (``obs/prof.py``: ``train_mfu`` from each program's
counted cost), a flight-recorder sample (``obs/flight.py``) and the
comm ledger's bytes (``obs/comm.py``). Each epoch ends in
:func:`_record_epoch` (the phase histograms, ``train_steps_total``, the
``epoch`` event and span, and a flush of the run's files). A tuned
manifest (``TPU_OPERATOR_TUNED_MANIFEST``) overlays the ``train`` and
``quality`` knobs of ``TrainConfig``
(``autotune/knobs.py::apply_tuned``).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.autotune.knobs import apply_tuned, validate
from dgl_operator_tpu_torch.graph.blocks import (FanoutBlock, MiniBatch,
                                                 build_fanout_blocks,
                                                 calibrate_caps, fanout_caps,
                                                 pad_minibatch)
from dgl_operator_tpu_torch.graph.graph import Graph
from dgl_operator_tpu_torch.models import (flax_params, full_graph_inference,
                                           state_dict_from_flax)
from dgl_operator_tpu_torch.launcher import chaos
from dgl_operator_tpu_torch.obs import get_obs, prof, tracectx
from dgl_operator_tpu_torch.obs import quality as Q
from dgl_operator_tpu_torch.obs.comm import axis_bytes_total
from dgl_operator_tpu_torch.obs.flight import get_flight
from dgl_operator_tpu_torch.obs.live import get_feed, maybe_start_sidecar
from dgl_operator_tpu_torch.ops.device_sample import (TreeSampler,
                                                      device_csr, draw_key)
from dgl_operator_tpu_torch.ops.gather import gather_rows
from dgl_operator_tpu_torch.ops.scatter import attach_plans
from dgl_operator_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                       load_train_state,
                                                       resolve_fence_epoch,
                                                       train_state)
from dgl_operator_tpu_torch.runtime.forward import masked_loss
from dgl_operator_tpu_torch.runtime.graphs import DeviceRun, graph_stats
from dgl_operator_tpu_torch.runtime.timers import PhaseTimer

FEATS_LAYOUTS = ("replicated", "owner")
SAMPLERS = ("host", "device")
RESUME_POLICIES = ("auto", "never")
# the launcher's sampler-width plumb (the entry point's --num_workers)
NUM_SAMPLERS_ENV = "TPU_OPERATOR_NUM_SAMPLERS"


@dataclasses.dataclass
class TrainConfig:
    """The JAX ``TrainConfig``'s fields and defaults. ``sampler`` is
    ``"host"`` or ``"device"``; ``steps_per_call`` is any K >= 1
    (``DistTrainer`` takes K > 1 with the device sampler only, as the
    JAX trainer does). ``shard_update``, ``shard_rules``,
    ``zero_stage``, ``tp_axis_size``, ``gather_depth`` (the sharding
    plane, ``parallel/dp.py::ShardPlan``; ``gather_depth``'s reader is
    ``zero_stage=3``), ``feats_layout``, ``halo_cache_frac``,
    ``feat_dtype``, ``donate``, ``pipeline_mode`` and
    ``pipeline_depth`` are read by ``DistTrainer`` only
    (``SampledTrainer`` ignores them, as in JAX). ``sentry``, the
    ``quality_*`` fields, ``feat_dtype``, the pipeline's knobs,
    ``zero_stage``, ``tp_axis_size`` and ``gather_depth`` are validated
    against the knob registry (``autotune/knobs.py``)."""

    num_epochs: int = 10
    batch_size: int = 1000             # reference default (dglrun:35)
    lr: float = 0.003                  # train_dist.py default
    fanouts: Sequence[int] = (10, 25)  # train_dist.py:311
    eval_every: int = 5                # epochs; 0 disables evaluation
    log_every: int = 20                # steps between train_step events
    # the dropout rate the run trains with; the trainer sets the model's
    dropout: float = 0.5
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0                # steps; 0 = only at epoch end
    # "auto": resume from the newest good checkpoint under ckpt_dir;
    # "never": start at step 0 (saves still happen)
    resume: str = "auto"
    # "auto" calibrates per-layer caps from sampled batches; "worst"
    # keeps the analytic bound
    cap_policy: str = "auto"
    cap_margin: float = 1.08
    # batches sampled ahead of the step on worker threads; 0 samples
    # inline on the loop thread
    prefetch: int = 2
    # sampler threads; 0 takes the launcher's TPU_OPERATOR_NUM_SAMPLERS,
    # else 1 (resolve_num_samplers)
    num_samplers: int = 0
    # optimizer steps per call: K-step calls, then single steps for the
    # epoch's tail
    steps_per_call: int = 1
    # "host": the C++ graph core samples compacted blocks; "device": the
    # card samples tree-form blocks (ops/device_sample.py)
    sampler: str = "host"
    # DistTrainer: "replicated" stores each slot's core and halo rows;
    # "owner" stores core rows plus a hot-halo cache of halo_cache_frac
    # of the halo and exchanges the rest each step
    feats_layout: str = "replicated"
    halo_cache_frac: float = 0.25
    # DistTrainer: the feature store's dtype, float32, bfloat16, or the
    # int8 / uint8 codes of graph/quant.py
    feat_dtype: str = "float32"
    shard_update: bool = False
    shard_rules: Optional[tuple] = None
    zero_stage: int = 1
    tp_axis_size: int = 1
    # DistTrainer: True updates the parameters and Adam's state in
    # place; False rebinds them to fresh copies before every call, so a
    # tensor a caller took stays as it was (the calls then run eagerly;
    # the trajectory is the same)
    donate: bool = True
    # DistTrainer, owner layout, host sampler: "fused" enqueues batch
    # t+K's exchange (K = pipeline_depth) before step t's compute, into
    # a ring of K receive buffers; "staged" enqueues batch t+1's right
    # after step t is dispatched
    pipeline_mode: str = "fused"
    pipeline_depth: int = 1
    # the ZeRO-3 gather window: at most this many parameter gathers in
    # flight (read by zero_stage=3)
    gather_depth: int = 2
    # the numerics sentry (obs/quality.py): in-step stats and the
    # rolling model-health detectors over them; the trajectory is
    # bit-identical either way
    sentry: bool = True
    # a numerics fault's response: "warn" keeps training, "halt" raises
    # NumericsFault, "rollback" also quarantines the checkpoints at or
    # past the fault and leaves the workspace fault marker
    quality_action: str = "rollback"
    # detector thresholds: rolling window, EWMA z-score ceiling, grad
    # explosion multiple of the rolling median (0 disables), plateau
    # window (0 disables) and relative plateau threshold
    quality_window: int = 32
    quality_z_max: float = 6.0
    quality_grad_ratio_max: float = 50.0
    quality_plateau_window: int = 0
    quality_plateau_rel: float = 1e-3

    def __post_init__(self):
        for name in ("sentry", "quality_action", "quality_window",
                     "quality_z_max", "quality_grad_ratio_max",
                     "quality_plateau_window", "quality_plateau_rel",
                     "donate", "pipeline_mode", "pipeline_depth",
                     "gather_depth", "feat_dtype", "zero_stage",
                     "tp_axis_size"):
            setattr(self, name, validate(name, getattr(self, name)))
        if self.sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {self.sampler!r} (expected "
                             f"{SAMPLERS})")
        if int(self.steps_per_call) < 1:
            raise ValueError(f"steps_per_call must be >= 1, got "
                             f"{self.steps_per_call}")
        if self.feats_layout not in FEATS_LAYOUTS:
            raise ValueError(f"unknown feats_layout {self.feats_layout!r} "
                             f"(expected {FEATS_LAYOUTS})")
        if self.resume not in RESUME_POLICIES:
            raise ValueError(f"unknown resume policy {self.resume!r} "
                             f"(expected {RESUME_POLICIES})")
        if self.ckpt_every < 0:
            raise ValueError(f"ckpt_every must be >= 0, got "
                             f"{self.ckpt_every}")
        if not 0.0 <= self.halo_cache_frac <= 1.0:
            raise ValueError(f"halo_cache_frac must be in [0, 1], got "
                             f"{self.halo_cache_frac}")
        if self.cap_policy not in ("auto", "worst"):
            raise ValueError(f"cap_policy must be 'auto' or 'worst', got "
                             f"{self.cap_policy!r}")
        if self.num_samplers < 0 or self.prefetch < 0:
            raise ValueError("num_samplers and prefetch must be >= 0")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got "
                             f"{self.dropout}")


def resolve_num_samplers(cfg: TrainConfig) -> int:
    """The sampler-pool width both trainers use: ``cfg.num_samplers``
    when set, else the launcher's ``TPU_OPERATOR_NUM_SAMPLERS``, else
    1."""
    ns = int(cfg.num_samplers)
    if ns == 0:
        ns = int(os.environ.get(NUM_SAMPLERS_ENV, "0") or 0)
    return max(ns, 1)


class Preempted(RuntimeError):
    """SIGTERM arrived mid-training. With a checkpoint manager the final
    checkpoint was flushed before this was raised, so a relaunched
    trainer resumes from it. Entry scripts exit with a retryable status
    (75, EX_TEMPFAIL)."""


class PreemptionGuard:
    """SIGTERM -> checkpoint flush for the training loops.

    Installed (main thread only: the interpreter delivers signals
    there), the handler only sets a flag; the loop polls it once a call
    and, when set, flushes a final synchronous checkpoint and raises
    :class:`Preempted` (:func:`flush_and_preempt`).

    The chaos plan (``launcher/chaos.py``): ``train:kill:<step>`` makes
    :meth:`poll` send a real SIGTERM to this process at that global
    step, and ``host:die:<step>`` (scoped to this trainer's hostfile
    host) makes it hard-exit there: a ``host_died`` event and the
    workspace's dead-host marker, then ``os._exit(113)`` with no
    checkpoint flush. Either fires only when the run started below its
    step, so the resumed run survives."""

    def __init__(self, start_step: int = 0):
        plan = chaos.proc_plan()
        kill = plan.train_kill_step() if plan else None
        self.kill_at = (kill if kill is not None and kill > start_step
                        else None)
        self._host = chaos.my_host_name()
        die = plan.host_die_step(self._host) if plan else None
        self.die_at = die if die is not None and die > start_step else None
        self._triggered = False
        self._installed = False
        self._prev = None

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            # the flight recorder first, so its chained handler becomes
            # this guard's ``_prev``: a SIGTERM while the guard is on
            # dumps through flush_and_preempt, one after it still hits
            # the recorder's own hook
            get_flight().install()
            self._prev = signal.signal(signal.SIGTERM, self._on_term)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)
            self._installed = False

    def _on_term(self, signum, frame) -> None:
        self._triggered = True

    @property
    def triggered(self) -> bool:
        return self._triggered

    def poll(self, gstep: int) -> bool:
        """Once a call: deliver the chaos host death or kill when due,
        then report whether a SIGTERM has arrived."""
        if self.die_at is not None and gstep >= self.die_at:
            self._die(gstep)            # never returns
        if (self.kill_at is not None and gstep >= self.kill_at
                and self._installed):
            self.kill_at = None
            obs = get_obs()
            obs.metrics.counter(
                "chaos_train_kills_total",
                "chaos-plan SIGTERMs delivered to training loops").inc()
            obs.emit("chaos_train_kill", step=gstep)
            os.kill(os.getpid(), signal.SIGTERM)
            # the handler runs at the interpreter's next check; wait for
            # it (bounded) so the injected kill lands at this step
            deadline = time.time() + 2.0
            while not self._triggered and time.time() < deadline:
                time.sleep(0.001)
        return self._triggered

    def _die(self, gstep: int) -> None:
        """``host:die``: record the death, then vanish (``os._exit``
        runs no ``finally`` block, as a machine that is gone)."""
        obs = get_obs()
        obs.metrics.counter(
            "chaos_host_deaths_total",
            "chaos host:die hard-exits delivered to training loops").inc()
        obs.emit("host_died", step=gstep, host_name=self._host or "?",
                 exit_code=chaos.HOST_DIED_EXIT)
        obs.instant("host_died", cat="chaos", step=gstep)
        obs.flush()
        # the flight recorder's black box: ``os._exit`` runs no handler,
        # so the dump happens here
        get_flight().dump("host_died")
        if self._host:
            chaos.mark_host_dead(self._host)
        os._exit(chaos.HOST_DIED_EXIT)


def flush_and_preempt(guard: PreemptionGuard, ckpt, gstep: int,
                      state) -> None:
    """The trainers' epilogue for a caught SIGTERM: a synchronous final
    checkpoint of ``state`` at ``gstep`` (the background write in flight
    is drained first), then :class:`Preempted`."""
    obs = get_obs()
    obs.metrics.counter("train_preemptions_total",
                        "SIGTERMs absorbed by the preemption guard").inc()
    obs.emit("preempted", step=gstep, flushed=ckpt is not None)
    obs.flush()
    get_flight().dump("preempted")
    if ckpt is not None:
        ckpt.save(gstep, state, wait=True)
        raise Preempted(f"SIGTERM at step {gstep}: final checkpoint "
                        f"flushed to {ckpt.directory}")
    raise Preempted(f"SIGTERM at step {gstep} (no ckpt_dir configured; "
                    "nothing flushed)")


class StepSlowInjector:
    """The chaos ``step:slow:<s>`` drag: when the plan drags this
    trainer's hostfile host, every call starts with ``sleep(<s>)``,
    billed to the ``stall`` phase and recorded as a ``chaos_step_slow``
    span."""

    def __init__(self):
        plan = chaos.proc_plan()
        self._host = chaos.my_host_name()
        slow = plan.step_slow_seconds(self._host) if plan else None
        self.seconds = float(slow) if slow else None
        self._announced = False

    def maybe_drag(self, timer: Optional[PhaseTimer], gstep: int) -> None:
        """Once a call, before its dispatch."""
        if not self.seconds:
            return
        obs = get_obs()
        if not self._announced:
            self._announced = True
            obs.emit("chaos_step_slow", host=self._host or "?",
                     seconds=self.seconds, step=gstep)
        t0 = time.perf_counter()
        if timer is not None:
            with timer.phase("stall"):
                time.sleep(self.seconds)
        else:
            time.sleep(self.seconds)
        obs.complete("chaos_step_slow", t0, time.perf_counter(),
                     cat="chaos", step=gstep, host=self._host or "?")
        obs.metrics.counter(
            "chaos_step_slow_seconds",
            "seconds of chaos step:slow straggler drag injected"
        ).inc(self.seconds)


def heartbeat(gstep: int, epoch: int, timer: Optional[PhaseTimer] = None,
              sps: Optional[float] = None,
              overlap_ratio: Optional[float] = None,
              loss: Optional[float] = None,
              grad_norm: Optional[float] = None) -> None:
    """Per-call liveness of both trainers: the ``train_heartbeat_step``
    and ``train_heartbeat_ts`` gauges (and ``train_seeds_per_sec`` and
    ``train_loss`` when given), the ``critpath_frac{category}`` gauge of
    ``timer``'s totals, a ``heartbeat`` event (appended to
    ``events.jsonl`` at once: the stall analytics read it while the run
    goes on), a profiler tick (the rolling MFU and memory watermark), a
    flight-recorder sample and one tick into the process's live feed
    (``obs/live.py``), which ``/livez`` reads, with the profiler's and
    the comm ledger's riders. ``overlap_ratio`` is the pipeline's
    hidden-exchange share, ``loss`` and ``grad_norm`` the sentry's last
    fetched values."""
    obs = get_obs()
    m = obs.metrics
    m.gauge("train_heartbeat_step",
            "last global step this worker dispatched").set(gstep)
    m.gauge("train_heartbeat_ts",
            "wall-clock of this worker's last heartbeat").set(time.time())
    if sps is not None:
        m.gauge("train_seeds_per_sec",
                "throughput of the last epoch").set(round(sps, 3))
    if loss is not None:
        m.gauge("train_loss", "loss at the last epoch end").set(
            round(loss, 6))
    if timer is not None:
        from dgl_operator_tpu_torch.obs.xray import live_critpath
        cp = live_critpath(timer.snapshot().get("total"))
        if cp:
            g = m.gauge("critpath_frac",
                        "fraction of accounted loop time per "
                        "critical-path category (obs/xray.py)",
                        labels=("category",))
            for cat, frac in cp.items():
                g.set(frac, category=cat)
    obs.emit("heartbeat", step=gstep, epoch=epoch)
    hw = prof.get_profiler().on_heartbeat(gstep) or {}
    get_flight().note("heartbeat", step=gstep, epoch=epoch)
    get_feed().tick(gstep, timer=timer, mfu=hw.get("mfu"),
                    hbm_mib=hw.get("hbm_mib"), overlap_ratio=overlap_ratio,
                    loss=loss, grad_norm=grad_norm,
                    comm_bytes=axis_bytes_total() or None)


def train_teardown_live(gstep: int) -> None:
    """The terminal marker: a ``train_done`` event and the live feed's
    done flag, so the sidecar's later answers read as completion."""
    get_obs().emit("train_done", step=gstep)
    get_feed().mark_done()


def _record_epoch(timer: PhaseTimer, rec: Dict, t0_wall: float,
                  steps: int) -> None:
    """The per-epoch telemetry epilogue of both trainers: fold the
    PhaseTimer's buckets (time and bytes) into the phase histograms and
    counters, count the steps and the epoch, set the headline gauges,
    emit the ``epoch`` event (the record's scalar fields), record the
    epoch as a trace span, refresh the utilization gauges and flush the
    run's files, so a killed trainer still leaves its last completed
    epoch on disk."""
    obs = get_obs()
    timer.fold_into(obs.metrics)
    m = obs.metrics
    m.counter("train_steps_total", "optimizer steps executed").inc(steps)
    m.counter("train_epochs_total", "epochs completed").inc()
    m.histogram("train_epoch_seconds", "epoch wall-clock").observe(
        rec.get("time", 0.0))
    m.gauge("train_loss", "loss at the last epoch end").set(rec["loss"])
    m.gauge("train_seeds_per_sec",
            "throughput of the last epoch").set(
                rec.get("seeds_per_sec", 0.0))
    if rec.get("val_acc") is not None:
        m.gauge("train_val_acc", "last periodic-eval validation "
                "accuracy").set(rec["val_acc"])
    obs.emit("epoch", **{k: v for k, v in rec.items()
                         if v is None or isinstance(v, (int, float, str))})
    pc_now = time.perf_counter()
    obs.complete(f"epoch {rec.get('epoch')}",
                 pc_now - (time.time() - t0_wall), pc_now, cat="train",
                 epoch=rec.get("epoch"), steps=steps)
    # the epoch's losses were fetched: the card has run every call, so
    # the utilization window reaches the last one
    prof.get_profiler().refresh()
    obs.flush()


def _call_steps(batch) -> int:
    """The steps of one trainer call: a list of host batches, or the
    device sampler's ``(b, step, k)``; one host batch is one step."""
    if isinstance(batch, list):
        return len(batch)
    if isinstance(batch, tuple) and len(batch) == 3 \
            and all(isinstance(v, int) for v in batch):
        return batch[2]
    return 1


def _eval_due(cfg: TrainConfig, epoch: int) -> bool:
    """Every ``eval_every`` epochs plus the final one; 0 disables."""
    return bool(cfg.eval_every) and ((epoch + 1) % cfg.eval_every == 0
                                     or epoch == cfg.num_epochs - 1)


def prefetch_map(fn: Callable, items: Sequence[tuple], depth: int,
                 workers: int) -> Iterator:
    """``fn(*item)`` for each item, in order, computed up to ``depth``
    items ahead on ``workers`` threads; ``depth <= 0`` computes inline.
    Closing the generator cancels what has not started and joins the
    threads."""
    if depth <= 0:
        for item in items:
            yield fn(*item)
        return
    with ThreadPoolExecutor(max_workers=min(max(workers, 1), depth + 1),
                            thread_name_prefix="sampler") as pool:
        pending = []
        it = iter(items)
        try:
            while True:
                while len(pending) < depth + 1:
                    nxt = next(it, None)
                    if nxt is None:
                        break
                    pending.append(pool.submit(fn, *nxt))
                if not pending:
                    return
                yield pending.pop(0).result()
        finally:
            for fut in pending:
                fut.cancel()


def resume_seed(seed: int, start_step: int) -> int:
    """The dropout generator's seed in a run resumed at ``start_step``:
    a stream of its own, as the JAX trainer folds ``start_step`` into
    its key. A resumed run with dropout on does not replay the masks the
    uninterrupted run would have drawn; with dropout 0 it equals that
    run bit for bit."""
    return int(np.random.SeedSequence([int(seed), int(start_step)])
               .generate_state(1, np.uint64)[0])


def open_checkpoints(cfg: TrainConfig, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, plan=None
                     ) -> Tuple[Optional[CheckpointManager], int]:
    """The run's checkpoint manager (None without ``cfg.ckpt_dir``) and
    the global step it starts from. With ``resume="auto"`` the newest
    good checkpoint is loaded into ``model`` and ``optimizer``, or,
    given a ``parallel/dp.py::ShardPlan``, into the plan (the logical
    tree, cut into this mesh's shards)."""
    if cfg.ckpt_dir is None:
        return None, 0
    # fenced under the elastic launcher's incarnation epoch, when exported
    ckpt = CheckpointManager(cfg.ckpt_dir,
                             fence_epoch=resolve_fence_epoch())
    if cfg.resume != "auto":
        return ckpt, 0
    like = (plan.train_state() if plan is not None
            else train_state(model, optimizer))
    start_step, state = ckpt.restore(None, like)
    if start_step:
        if plan is not None:
            plan.load_train_state(state)
        else:
            load_train_state(model, optimizer, state)
        obs = get_obs()
        obs.metrics.counter("train_resumes_total",
                            "trainings resumed from a checkpoint").inc()
        obs.emit("train_resume", step=start_step)
    return ckpt, start_step


def chunk_calls(items: Sequence, k: int) -> List[list]:
    """The ``steps_per_call`` grouping both trainers share (the JAX
    package's ``chunk_calls``): full K-chunks in order, then the tail
    one item a call."""
    k = max(int(k), 1)
    nfull = len(items) // k if k > 1 else 0
    calls = [list(items[i * k:(i + 1) * k]) for i in range(nfull)]
    calls += [[b] for b in items[nfull * k:]]
    return calls


def make_adam(params, cfg: TrainConfig, device: torch.device
              ) -> torch.optim.Adam:
    """The trainers' Adam. With the device sampler on a CUDA device it
    is ``capturable``, so that its step can run inside a CUDA graph, and
    every step of the run, eager or replayed, takes the same arithmetic.
    The host sampler's steps, which are never captured, keep the plain
    Adam, whose step counter stays on the host (the CPU does not take
    the flag)."""
    return torch.optim.Adam(
        params, lr=cfg.lr,
        capturable=cfg.sampler == "device" and device.type == "cuda")


def run_epochs(cfg: TrainConfig, timer: PhaseTimer, steps_per_epoch: int,
               start_step: int, ckpt: Optional[CheckpointManager],
               state: Callable[[], Dict],
               permute: Callable[[np.random.Generator], object],
               sample: Callable[[object, list], Tuple[object, int]],
               step: Callable[[object], Tuple[torch.Tensor,
                                              Optional[torch.Tensor]]],
               evaluate: Callable[[], Dict[str, float]],
               epoch_stats: Callable[[int], Dict] = lambda steps: {},
               sample_workers: int = 1,
               step_stats: Callable[[], Optional[Dict]] = lambda: None,
               parts: Sequence[int] = (0,),
               model: Optional[torch.nn.Module] = None,
               overlap_ratio: Callable[[], Optional[float]] = lambda: None,
               stage: Optional[Callable[[Iterator], Iterator]] = None
               ) -> Tuple[List[Dict], int]:
    """The epoch loop both trainers run, from global step
    ``start_step`` to ``cfg.num_epochs`` epochs; returns the per-epoch
    records and the final global step.

    Each epoch draws ``permute(rng)`` from one numpy stream seeded with
    ``cfg.seed`` (replayed over the epochs a resume skips, so the
    resumed epoch sees the uninterrupted run's shuffle), skips the steps
    a mid-epoch resume already took and groups the rest into calls of
    ``cfg.steps_per_call`` steps (:func:`chunk_calls`), each a list of
    ``(b, step_seed)`` pairs: batch ``b`` of the epoch at global step
    ``step_seed``. It prepares ``sample(perm, call) -> (batch, seeds)``
    on the prefetch pipeline, ``cfg.prefetch`` calls ahead on
    ``sample_workers`` threads (inline with the device sampler, whose
    ``sample`` only names the call), and takes ``step(batch)
    -> (losses [k], accs [k] or None)``. ``state()`` is saved when a
    call crosses a multiple of ``cfg.ckpt_every`` steps and at each
    epoch's end (asynchronously; the last write is drained before this
    returns). ``epoch_stats(n)`` adds the trainer's own fields to the
    record of an epoch of ``n`` steps.

    With ``cfg.sentry`` each call's last loss and ``step_stats()`` (its
    last step's stats, device tensors) are pushed to a
    :class:`~dgl_operator_tpu_torch.obs.quality.StatsTap` at the call's
    end global step, after the checkpoint, and every entry the tap has
    ready goes to a ``QualityMonitor`` over ``parts`` (the partitions
    the stats' rows name); the tap is drained at each epoch's end. A
    fault goes through ``halt_for_rollback`` and is raised.

    Around each call, in the JAX loop's order: the chaos ``step:slow``
    drag before it; after it the checkpoint, the tap, the
    :func:`heartbeat` (with ``overlap_ratio()``), the
    :class:`PreemptionGuard` (a SIGTERM drains the tap and flushes
    ``state()`` at the call's end step, then raises :class:`Preempted`)
    and last the chaos ``numerics:nan`` injector, which poisons
    ``model``. ``stage``, when given, wraps the stream of prepared
    calls (``DistTrainer``'s exchange pipeline enqueues device work for
    batches ahead of their step there). The run is a ``train`` trace span; the live sidecar
    starts when ``TPU_OPERATOR_LIVE_PORT`` is set."""
    rng = np.random.default_rng(cfg.seed)
    start_epoch = start_step // steps_per_epoch
    for _ in range(start_epoch):
        permute(rng)
    obs = get_obs()
    history: List[Dict] = []
    gstep = start_step
    depth = 0 if cfg.sampler == "device" else cfg.prefetch
    # inline sampling is sampling work; with a pipeline, time spent
    # waiting for a batch is a stall
    wait_bucket = "sample" if depth <= 0 else "stall"
    maybe_start_sidecar()
    tap = Q.StatsTap() if cfg.sentry else None
    monitor = (Q.QualityMonitor.from_config(cfg, parts=list(parts))
               if cfg.sentry else None)
    inj = Q.maybe_injector(start_step) if model is not None else None
    # the sentry's last fetched loss and gradient norm, for the heartbeat
    seen_vals = {"loss": None, "grad_norm": None}

    def observe(recs) -> None:
        for rec in recs:
            try:
                v = monitor.observe(*rec)
            except Q.NumericsFault as fault:
                Q.halt_for_rollback(fault, ckpt=ckpt, action=monitor.action)
            for key in seen_vals:
                x = v.get(key)
                if x is not None and np.isfinite(x):
                    seen_vals[key] = float(x)

    guard = PreemptionGuard(start_step)
    slow = StepSlowInjector()
    with tracectx.span("train", cat="train"):
        guard.install()
        try:
            for epoch in range(start_epoch, cfg.num_epochs):
                perm = permute(rng)
                skip = (start_step % steps_per_epoch
                        if epoch == start_epoch else 0)
                calls = chunk_calls([(b, gstep + b - skip)
                                     for b in range(skip, steps_per_epoch)],
                                    cfg.steps_per_call)
                t_epoch = time.time()
                losses, step_s = [], []
                seen = 0
                pipeline = prefetch_map(lambda c: sample(perm, c),
                                        [(c,) for c in calls], depth,
                                        sample_workers)
                if stage is not None:
                    pipeline = stage(pipeline)
                try:
                    for call in calls:
                        slow.maybe_drag(timer, gstep)
                        t_step = time.perf_counter()
                        with timer.phase(wait_bucket):
                            batch, n_seeds = next(pipeline)
                        with timer.phase("dispatch"):
                            loss, acc = step(batch)
                        k = len(call)
                        step_s += [(time.perf_counter() - t_step) / k] * k
                        losses.append(loss)
                        seen += n_seeds
                        prev_gstep, gstep = gstep, gstep + k
                        sps = seen / max(time.time() - t_epoch, 1e-9)
                        if (gstep // cfg.log_every
                                != prev_gstep // cfg.log_every):
                            obs.emit("train_step", epoch=epoch, step=gstep,
                                     loss=float(loss[-1]),
                                     train_acc=None if acc is None
                                     else float(acc[-1]),
                                     seeds_per_sec=sps)
                        if ckpt is not None and cfg.ckpt_every and (
                                gstep // cfg.ckpt_every
                                != prev_gstep // cfg.ckpt_every):
                            ckpt.save(gstep, state(), wait=False)
                        if tap is not None:
                            tap.push(gstep, loss[-1], step_stats())
                            observe(tap.poll_all())
                        heartbeat(gstep, epoch, timer, sps=sps,
                                  overlap_ratio=overlap_ratio(),
                                  loss=seen_vals["loss"],
                                  grad_norm=seen_vals["grad_norm"])
                        if guard.poll(gstep):
                            if tap is not None:
                                # the calls in flight, before the flush
                                observe(tap.drain_all())
                            flush_and_preempt(guard, ckpt, gstep, state())
                        if inj is not None:
                            inj.maybe_poison(gstep, model)
                finally:
                    pipeline.close()
                if tap is not None:
                    # the epoch's last calls must not escape the sentry
                    observe(tap.drain_all())
                loss_values = torch.cat(losses).tolist()  # waits for the card
                dt = time.time() - t_epoch
                rec = {"epoch": epoch, "loss": loss_values[-1],
                       "losses": loss_values, "step_s": step_s,
                       "seeds_per_sec": seen / max(dt, 1e-9), "time": dt,
                       "calls": len(calls), **timer.as_dict(),
                       **epoch_stats(len(loss_values))}
                if _eval_due(cfg, epoch):
                    t_eval = time.perf_counter()
                    accs = evaluate()
                    rec["val_acc"] = accs.get("val_mask")
                    rec["test_acc"] = accs.get("test_mask")
                    rec["eval_s"] = time.perf_counter() - t_eval
                history.append(rec)
                _record_epoch(timer, rec, t_epoch, len(loss_values))
                timer.reset()
                if ckpt is not None:
                    ckpt.save(gstep, state(), wait=False)
            train_teardown_live(gstep)
        finally:
            guard.uninstall()
            if ckpt is not None:
                ckpt.close()
    return history, gstep


class SampledTrainer:
    """Mini-batch neighbor-sampled trainer for ``DistSAGE``, ``DistGAT``
    and ``DistGATv2``.

    ``device`` is where the model, features and labels live (the
    current CUDA card when None; ``"cpu"`` on request). The model must
    already be on it; the trainer sets its dropout rate to
    ``cfg.dropout``. With ``cfg.sampler="device"`` the graph's CSR goes
    to ``device`` too, and the caps are the tree's (:func:`tree_caps`).
    """

    def __init__(self, model, g: Graph, cfg: TrainConfig,
                 train_ids: Optional[np.ndarray] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        param_devices = {p.device for p in model.parameters()}
        if param_devices != {self.device}:
            raise ValueError(f"the model's parameters are on "
                             f"{sorted(map(str, param_devices))}, the "
                             f"trainer's device is {self.device}")
        # the tuned manifest's train and quality knobs, where cfg keeps
        # the default
        cfg = apply_tuned(apply_tuned(cfg), layer="quality")
        model.dropout = float(cfg.dropout)
        self.model = model
        self.g = g
        self.cfg = cfg
        self.csc = g.csc()
        self.feats = torch.from_numpy(
            np.ascontiguousarray(g.ndata["feat"], np.float32)).to(self.device)
        self.labels = torch.from_numpy(
            g.ndata["label"].astype(np.int64)).to(self.device)
        if train_ids is None:
            train_ids = np.nonzero(g.ndata["train_mask"])[0]
        self.train_ids = np.asarray(train_ids, dtype=np.int64)
        self._device_mode = cfg.sampler == "device"
        if self._device_mode:
            # tree-form blocks: closed-form caps, no calibration probe
            self._indptr, self._indices = device_csr(self.csc, self.device)
            self._tree = TreeSampler(cfg.batch_size, cfg.fanouts,
                                     self.device, model.slot_plans)
            self.caps = self._tree.caps
        elif cfg.cap_policy == "auto":
            self.caps = calibrate_caps(
                self.csc, self.train_ids, cfg.batch_size, cfg.fanouts,
                g.num_nodes, margin=cfg.cap_margin, seed=cfg.seed)
        else:
            self.caps = fanout_caps(cfg.batch_size, cfg.fanouts,
                                    g.num_nodes)
        self.timer = PhaseTimer()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.optimizer = make_adam(model.parameters(), cfg, self.device)
        # the sentry's view of each step's update (a flat copy of the
        # parameters before Adam's step) and the last call's stats
        self._delta = (Q.ParamDelta(model.parameters()) if cfg.sentry
                       else None)
        self.last_stats: Optional[Dict[str, torch.Tensor]] = None
        # the device sampler's run state, while train() runs
        self._run: Optional[DeviceRun] = None

    # -- batches --------------------------------------------------------
    def sample(self, seeds: np.ndarray, step_seed: int) -> MiniBatch:
        """The padded host minibatch of ``seeds``; a function of
        ``(seeds, step_seed)`` alone. The blocks the model names carry
        the transpose plans their backward sums over
        (``ops/scatter.py::attach_plans``): for SAGE every block but the
        first, whose source rows are the input features and need no
        gradient; for GAT every block, per slot."""
        mb = build_fanout_blocks(self.csc, seeds, self.cfg.fanouts,
                                 seed=step_seed, src_caps=self.caps[1:])
        mb = pad_minibatch(mb, self.cfg.batch_size, self.cfg.fanouts,
                           self.g.num_nodes, caps=self.caps)
        attach_plans(mb.blocks, self.model.slot_plans)
        return mb

    def sample_pipeline(self, batches: Sequence[Tuple[np.ndarray, int]],
                        depth: Optional[int] = None) -> Iterator[MiniBatch]:
        """The padded host minibatch of each ``(seeds, step_seed)`` pair,
        in order, sampled up to ``depth`` (default ``cfg.prefetch``)
        batches ahead on :func:`resolve_num_samplers` worker threads;
        ``depth <= 0``
        samples inline. Batches depend on their pair alone, so every
        depth and worker count yields the same stream."""
        if depth is None:
            depth = self.cfg.prefetch
        return prefetch_map(self.sample, batches, depth,
                            resolve_num_samplers(self.cfg))

    def ship(self, mb: MiniBatch
             ) -> Tuple[List[FanoutBlock], torch.Tensor, torch.Tensor]:
        """The minibatch's blocks, input ids and seeds as tensors on the
        trainer's device (copied from the calling thread)."""
        blocks = [b.to(self.device) for b in mb.blocks]
        inputs = torch.from_numpy(mb.input_nodes).to(self.device)
        seeds = torch.from_numpy(mb.seeds).to(self.device)
        return blocks, inputs, seeds

    # -- step -----------------------------------------------------------
    def loss(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward of a shipped batch in ``train()`` mode: gather the
        input rows, run the model (dropout from the trainer's
        generator), and return the masked loss and accuracy."""
        blocks, inputs, seeds = batch
        self.model.train()
        h = gather_rows(self.feats, inputs)
        logits = self.model(blocks, h, generator=self.generator)
        return masked_loss(logits, self.labels, seeds)

    def step_shipped(self, batch) -> Tuple[torch.Tensor, ...]:
        """One optimizer step on a shipped batch; returns the loss and
        accuracy as device scalars (no sync), then, with the sentry,
        the step's stats (``obs/quality.py::stat_vector`` of
        ``grad_stats``). The gradients stay in ``.grad`` until the next
        step."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, acc = self.loss(batch)
        loss.backward()
        if self._delta is None:
            self.optimizer.step()
            return loss.detach(), acc.detach()
        stats = Q.grad_part([p.grad for p in self._delta.params], loss)
        self._delta.before()
        self.optimizer.step()
        stats.update(self._delta.stats())
        return loss.detach(), acc.detach(), Q.stat_vector(stats)

    def train_step(self, mb: MiniBatch) -> Tuple[torch.Tensor, ...]:
        """One optimizer step on a padded host minibatch
        (:meth:`step_shipped` of :meth:`ship`)."""
        return self.step_shipped(self.ship(mb))

    def device_sampler_step(self, seeds: torch.Tensor, gstep: torch.Tensor
                            ) -> Tuple[torch.Tensor, ...]:
        """One device-sampler step on the bank's seeds ``[1, B]``: the
        tree blocks of the draws keyed on ``(cfg.seed, gstep)``, then the
        step."""
        seeds = seeds[0]
        blocks, inputs = self._tree.sample(
            self._indptr, self._indices, seeds,
            draw_key(self.cfg.seed, gstep))
        return self.step_shipped((blocks, inputs, seeds))

    def train_call(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """The steps of one call; returns their losses and accuracies
        ``[k]`` on the device (no sync). ``batch`` is a list of host
        minibatches (a :meth:`train_step` each) or, with the device
        sampler, ``(b, step, k)``: ``k`` steps from bank row ``b`` at
        global step ``step`` (:class:`DeviceRun`). With the sentry the
        call's last step's stats are left in :attr:`last_stats`."""
        if isinstance(batch, list):
            out = [self.train_step(mb) for mb in batch]
            if self._delta is not None:
                self.last_stats = Q.stats_of_rows(out[-1][2])
            return (torch.stack([o[0] for o in out]),
                    torch.stack([o[1] for o in out]))
        out = self._run(*batch)
        if self._delta is not None:
            self.last_stats = Q.stats_of_rows(out[2:, -1])
        return out[0], out[1]

    def _start_device_run(self, steps_per_epoch: int) -> DeviceRun:
        """The device sampler's run over epochs of ``steps_per_epoch``
        steps; its calls of K > 1 steps on the card are one graph
        replay each (captured at the first)."""
        n_out = 2 + (len(Q.STAT_KEYS) if self._delta is not None else 0)
        self._run = DeviceRun(
            self.device_sampler_step, n_out,
            (steps_per_epoch, 1, self.cfg.batch_size), self._indptr.dtype,
            self.cfg.steps_per_call, self.device,
            self.device.type == "cuda", [self.generator])
        return self._run

    # -- evaluation -----------------------------------------------------
    def evaluate(self, mask_names=("val_mask", "test_mask")
                 ) -> Dict[str, float]:
        """Accuracy per node mask of full-neighborhood layer-wise
        inference with the current weights (the reference's
        ``evaluate``; ``sage_inference`` or ``gat_inference`` by the
        model's family); masks the graph lacks are skipped."""
        with torch.no_grad():
            logits = full_graph_inference(self.model, self.g, self.feats)
            correct = logits.argmax(-1) == self.labels
            out = {}
            for name in mask_names:
                if name not in self.g.ndata:
                    continue
                m = torch.from_numpy(
                    np.asarray(self.g.ndata[name], bool)).to(self.device)
                out[name] = float((correct & m).sum()
                                  / m.sum().clamp_min(1))
        return out

    # -- epoch loop -----------------------------------------------------
    def _configure_prof(self) -> None:
        """Arm the utilization profiler (``obs/prof.py``) for this run:
        the card's peaks for the model's compute, the analytic cost
        fallback (the instrumented call counts the real cost on its
        first call) and the analytic memory bill the watermark is
        reconciled against: features, labels, the weights with Adam's
        two moments, and up to ``prefetch + 2`` minibatches."""
        cfg = self.cfg
        params = list(self.model.parameters())
        param_count = sum(p.numel() for p in params)
        state_bytes = 3 * sum(p.numel() * p.element_size() for p in params)
        edges = sum(int(c) * int(f) for c, f in zip(self.caps[:-1],
                                                    cfg.fanouts))
        rows = int(self.caps[-1])
        feat_dim = int(self.feats.shape[-1])
        batch_bytes = edges * 8 + rows * feat_dim * 4
        feat_bytes = sum(t.numel() * t.element_size()
                         for t in (self.feats, self.labels))
        predicted = (feat_bytes + state_bytes
                     + (cfg.prefetch + 2) * batch_bytes) / 2**20
        compute = prof.compute_kind(getattr(self.model, "compute_dtype",
                                            None))
        prof.get_profiler().configure(
            peaks=prof.resolve_peaks(device=self.device, compute=compute),
            fallback_cost=prof.analytic_train_cost(param_count, rows,
                                                   feat_dim, edges),
            predicted_hbm_mib=round(predicted, 3), device=self.device)

    def _warm_up(self) -> None:
        """The warm-up batch (the JAX trainer initialises its params on
        it): one forward without a gradient builds the kernels and
        checks the model against the caps before the clock starts."""
        cfg = self.cfg
        with torch.no_grad():
            if self._device_mode:
                seeds = torch.full((cfg.batch_size,), -1,
                                   dtype=self._indptr.dtype)
                first = self.train_ids[:cfg.batch_size]
                seeds[:len(first)] = torch.from_numpy(first)
                seeds = seeds.to(self.device)
                blocks, inputs = self._tree.sample(
                    self._indptr, self._indices, seeds,
                    draw_key(cfg.seed ^ 0x5EED))
                self.loss((blocks, inputs, seeds))
            else:
                self.loss(self.ship(self.sample(
                    self.train_ids[:cfg.batch_size], 0)))

    def train(self, init_params=None) -> Dict:
        """Train ``cfg.num_epochs`` epochs from the model's weights, or
        from ``init_params`` (a flax-layout params tree, loaded through
        ``state_dict_from_flax``), with a fresh Adam — or, with
        ``cfg.ckpt_dir`` and ``resume="auto"``, from the newest good
        checkpoint there. Returns ``{"params": state dict, "opt_state":
        Adam's state dict, "history": one record per epoch trained,
        "step": the global step reached}``."""
        cfg = self.cfg
        if init_params is not None:
            self.model.load_state_dict(state_dict_from_flax(init_params))
        self._warm_up()
        self.optimizer = make_adam(self.model.parameters(), cfg,
                                   self.device)
        self.generator.manual_seed(cfg.seed)
        ckpt, start_step = open_checkpoints(cfg, self.model, self.optimizer)
        if start_step:
            self.generator.manual_seed(resume_seed(cfg.seed, start_step))
        self.timer.reset()
        self._configure_prof()
        B = cfg.batch_size
        steps_per_epoch = max(len(self.train_ids) // B, 1)
        suffix = "_device" if self._device_mode else ""
        call = prof.instrument_call(
            f"sampled_step{suffix}", self.train_call,
            multi_name=f"sampled_multi_step{suffix}", steps=_call_steps)

        def permute(rng):
            perm = rng.permutation(self.train_ids)
            return [perm] if self._device_mode else perm

        if self._device_mode:
            sample = self._start_device_run(steps_per_epoch).prepare
        else:
            def sample(ids, call):
                return ([self.sample(ids[b * B:(b + 1) * B], s)
                         for b, s in call],
                        sum(len(ids[b * B:(b + 1) * B]) for b, _ in call))

        try:
            history, gstep = run_epochs(
                cfg, self.timer, steps_per_epoch, start_step, ckpt,
                lambda: train_state(self.model, self.optimizer), permute,
                sample, call, self.evaluate,
                lambda steps: graph_stats(self._run),
                sample_workers=resolve_num_samplers(cfg),
                step_stats=lambda: self.last_stats,
                parts=[Q.my_partition()], model=self.model)
        finally:
            # the graph's memory pool goes with it
            self._run = None
        return {"params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict(),
                "history": history, "step": gstep}


# ----------------------------------------------------------------------
def train_full_graph(model: torch.nn.Module, g: Graph, cfg: TrainConfig,
                     pad_edges_to: Optional[int] = None,
                     init_params=None, device: DeviceLike = None) -> Dict:
    """The full-graph node-classification loop (GCN, GAT or a SAGE
    stack; the JAX package's ``train_full_graph``, the reference's Cora
    example): one Adam step a epoch on the masked cross-entropy of the
    train nodes over the whole graph (``g.to_device(pad_to=
    pad_edges_to)``), the validation accuracy every ``cfg.eval_every``
    epochs and at the last. The model's weights, or ``init_params`` (a
    flax params tree), on ``device`` (the card unless told otherwise);
    the features take the weights' dtype (a float64 model runs in
    float64 on the CPU). Returns ``{"params": the flax params tree,
    "history": [{"epoch", "loss"[, "val_acc"]}], "test_acc"}``."""
    device = resolve_device(device)
    if init_params is not None:
        model.load_state_dict(state_dict_from_flax(init_params))
    model.to(device).train()
    dg = g.to_device(device, pad_to=pad_edges_to)
    dtype = next(model.parameters()).dtype
    x = torch.from_numpy(np.ascontiguousarray(g.ndata["feat"],
                                              np.float32)).to(device, dtype)
    y = torch.from_numpy(g.ndata["label"].astype(np.int64)).to(device)
    masks = {k: torch.from_numpy(np.asarray(g.ndata[k], np.float32)
                                 ).to(device)
             for k in ("train_mask", "val_mask", "test_mask")}
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)

    def accuracy(mask):
        with torch.no_grad():
            hit = (model(dg, x).argmax(-1) == y).float() * mask
            return float(hit.sum() / mask.sum().clamp_min(1.0))

    history: List[Dict] = []
    for epoch in range(cfg.num_epochs):
        opt.zero_grad(set_to_none=True)
        ll = torch.nn.functional.cross_entropy(model(dg, x), y,
                                               reduction="none")
        mask = masks["train_mask"]
        loss = (ll * mask).sum() / mask.sum().clamp_min(1.0)
        loss.backward()
        opt.step()
        rec = {"epoch": epoch, "loss": float(loss.detach())}
        if _eval_due(cfg, epoch):
            rec["val_acc"] = accuracy(masks["val_mask"])
            print(f"Epoch {epoch} loss {rec['loss']:.4f} "
                  f"val_acc {rec['val_acc']:.4f}", flush=True)
        history.append(rec)
    return {"params": flax_params(model), "history": history,
            "test_acc": accuracy(masks["test_mask"])}
