"""The sampled trainer — ``SampledTrainer`` on the host sampler.

The counterpart of ``dgl_operator_tpu/runtime/loop.py::SampledTrainer``
(the reference's ``train_dist.py`` run loop): each epoch permutes the
training ids with one seeded numpy stream, cuts them into batches,
samples each batch on the host through the C++ graph core and pads it
(on a thread pipeline when ``prefetch > 0``; the graph core releases
the interpreter lock, so sampler threads overlap), and takes one step
per batch on the card: the input
rows are gathered by the hand-written ``gather_rows`` kernel, the model
aggregates with ``fanout_agg`` and its backward with
``scatter_add_rows`` (over the transpose plans the sampler attaches to
the blocks), and ``torch.optim.Adam`` updates the weights.
Evaluation runs ``sage_inference`` over the full graph. With
``ckpt_dir`` the model and Adam's state are checkpointed every
``ckpt_every`` steps and at each epoch's end, and a new run resumes
from the newest good checkpoint (``resume="auto"``).

What the JAX trainer also carries and this one does not yet: the device
sampler, ``steps_per_call`` scans, the numerics sentry, the live plane
and chaos hooks (``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.graph.blocks import (FanoutBlock, MiniBatch,
                                                 build_fanout_blocks,
                                                 calibrate_caps, fanout_caps,
                                                 pad_minibatch)
from dgl_operator_tpu_torch.graph.graph import Graph
from dgl_operator_tpu_torch.models.sage import (sage_inference,
                                                state_dict_from_flax)
from dgl_operator_tpu_torch.obs import get_obs
from dgl_operator_tpu_torch.ops.gather import gather_rows
from dgl_operator_tpu_torch.ops.scatter import scatter_plan
from dgl_operator_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                       load_train_state,
                                                       train_state)
from dgl_operator_tpu_torch.runtime.forward import masked_loss
from dgl_operator_tpu_torch.runtime.timers import PhaseTimer

_ROADMAP = "ROADMAP.md Queue 1"
FEATS_LAYOUTS = ("replicated", "owner")
RESUME_POLICIES = ("auto", "never")
# the launcher's sampler-width plumb (the entry point's --num_workers)
NUM_SAMPLERS_ENV = "TPU_OPERATOR_NUM_SAMPLERS"


@dataclasses.dataclass
class TrainConfig:
    """The JAX ``TrainConfig``'s fields and defaults for the knobs the
    two trainers honour. ``sampler``, ``steps_per_call``, ``feat_dtype``,
    ``shard_update``, ``shard_rules``, ``zero_stage`` and
    ``tp_axis_size`` take only their defaults (another value raises
    ``NotImplementedError``); the JAX fields not listed here are not
    ported, so passing one is a ``TypeError``. ``feats_layout`` and
    ``halo_cache_frac`` are read by ``DistTrainer`` only."""

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
    steps_per_call: int = 1
    sampler: str = "host"
    # DistTrainer: "replicated" stores each slot's core and halo rows;
    # "owner" stores core rows plus a hot-halo cache of halo_cache_frac
    # of the halo and exchanges the rest each step
    feats_layout: str = "replicated"
    halo_cache_frac: float = 0.25
    feat_dtype: str = "float32"
    shard_update: bool = False
    shard_rules: Optional[tuple] = None
    zero_stage: int = 1
    tp_axis_size: int = 1

    def __post_init__(self):
        if self.sampler != "host":
            raise NotImplementedError(
                f"sampler={self.sampler!r}: only the host sampler is "
                f"ported (the device sampler is {_ROADMAP} item 6)")
        if self.steps_per_call != 1:
            raise NotImplementedError(
                f"steps_per_call={self.steps_per_call}: only 1 is ported "
                f"({_ROADMAP} item 1)")
        unported = {"feat_dtype": self.feat_dtype != "float32",
                    "shard_update": bool(self.shard_update),
                    "shard_rules": self.shard_rules is not None,
                    "zero_stage": self.zero_stage != 1,
                    "tp_axis_size": self.tp_axis_size != 1}
        for name, set_ in unported.items():
            if set_:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r}: only the default is "
                    f"ported ({_ROADMAP})")
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
                     optimizer: torch.optim.Optimizer
                     ) -> Tuple[Optional[CheckpointManager], int]:
    """The run's checkpoint manager (None without ``cfg.ckpt_dir``) and
    the global step it starts from. With ``resume="auto"`` the newest
    good checkpoint is loaded into ``model`` and ``optimizer``."""
    if cfg.ckpt_dir is None:
        return None, 0
    ckpt = CheckpointManager(cfg.ckpt_dir)
    if cfg.resume != "auto":
        return ckpt, 0
    start_step, state = ckpt.restore(None, train_state(model, optimizer))
    if start_step:
        load_train_state(model, optimizer, state)
        obs = get_obs()
        obs.metrics.counter("train_resumes_total",
                            "trainings resumed from a checkpoint").inc()
        obs.emit("train_resume", step=start_step)
    return ckpt, start_step


def run_epochs(cfg: TrainConfig, timer: PhaseTimer, steps_per_epoch: int,
               start_step: int, ckpt: Optional[CheckpointManager],
               state: Callable[[], Dict],
               permute: Callable[[np.random.Generator], object],
               sample: Callable[[object, int, int], Tuple[object, int]],
               step: Callable[[object], Tuple[torch.Tensor,
                                              Optional[torch.Tensor]]],
               evaluate: Callable[[], Dict[str, float]],
               epoch_stats: Callable[[int], Dict] = lambda steps: {},
               sample_workers: int = 1) -> Tuple[List[Dict], int]:
    """The epoch loop both trainers run, from global step
    ``start_step`` to ``cfg.num_epochs`` epochs; returns the per-epoch
    records and the final global step.

    Each epoch draws ``permute(rng)`` from one numpy stream seeded with
    ``cfg.seed`` (replayed over the epochs a resume skips, so the
    resumed epoch sees the uninterrupted run's shuffle), skips the steps
    a mid-epoch resume already took, samples ``sample(perm, b,
    step_seed) -> (batch, seeds)`` for batch ``b`` on the prefetch
    pipeline, ``cfg.prefetch`` batches ahead on ``sample_workers``
    threads (``step_seed`` is the batch's global step), and takes
    ``step(batch) -> (loss, acc or None)``. ``state()`` is saved every
    ``cfg.ckpt_every`` steps and at each epoch's end (asynchronously;
    the last write is drained before this returns). ``epoch_stats(n)``
    adds the trainer's own fields to the record of an epoch of ``n``
    steps."""
    rng = np.random.default_rng(cfg.seed)
    start_epoch = start_step // steps_per_epoch
    for _ in range(start_epoch):
        permute(rng)
    obs = get_obs()
    history: List[Dict] = []
    gstep = start_step
    # inline sampling is sampling work; with a pipeline, time spent
    # waiting for a batch is a stall
    wait_bucket = "sample" if cfg.prefetch <= 0 else "stall"
    try:
        for epoch in range(start_epoch, cfg.num_epochs):
            perm = permute(rng)
            skip = start_step % steps_per_epoch if epoch == start_epoch else 0
            steps = [(b, gstep + b - skip)
                     for b in range(skip, steps_per_epoch)]
            t_epoch = time.time()
            losses, step_s = [], []
            seen = 0
            pipeline = prefetch_map(lambda b, s: sample(perm, b, s), steps,
                                    cfg.prefetch, sample_workers)
            try:
                for _ in steps:
                    t_step = time.perf_counter()
                    with timer.phase(wait_bucket):
                        batch, n_seeds = next(pipeline)
                    with timer.phase("dispatch"):
                        loss, acc = step(batch)
                    step_s.append(time.perf_counter() - t_step)
                    losses.append(loss)
                    seen += n_seeds
                    prev_gstep, gstep = gstep, gstep + 1
                    if gstep // cfg.log_every != prev_gstep // cfg.log_every:
                        obs.emit("train_step", epoch=epoch, step=gstep,
                                 loss=float(loss),
                                 train_acc=None if acc is None
                                 else float(acc),
                                 seeds_per_sec=seen / max(
                                     time.time() - t_epoch, 1e-9))
                    if ckpt is not None and cfg.ckpt_every and (
                            gstep // cfg.ckpt_every
                            != prev_gstep // cfg.ckpt_every):
                        ckpt.save(gstep, state(), wait=False)
            finally:
                pipeline.close()
            loss_values = torch.stack(losses).tolist()   # waits for the card
            dt = time.time() - t_epoch
            rec = {"epoch": epoch, "loss": loss_values[-1],
                   "losses": loss_values, "step_s": step_s,
                   "seeds_per_sec": seen / max(dt, 1e-9), "time": dt,
                   **timer.as_dict(), **epoch_stats(len(steps))}
            if _eval_due(cfg, epoch):
                t_eval = time.perf_counter()
                accs = evaluate()
                rec["val_acc"] = accs.get("val_mask")
                rec["test_acc"] = accs.get("test_mask")
                rec["eval_s"] = time.perf_counter() - t_eval
            obs.emit("epoch", **{k: v for k, v in rec.items()
                                 if not isinstance(v, list)})
            history.append(rec)
            timer.reset()
            if ckpt is not None:
                ckpt.save(gstep, state(), wait=False)
    finally:
        if ckpt is not None:
            ckpt.close()
    return history, gstep


class SampledTrainer:
    """Mini-batch neighbor-sampled trainer for ``DistSAGE``.

    ``device`` is where the model, features and labels live (the
    current CUDA card when None; ``"cpu"`` on request). The model must
    already be on it; the trainer sets its dropout rate to
    ``cfg.dropout``.
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
        if cfg.cap_policy == "auto":
            self.caps = calibrate_caps(
                self.csc, self.train_ids, cfg.batch_size, cfg.fanouts,
                g.num_nodes, margin=cfg.cap_margin, seed=cfg.seed)
        else:
            self.caps = fanout_caps(cfg.batch_size, cfg.fanouts,
                                    g.num_nodes)
        self.timer = PhaseTimer()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr)

    # -- batches --------------------------------------------------------
    def sample(self, seeds: np.ndarray, step_seed: int) -> MiniBatch:
        """The padded host minibatch of ``seeds``; a function of
        ``(seeds, step_seed)`` alone. Every block but the first carries
        the transpose plan its aggregation's backward sums over; the
        first one's source rows are the input features, which need no
        gradient."""
        mb = build_fanout_blocks(self.csc, seeds, self.cfg.fanouts,
                                 seed=step_seed, src_caps=self.caps[1:])
        mb = pad_minibatch(mb, self.cfg.batch_size, self.cfg.fanouts,
                           self.g.num_nodes, caps=self.caps)
        for blk in mb.blocks[1:]:
            blk.plan = scatter_plan(blk.nbr, blk.mask, blk.num_src)
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

    def train_step(self, mb: MiniBatch
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step on a padded host minibatch; returns the
        loss and accuracy as device scalars (no sync). The gradients
        stay in ``.grad`` until the next step."""
        batch = self.ship(mb)
        self.optimizer.zero_grad(set_to_none=True)
        loss, acc = self.loss(batch)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), acc

    # -- evaluation -----------------------------------------------------
    def evaluate(self, mask_names=("val_mask", "test_mask")
                 ) -> Dict[str, float]:
        """Accuracy per node mask of full-neighborhood layer-wise
        inference with the current weights (the reference's
        ``evaluate``); masks the graph lacks are skipped."""
        with torch.no_grad():
            logits = sage_inference(self.model, self.g, self.feats)
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
        # the warm-up batch (the JAX trainer initialises its params on
        # it): one forward without a gradient builds the kernels and
        # checks the model against the caps before the clock starts
        with torch.no_grad():
            self.loss(self.ship(self.sample(
                self.train_ids[: cfg.batch_size], 0)))
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=cfg.lr)
        self.generator.manual_seed(cfg.seed)
        ckpt, start_step = open_checkpoints(cfg, self.model, self.optimizer)
        if start_step:
            self.generator.manual_seed(resume_seed(cfg.seed, start_step))
        self.timer.reset()
        B = cfg.batch_size

        def sample(ids, b, step_seed):
            seeds = ids[b * B:(b + 1) * B]
            return self.sample(seeds, step_seed), len(seeds)

        history, gstep = run_epochs(
            cfg, self.timer, max(len(self.train_ids) // B, 1), start_step,
            ckpt, lambda: train_state(self.model, self.optimizer),
            lambda rng: rng.permutation(self.train_ids), sample,
            self.train_step, self.evaluate,
            sample_workers=resolve_num_samplers(cfg))
        return {"params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict(),
                "history": history, "step": gstep}
