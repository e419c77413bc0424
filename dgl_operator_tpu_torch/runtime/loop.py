"""The sampled trainer — ``SampledTrainer`` on the host sampler.

The counterpart of ``dgl_operator_tpu/runtime/loop.py::SampledTrainer``
(the reference's ``train_dist.py`` run loop): each epoch permutes the
training ids with one seeded numpy stream, cuts them into batches,
samples and pads each batch on the host (on a thread pipeline when
``prefetch > 0``), and takes one step per batch on the card: the input
rows are gathered by the hand-written ``gather_rows`` kernel, the model
aggregates with ``fanout_agg`` and its backward with
``scatter_add_rows``, and ``torch.optim.Adam`` updates the weights.
Evaluation runs ``sage_inference`` over the full graph.

What the JAX trainer also carries and this one does not yet: the device
sampler, ``steps_per_call`` scans, checkpoints and resume, the numerics
sentry, the live plane and chaos hooks (``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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
from dgl_operator_tpu_torch.runtime.timers import PhaseTimer

_ROADMAP = "ROADMAP.md Queue 1"


@dataclasses.dataclass
class TrainConfig:
    """The JAX ``TrainConfig``'s fields and defaults for the knobs this
    trainer honours. ``sampler``, ``steps_per_call`` and ``ckpt_dir``
    take only their defaults; the JAX fields not listed here are not
    ported, so passing one is a ``TypeError``."""

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
    # "auto" calibrates per-layer caps from sampled batches; "worst"
    # keeps the analytic bound
    cap_policy: str = "auto"
    cap_margin: float = 1.08
    # batches sampled ahead of the step on worker threads; 0 samples
    # inline on the loop thread
    prefetch: int = 2
    # sampler threads; 0 means 1 (the JAX package's launcher plumb,
    # TPU_OPERATOR_NUM_SAMPLERS, has no counterpart here)
    num_samplers: int = 0
    steps_per_call: int = 1
    sampler: str = "host"

    def __post_init__(self):
        if self.sampler != "host":
            raise NotImplementedError(
                f"sampler={self.sampler!r}: only the host sampler is "
                f"ported (the device sampler is {_ROADMAP} item 7)")
        if self.steps_per_call != 1:
            raise NotImplementedError(
                f"steps_per_call={self.steps_per_call}: only 1 is ported "
                f"({_ROADMAP} item 1)")
        if self.ckpt_dir is not None:
            raise NotImplementedError(
                f"ckpt_dir: training checkpoints are not ported "
                f"({_ROADMAP} item 1)")
        if self.cap_policy not in ("auto", "worst"):
            raise ValueError(f"cap_policy must be 'auto' or 'worst', got "
                             f"{self.cap_policy!r}")
        if self.num_samplers < 0 or self.prefetch < 0:
            raise ValueError("num_samplers and prefetch must be >= 0")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got "
                             f"{self.dropout}")


def _eval_due(cfg: TrainConfig, epoch: int) -> bool:
    """Every ``eval_every`` epochs plus the final one; 0 disables."""
    return bool(cfg.eval_every) and ((epoch + 1) % cfg.eval_every == 0
                                     or epoch == cfg.num_epochs - 1)


def masked_loss(logits: torch.Tensor, labels: torch.Tensor,
                seeds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy and accuracy over the valid seed rows
    (``seeds >= 0``; padded seeds are -1)."""
    valid = (seeds >= 0).float()
    lab = labels[seeds.clamp_min(0).long()]
    ll = F.cross_entropy(logits, lab, reduction="none")
    n = valid.sum().clamp_min(1.0)
    loss = (ll * valid).sum() / n
    acc = ((logits.argmax(-1) == lab).float() * valid).sum() / n
    return loss, acc


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
        ``(seeds, step_seed)`` alone."""
        mb = build_fanout_blocks(self.csc, seeds, self.cfg.fanouts,
                                 seed=step_seed, src_caps=self.caps[1:])
        return pad_minibatch(mb, self.cfg.batch_size, self.cfg.fanouts,
                             self.g.num_nodes, caps=self.caps)

    def sample_pipeline(self, batches: Sequence[Tuple[np.ndarray, int]],
                        depth: Optional[int] = None) -> Iterator[MiniBatch]:
        """The padded host minibatch of each ``(seeds, step_seed)`` pair,
        in order, sampled up to ``depth`` (default ``cfg.prefetch``)
        batches ahead on ``num_samplers`` worker threads; ``depth <= 0``
        samples inline. Batches depend on their pair alone, so every
        depth and worker count yields the same stream."""
        if depth is None:
            depth = self.cfg.prefetch
        if depth <= 0:
            for seeds, step_seed in batches:
                yield self.sample(seeds, step_seed)
            return
        workers = min(max(self.cfg.num_samplers, 1), depth + 1)
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="sampler") as pool:
            pending = []
            it = iter(batches)
            try:
                while True:
                    while len(pending) < depth + 1:
                        nxt = next(it, None)
                        if nxt is None:
                            break
                        pending.append(pool.submit(self.sample, *nxt))
                    if not pending:
                        return
                    yield pending.pop(0).result()
            finally:
                for fut in pending:
                    fut.cancel()

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
        ``state_dict_from_flax``), with a fresh Adam. Returns
        ``{"params": state dict, "opt_state": Adam's state dict,
        "history": one record per epoch, "step": steps taken}``."""
        cfg = self.cfg
        if init_params is not None:
            self.model.load_state_dict(state_dict_from_flax(init_params))
        rng = np.random.default_rng(cfg.seed)
        # the warm-up batch (the JAX trainer initialises its params on
        # it): one forward without a gradient builds the kernels and
        # checks the model against the caps before the clock starts
        with torch.no_grad():
            self.loss(self.ship(self.sample(
                self.train_ids[: cfg.batch_size], 0)))
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=cfg.lr)
        self.generator.manual_seed(cfg.seed)
        self.timer.reset()
        obs = get_obs()
        history: List[Dict] = []
        gstep = 0
        steps_per_epoch = max(len(self.train_ids) // cfg.batch_size, 1)
        # inline sampling is sampling work; with a pipeline, time spent
        # waiting for a batch is a stall
        wait_bucket = "sample" if cfg.prefetch <= 0 else "stall"
        for epoch in range(cfg.num_epochs):
            ids = rng.permutation(self.train_ids)
            t_epoch = time.time()
            batches = [(ids[b * cfg.batch_size:(b + 1) * cfg.batch_size],
                        gstep + b) for b in range(steps_per_epoch)]
            losses, step_s = [], []
            seen = 0
            pipeline = self.sample_pipeline(batches)
            try:
                for seeds, _ in batches:
                    t_step = time.perf_counter()
                    with self.timer.phase(wait_bucket):
                        mb = next(pipeline)
                    with self.timer.phase("dispatch"):
                        loss, acc = self.train_step(mb)
                    step_s.append(time.perf_counter() - t_step)
                    losses.append(loss)
                    seen += len(seeds)
                    prev_gstep, gstep = gstep, gstep + 1
                    if gstep // cfg.log_every != prev_gstep // cfg.log_every:
                        obs.emit("train_step", epoch=epoch, step=gstep,
                                 loss=float(loss), train_acc=float(acc),
                                 seeds_per_sec=seen / max(
                                     time.time() - t_epoch, 1e-9))
            finally:
                pipeline.close()
            loss_values = torch.stack(losses).tolist()   # waits for the card
            dt = time.time() - t_epoch
            rec = {"epoch": epoch, "loss": loss_values[-1],
                   "losses": loss_values, "step_s": step_s,
                   "seeds_per_sec": seen / max(dt, 1e-9), "time": dt,
                   **self.timer.as_dict()}
            if _eval_due(cfg, epoch):
                t_eval = time.perf_counter()
                accs = self.evaluate()
                rec["val_acc"] = accs.get("val_mask")
                rec["test_acc"] = accs.get("test_mask")
                rec["eval_s"] = time.perf_counter() - t_eval
            obs.emit("epoch", **{k: v for k, v in rec.items()
                                 if not isinstance(v, list)})
            history.append(rec)
            self.timer.reset()
        return {"params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict(),
                "history": history, "step": gstep}
