"""Traffic kind ``closed_train``: a closed training loop through the
program's own entry point, ``SampledTrainer.train``, with the device
sampler, K steps a call.

Set-up builds one trainer over the cell's graph, the features and the
initial weights that the benchmark draws from ``--seed``, and calls
``train()``. Everything from there on runs in the program's epoch loop
(``runtime/loop.py::run_epochs``): its warm-up, its own permutation of
the training ids each epoch, the device run's staging, the sentry, the
heartbeat and the instrumented call. The harness sees the loop through
:class:`Window`, which stands in for the trainer's ``train_call`` (an
attribute that ``train()`` looks up when it starts) and passes every
call through to it.

- The first call (K steps, eager, then captured) and the second (the
  first replay) are the checked steps: the layers' inputs of the first
  call's K steps are recorded by hooks on its eager pass, the first
  gradient is read from Adam's state after one step, and the weights
  after both calls.
- The rest of the first epoch runs as set-up: its tail's single step
  and the first epoch boundary.
- The window opens at the first call of the second epoch and lasts
  ``--seconds`` on the host clock; it closes before the first call due
  after that, in a synchronize. Epoch boundaries inside it count.
- With ``--trace 1`` a stretch of ``profile_calls`` calls then runs
  under ``torch.profiler``, still inside the program's loop.

The window then ends the loop by raising :class:`WindowClosed` from the
call it declines to issue. Once the window (and the traced stretch) has
closed, the peak memory is read, the program's state is freed and the
reference follows the checked steps from the same inputs.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import check, data, devtrace
from portbench.models._tree import positions
from portbench.reference import sampler
from portbench.reference import train as reference

# calls the profiler traces before its range opens
WARM_CALLS = 2
# epochs the loop may run: more than any window reaches
EPOCHS = 1_000_000


class WindowClosed(Exception):
    """Raised from the trainer's call to end the program's loop."""


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class Window:
    """The trainer's ``train_call`` as the harness drives it: the
    checked calls, the rest of the first epoch, the timed window and
    the traced stretch, in that order (see the module's docstring).
    ``checked_only`` ends the loop after the checked calls."""

    def __init__(self, trainer, steps_per_epoch: int, seconds: float,
                 trace: bool, profile_calls: int, beta1: float,
                 checked_only: bool = False):
        self.trainer = trainer
        self.inner = trainer.train_call
        self.device = trainer.device
        self.spe = steps_per_epoch
        self.seconds = float(seconds)
        self.trace = trace
        self.profile_calls = int(profile_calls)
        self.beta1 = beta1
        self.checked_only = checked_only
        self.calls = 0
        self.in_flight = 0          # steps of the call being issued
        self.marks: Dict[str, float] = {}
        # the checked calls
        self.blocks: List[Dict] = []
        self.grads: Optional[Dict[str, torch.Tensor]] = None
        self.checked_losses: List[torch.Tensor] = []
        self.checked: List[Tuple[int, int]] = []   # (batch, global step)
        self.prog: Optional[Dict] = None
        # the window
        self.t0 = self.deadline = None
        self.window_s = None
        self.setup_end = None       # time.time() at the window's start
        self.samples = self.steps = 0
        self.host_ms: List[float] = []   # inside each call
        self.loop_ms: List[float] = []   # in the loop between calls
        self.events: List = []
        self.losses: List[torch.Tensor] = []
        self.epoch_ends: List[Dict] = []
        self._t_exit = None
        self._stage_ms: List[float] = []
        # the traced stretch
        self.profiler = self.range = None
        self.traced_calls = 0
        self.traced: List[Tuple[int, int]] = []
        self.summary = None

    # -- the program's loop calls this ----------------------------------
    def __call__(self, batch):
        b, step, k = batch
        n = self.calls
        self.calls += 1
        if n == 0:
            return self._first(batch)
        if n == 1:
            out = self._issue(batch)
            self.checked_losses.append(out[0])
            self.checked += [(b + j, step + j) for j in range(k)]
            return out
        if n == 2:
            self._snapshot()
            if self.checked_only:
                raise WindowClosed()
        if self.t0 is None:
            if step < self.spe:
                return self._issue(batch)
            self._open()
        if self.window_s is None:
            now = time.perf_counter()
            if now < self.deadline:
                return self._timed(batch, now, step)
            self._close()
            if not self.trace:
                raise WindowClosed()
            self._start_profile()
        return self._profiled(batch)

    def _issue(self, batch):
        self.in_flight = batch[2]
        out = self.inner(batch)
        self.in_flight = 0
        return out

    # -- the checked calls ------------------------------------------------
    def _first(self, batch):
        """The first call with the layers' inputs of its eager steps
        recorded, and Adam's state read after its first step."""
        b, step, k = batch
        self.marks["first_call"] = time.perf_counter()
        model, opt = self.trainer.model, self.trainer.optimizer
        names = {id(p): n for n, p in model.named_parameters()}
        current: Dict[int, Tuple] = {}

        def hook(i):
            def record(module, args):
                if _capturing(self.device):
                    return
                blk, h = args[0], args[1]
                if i == 0 and current:
                    self.blocks.append(self._block(current))
                    current.clear()
                current[i] = (blk.mask.to("cpu"), blk.nbr.to("cpu"),
                              h.detach().to("cpu") if i == 0 else None)
            return record

        seen = {"steps": 0}

        def first_gradient():
            # the gradient of the first step, as Adam took it
            self.grads = {names[id(p)]: (opt.state[p]["exp_avg"]
                                         / (1.0 - self.beta1)).cpu()
                          for p in model.parameters()
                          if "exp_avg" in opt.state.get(p, {})}

        def before_step(optimizer, args, kwargs):
            if _capturing(self.device):
                return
            seen["steps"] += 1
            if seen["steps"] == 2:
                first_gradient()

        handles = [layer.register_forward_pre_hook(hook(i))
                   for i, layer in enumerate(model.layers)]
        handles.append(opt.register_step_pre_hook(before_step))
        try:
            out = self._issue(batch)
        finally:
            for h in handles:
                h.remove()
        if current:
            self.blocks.append(self._block(current))
        if seen["steps"] == 1:      # a call of one step
            first_gradient()
        self.checked_losses.append(out[0])
        self.checked += [(b + j, step + j) for j in range(k)]
        return out

    @staticmethod
    def _block(rec: Dict[int, Tuple]) -> Dict:
        return {"masks": [rec[i][0] for i in sorted(rec)],
                "nbr": [rec[i][1] for i in sorted(rec)],
                "rows": rec[0][2]}

    def _snapshot(self) -> None:
        """The program's side of the comparison, after the checked
        calls."""
        model = self.trainer.model
        # a parameter that the optimizer never stepped holds no moment:
        # its gradient reads as zero
        grads = {n: (self.grads or {}).get(n, torch.zeros(p.shape))
                 for n, p in model.named_parameters()}
        self.prog = {"blocks": self.blocks,
                     "losses": torch.cat(self.checked_losses).tolist(),
                     "grads": grads,
                     "params": {n: p.detach().cpu().clone()
                                for n, p in model.named_parameters()}}
        self.marks["checked"] = time.perf_counter()

    # -- the window -------------------------------------------------------
    def _open(self) -> None:
        run = self.trainer._run
        stage = run.stage

        def timed_stage(id_lists):
            t = time.perf_counter()
            stage(id_lists)
            self._stage_ms.append((time.perf_counter() - t) * 1e3)

        # the device run's epoch staging, timed (the epoch ends' note)
        run.stage = timed_stage
        _sync(self.device)
        self.setup_end = time.time()
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.seconds
        if self.trace and self.device.type == "cuda":
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[-1].record()

    def _timed(self, batch, now: float, step: int):
        k = batch[2]
        if self._t_exit is not None:
            between = (now - self._t_exit) * 1e3
            self.loop_ms.append(between)
            if step % self.spe == 0:
                self.epoch_ends.append({
                    "at_s": now - self.t0, "loop_ms": between,
                    "stage_ms": self._stage_ms[-1] if self._stage_ms
                    else None})
        self.steps += k
        out = self._issue(batch)
        t = time.perf_counter()
        self.host_ms.append((t - now) * 1e3)
        if self.events:
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[-1].record()
        self.losses.append(out[0])
        self.samples += k * self.trainer.cfg.batch_size
        self._t_exit = t
        return out

    def _close(self) -> None:
        _sync(self.device)
        self.window_s = time.perf_counter() - self.t0

    # -- the traced stretch -----------------------------------------------
    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=acts)
        self.profiler.__enter__()

    def _profiled(self, batch):
        from torch.profiler import record_function

        n = self.traced_calls
        self.traced_calls += 1
        if n == WARM_CALLS:
            # the tracer's own start-up lands before the range
            _sync(self.device)
            self.range = record_function(devtrace.RANGE)
            self.range.__enter__()
        if n == WARM_CALLS + self.profile_calls:
            _sync(self.device)
            self.range.__exit__(None, None, None)
            self.profiler.__exit__(None, None, None)
            if self.device.type == "cuda":
                self.summary = devtrace.summarize(self.profiler.events())
                self.summary["steps"] = len(self.traced)
            raise WindowClosed()
        if n >= WARM_CALLS:
            b, step, k = batch
            self.traced += [(b + j, step + j) for j in range(k)]
            with record_function("portbench.call"):
                return self._issue(batch)
        return self._issue(batch)

    def abandon(self) -> None:
        """Close a profiler that an error left open."""
        if self.range is not None and self.summary is None:
            self.range.__exit__(None, None, None)
        if self.profiler is not None and self.summary is None:
            self.profiler.__exit__(None, None, None)


def program_graph(cell, arrays, phases):
    """The program's ``Graph`` of the cell's edge list with its CSC built
    (the features a broadcast zero row, filled on the card later); its
    seconds go into ``phases``."""
    from dgl_operator_tpu_torch.graph.graph import Graph

    t = time.time()
    n = int(cell.config["graph"]["num_nodes"])
    d = int(cell.config["model"]["in_feats"])
    graph = Graph(arrays["src"], arrays["dst"], n)
    graph.ndata["feat"] = np.broadcast_to(np.zeros(d, np.float32), (n, d))
    graph.ndata["label"] = arrays["labels"]
    graph.csc()
    phases["program_csc"] = time.time() - t
    return graph


def build_program(cell, seeds, arrays, device, phases, graph=None):
    """The trainer over the cell's graph (``graph``: the
    :func:`program_graph` of ``arrays``, made here when None), with the
    features and weights drawn from the seed; the seconds of each part
    go into ``phases``."""
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    cfg_m, cfg_t = cell.config["model"], cell.config["train"]
    spec = cell.config["graph"]
    if graph is None:
        graph = program_graph(cell, arrays, phases)
    t = time.time()
    model = cell.kind.build(cfg_m, device)
    model.load_state_dict(data.init_weights(cell.kind.param_spec(cfg_m),
                                            seeds["weights"], device))
    traffic = cell.traffic
    cfg = TrainConfig(num_epochs=EPOCHS,
                      batch_size=int(cfg_t["batch_size"]),
                      lr=float(cfg_t["optimizer"]["lr"]),
                      fanouts=tuple(cfg_t["fanouts"]),
                      eval_every=int(traffic["eval_every"]),
                      dropout=float(cfg_m["dropout"]),
                      seed=seeds["program"], sampler=traffic["sampler"],
                      steps_per_call=int(traffic["steps_per_call"]),
                      resume="never", sentry=bool(cfg_t["sentry"]))
    trainer = SampledTrainer(model, graph, cfg,
                             train_ids=arrays["train_ids"], device=device)
    phases["program_trainer"] = time.time() - t
    t = time.time()
    labels = torch.from_numpy(arrays["labels"]).to(device)
    data.fill_features(trainer.feats, labels, seeds["features"],
                       float(spec["feat_noise"]))
    del labels
    _sync(device)
    phases["features"] = time.time() - t
    return trainer


def drive(cell, seeds, arrays, device, seconds: float, trace: bool,
          phases: Dict, checked_only: bool = False, graph=None):
    """Build the trainer and run ``train()`` under a :class:`Window`
    until the window closes it; returns ``(window, error)``, where
    ``error`` is what the loop raised besides :class:`WindowClosed`."""
    trainer = build_program(cell, seeds, arrays, device, phases, graph)
    cfg_t = cell.config["train"]
    spe = len(arrays["train_ids"]) // int(cfg_t["batch_size"])
    k = int(cell.traffic["steps_per_call"])
    if spe < 2 * k + 1:
        raise ValueError(f"an epoch of {spe} steps is shorter than the "
                         f"checked calls")
    win = Window(trainer, spe, seconds, trace,
                 int(cell.traffic["profile_calls"]),
                 float(cfg_t["optimizer"]["betas"][0]), checked_only)
    trainer.train_call = win
    error = None
    t = time.perf_counter()
    try:
        trainer.train()
    except WindowClosed:
        pass
    except Exception as exc:     # a step or the loop that raises fails
        error = repr(exc)
        win.abandon()
    finally:
        del trainer.train_call
    if "first_call" in win.marks:
        phases["train_start"] = win.marks["first_call"] - t
    if "checked" in win.marks:
        phases["checked_calls"] = win.marks["checked"] \
            - win.marks["first_call"]
        if win.t0 is not None:
            phases["first_epoch_rest"] = win.t0 - win.marks["checked"]
    return win, error


def checked_steps(win: Window, train_ids: np.ndarray, order_seed: int,
                  batch: int) -> List[Tuple[np.ndarray, int]]:
    """``(seeds, global step)`` of each checked step, the seeds from the
    program's permutation drawn again from its seed."""
    return _steps_of(win.checked, train_ids, order_seed, batch, win.spe)


def _steps_of(steps: List[Tuple[int, int]], train_ids: np.ndarray,
              order_seed: int, batch: int, spe: int
              ) -> List[Tuple[np.ndarray, int]]:
    """The seeds of each ``(batch of the epoch, global step)``: the
    program's epochs permute the ids from one numpy stream seeded with
    its seed (``run_epochs``), which is drawn again here."""
    if not steps:
        return []
    orders = data.epoch_orders(train_ids, order_seed)
    perms = [next(orders) for _ in range(max(g for _, g in steps) // spe + 1)]
    return [(perms[g // spe][b * batch:(b + 1) * batch], g)
            for b, g in steps]


def run(cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> Dict:
    """One run of ``cell``; returns what the harness reads:
    ``correct``, ``attempted``, ``failed``, ``compared``,
    ``memory_peak_bytes``, ``ctx`` (what the metric readers read),
    ``trace`` (the traced stretch's summary or None) and ``error``."""
    cfg_t = cell.config["train"]
    if cfg_t["precision"] != "float32":
        raise ValueError("closed_train runs float32 configurations")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = data.run_seeds(seed)
    phases = {"to_driver": time.time() - t_start}
    t = time.time()
    arrays = data.load_graph(cell.config["graph"])
    phases["graph"] = time.time() - t
    win, error = drive(cell, seeds, arrays, device, seconds, trace, phases)
    cuda = device.type == "cuda"
    setup_s = (win.setup_end or time.time()) - t_start
    attempted, failed = win.steps, 0
    if error is not None:
        attempted += win.in_flight
        failed += max(win.in_flight, 1)
    if win.losses:
        failed += int((~torch.isfinite(torch.cat(win.losses))).sum())
    if win.prog is None or win.window_s is None:
        error = error or "the loop ended before the window closed"
    gaps = [a.elapsed_time(b) for a, b in zip(win.events, win.events[1:])]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    prog, summary = win.prog, win.summary
    batch = int(cfg_t["batch_size"])
    checked = checked_steps(win, arrays["train_ids"], seeds["program"],
                            batch)
    traced = _steps_of(win.traced, arrays["train_ids"], seeds["program"],
                       batch, win.spe) if summary is not None else []
    notes = {"start_unix": win.setup_end, "seconds": win.window_s,
             "calls": len(win.host_ms),
             "host_ms_in_calls": sum(win.host_ms),
             "loop_ms_between_calls": sum(win.loop_ms),
             "epoch_ends": win.epoch_ends}
    ctx = {"setup_s": setup_s, "window_s": win.window_s,
           "samples": win.samples, "steps": attempted,
           "calls": len(win.host_ms) or None, "host_call_ms": win.host_ms,
           "epoch_end_ms": [e["loop_ms"] for e in win.epoch_ends],
           "call_gap_ms": gaps,
           "peak_bytes": peak, "trace": summary, "on_card": cuda,
           "precision": cfg_t["precision"], "setup_phases": phases,
           "graph": {"nodes": int(cell.config["graph"]["num_nodes"]),
                     "edges": int(arrays["src"].shape[0]),
                     "train_ids": int(arrays["train_ids"].shape[0])},
           "window_note": notes}
    del win
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    judged = check.judge({}, cell.limits)
    if prog is not None:
        inputs = reference_inputs(cell, seeds, arrays, checked, device)
        values = compare(prog, follow(cell, inputs), inputs)
        judged = check.judge(values, cell.limits)
        if traced:
            ctx.update(_traced_work(cell, inputs, traced))
    return {"correct": check.passes(judged) and failed == 0
            and error is None, "attempted": attempted, "failed": failed,
            "compared": judged, "memory_peak_bytes": peak, "ctx": ctx,
            "trace": summary, "error": error}


def reference_inputs(cell, seeds, arrays, steps, device) -> Dict:
    """What the reference is handed: its own in-edge lists of the edge
    list, the features and initial weights drawn again from the seed,
    the labels, and each checked step's seeds and draw key."""
    cfg_m = cell.config["model"]
    spec = cell.config["graph"]
    n, d = int(spec["num_nodes"]), int(cfg_m["in_feats"])
    indptr, indices = sampler.in_csr(
        torch.from_numpy(arrays["src"]).to(device),
        torch.from_numpy(arrays["dst"]).to(device), n)
    labels = torch.from_numpy(arrays["labels"]).to(device)
    feats = data.fill_features(torch.empty((n, d), device=device), labels,
                               seeds["features"], float(spec["feat_noise"]))
    init = data.init_weights(cell.kind.param_spec(cfg_m), seeds["weights"],
                             device)
    return {"indptr": indptr, "indices": indices, "labels": labels,
            "feats": feats, "init": init, "program_seed": seeds["program"],
            "steps": [(torch.from_numpy(s).to(device),
                       sampler.draw_key(seeds["program"], g))
                      for s, g in steps],
            "block_steps": int(cell.traffic["steps_per_call"])}


def follow(cell, inputs: Dict, **variant) -> Dict:
    """:func:`reference.follow` of the checked steps on ``inputs``
    (``variant``: its ``precision`` or ``fault``), keeping the blocks
    of the first call's steps."""
    cfg_m, cfg_t = cell.config["model"], cell.config["train"]
    return reference.follow(
        cfg_m["kind"], cfg_m, cfg_t["optimizer"], cfg_t["fanouts"],
        inputs["indptr"], inputs["indices"], inputs["feats"],
        inputs["labels"], inputs["init"], inputs["steps"],
        inputs["program_seed"], float(cfg_m["dropout"]),
        block_steps=inputs["block_steps"], **variant)


def compare(prog: Dict, ref: Dict, inputs: Dict) -> Dict[str, float]:
    """:func:`check.compare` of a side against the reference's result
    ``ref`` on ``inputs``."""
    return check.compare(prog, dict(ref, feats=inputs["feats"]),
                         {k: v.cpu() for k, v in inputs["init"].items()})


def as_program(res: Dict, inputs: Dict) -> Dict:
    """A reference result laid out as the program's side of the
    comparison (for the control and the faults, put in its place)."""
    return {"blocks": [{"masks": [m.to(torch.uint8).cpu() for m in masks],
                        "nbr": [positions(m).cpu() for m in masks],
                        "rows": inputs["feats"].index_select(0, ids).cpu()}
                       for masks, ids in res["blocks"]],
            "losses": res["losses"],
            "grads": {k: v.cpu() for k, v in res["grads"].items()},
            "params": {k: v.cpu() for k, v in res["params"].items()}}


def _traced_work(cell, inputs: Dict, traced) -> Dict:
    """Each traced step's blocks drawn again by the reference's sampler:
    the model FLOPs of a step (their mean) and the least seconds of the
    port's launches over the traced steps."""
    from portbench.arith import bounds

    indptr, indices = inputs["indptr"], inputs["indices"]
    fanouts = cell.config["train"]["fanouts"]
    cfg_m = cell.config["model"]
    flops, least = [], 0.0
    for seeds_np, gstep in traced:
        s = torch.from_numpy(seeds_np).to(indptr.device)
        masks, ids = sampler.sample_tree(indptr, indices, s, fanouts,
                                         sampler.draw_key(
                                             inputs["program_seed"], gstep))
        flops.append(cell.kind.step_flops(cfg_m, masks, int((s >= 0).sum())))
        least += sum(bounds.least_seconds(w)
                     for _, w in cell.kind.kernel_work(cfg_m, masks, ids))
    return {"step_flops": sum(flops) / len(flops), "port_least_s": least}
