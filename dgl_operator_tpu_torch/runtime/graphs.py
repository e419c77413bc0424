"""K optimizer steps as one CUDA graph replay — the counterpart of the
JAX trainers' ``lax.scan`` over ``steps_per_call`` steps.

:class:`GraphedCall` wraps a function that runs one call's K steps on
the card with no host sync and static shapes (the device sampler's
step, reading its seeds and step counter from device tensors, and
writing its losses into a static buffer). Its first call is the
warm-up: the K steps run eagerly on a side stream (building the
kernels, Adam's state, cuBLAS's workspace), and then the same function
is captured on that stream into a ``torch.cuda.CUDAGraph``. Every later
call is one ``replay()``. The graph reads and writes the tensors the
capture saw, in place: the parameters, Adam's state, the trainer's
buffers; the gradients and temporaries live in the graph's own memory
pool. The generators that the steps draw from (dropout's) are
registered with the graph, so each replay advances them as the eager
steps would.

The port's kernel wrappers count a launch in Python, which runs only
at capture; the capture launches nothing, so its counts are taken
back, and each replay adds the counts of one captured call. A capture
is the port's compile (``obs/prof.py::note_capture``: a
``jit_compile`` event of the program being called); a cost count open
around the first call takes the eager warm-up's K steps and never the
capture (``prof.suspended``).

:class:`DeviceRun` is the device sampler's run state that both trainers
share: the epoch's seed bank, the device counters its steps read, and
the calls of K steps, replayed or eager. Its staging, replays, eager
calls and the capture are hot-path spans (``devrun.stage``,
``devrun.replay``, ``devrun.eager``, ``devrun.capture``;
``obs/trace.py::hot_span``).

With the trace switch on when it is built, a :class:`DeviceRun` given
``phases`` keeps a :class:`PhaseClock`: the step marks the boundaries
of its phases (``sample``, ``model``, ``sentry``, ``update``) with
timing events that the capture puts into the graph, and
:meth:`DeviceRun.read_phases`, called after a sync the loop makes
anyway, adds the last completed replay's interval µs per phase to the
process's counters (``obs/trace.py::add_phases``). It never syncs.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from dgl_operator_tpu_torch.obs import prof
from dgl_operator_tpu_torch.obs import trace
from dgl_operator_tpu_torch.ops.fanout import fanout_agg
from dgl_operator_tpu_torch.ops.gather import gather_rows
from dgl_operator_tpu_torch.ops.scatter import scatter_add_rows

KERNEL_WRAPPERS = (fanout_agg, gather_rows, scatter_add_rows)


def _counts() -> Dict[Callable, int]:
    return {w: w.launches for w in KERNEL_WRAPPERS}


class GraphedCall:
    """``fn() -> Tensor`` (K steps, returning a static result buffer)
    run eagerly once on ``device``, then captured and replayed; every
    call returns a copy of the buffer. A failed capture raises."""

    def __init__(self, fn: Callable[[], torch.Tensor], device: torch.device,
                 generators: Sequence[torch.Generator] = ()):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not "
                             f"{device}")
        self.fn = fn
        self.device = device
        self.generators = tuple(generators)
        self.graph = None
        self.replays = 0
        # launches of one replay, by kernel wrapper name
        self.launches_per_replay: Dict[str, int] = {}
        self._out = None

    def __call__(self) -> torch.Tensor:
        if self.graph is None:
            return self._warm_up_and_capture()
        with trace.hot_span("devrun.replay"):
            self.graph.replay()
        self.replays += 1
        for w in KERNEL_WRAPPERS:
            w.launches += self.launches_per_replay[w.__name__]
        return self._out.clone()

    def _warm_up_and_capture(self) -> torch.Tensor:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn().clone()
        # a dead trainer waits for the cycle collector (its device run
        # holds its bound step), owning events, pinned buffers and a
        # graph's pool; collected mid-capture, their CUDA calls would
        # invalidate the capture. Collect now, and nothing inside it.
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        before = _counts()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        try:
            # a cost count open around this call took the eager
            # warm-up's steps; the capture is counted by nothing
            with trace.hot_span("devrun.capture"), prof.suspended(), \
                    torch.cuda.graph(graph, stream=side):
                self._out = self.fn()
        finally:
            if gc_on:
                gc.enable()
        prof.note_capture(time.perf_counter() - t0)
        after = _counts()
        for w in KERNEL_WRAPPERS:
            w.launches = before[w]
        self.launches_per_replay = {w.__name__: after[w] - before[w]
                                    for w in KERNEL_WRAPPERS}
        current.wait_stream(side)
        self.graph = graph
        return out


class PhaseClock:
    """Timing events at the phase boundaries of a captured call's
    steps. While :attr:`armed` (the capture of a K-step call),
    :meth:`mark` records an event, captured as an event-record node;
    ``mark(None)`` opens the call and ``mark(phase)`` closes the span
    of ``phase`` that began at the previous mark. Every replay records
    the same events again, so after a replay has completed, the time
    between consecutive marks is the interval of each phase of each of
    its steps on the card: its kernels' time and the gaps between
    them. The wait between a replay's launch and its first mark is in
    no phase."""

    def __init__(self, steps: int):
        self.steps = int(steps)
        self.armed = False
        self.marks: List[Tuple[Optional[str], torch.cuda.Event]] = []
        self.read_at = 0            # the replays counted so far

    def mark(self, phase: Optional[str]) -> None:
        if self.armed:
            ev = torch.cuda.Event(enable_timing=True, external=True)
            ev.record()
            self.marks.append((phase, ev))

    def read(self, replays: int) -> None:
        """Add the last replay's interval µs per phase to the process's
        counters, when ``replays`` counts one that was not read and its
        last event has completed; waits for nothing."""
        if replays <= self.read_at or len(self.marks) < 2 \
                or not self.marks[-1][1].query():
            return
        us = dict.fromkeys(trace.PHASES, 0.0)
        for (_, a), (phase, b) in zip(self.marks, self.marks[1:]):
            us[phase] += a.elapsed_time(b) * 1e3
        trace.add_phases(us, self.steps)
        self.read_at = replays


class DeviceRun:
    """One training run of the device sampler: the epoch's seeds in a
    device bank ``[steps, L, B]`` (batch ``b`` of local slot ``i`` in
    ``bank[b, i]``, a short batch padded with -1), the bank row ``idx``
    and global step ``gstep`` as device counters, and a static
    ``[n_out, K]`` buffer for a call's per-step results.

    ``step(seeds [L, B], gstep [1]) -> tensors`` takes one optimizer
    step with no host sync and returns its ``n_out`` results, the
    elements of those tensors in order; the run advances both counters
    after it. A call of K = ``steps_per_call`` > 1 steps is one replay of
    a :class:`GraphedCall` when ``capture`` (on the card, outside a gloo
    group), else K eager steps; a single step (the epoch's tail, or K =
    1) always runs eagerly. ``generators`` are the steps' own random
    generators, registered with the graph. With ``phases`` and the trace
    switch on, a graphed run keeps a :class:`PhaseClock` in
    :attr:`clock`, on which ``step`` marks its phases."""

    def __init__(self, step: Callable[[torch.Tensor, torch.Tensor],
                                      Sequence[torch.Tensor]],
                 n_out: int, bank_shape: Tuple[int, int, int],
                 dtype: torch.dtype, steps_per_call: int,
                 device: torch.device, capture: bool,
                 generators: Sequence[torch.Generator] = (),
                 phases: bool = False):
        self.step = step
        self.bank = torch.full(bank_shape, -1, dtype=dtype, device=device)
        self.idx = torch.zeros(1, dtype=torch.int64, device=device)
        self.gstep = torch.zeros(1, dtype=torch.int64, device=device)
        self.out = torch.zeros(n_out, int(steps_per_call), device=device)
        self.graphed = (GraphedCall(self._steps, device, generators)
                        if capture and steps_per_call > 1 else None)
        self.clock = (PhaseClock(steps_per_call)
                      if phases and self.graphed is not None
                      and trace.tracing() else None)
        self._staged = None

    def read_phases(self) -> None:
        """Count the last completed replay's phases (after a sync the
        loop makes; never syncs)."""
        if self.clock is not None:
            with trace.hot_span("devrun.phases"):
                self.clock.read(self.graphed.replays)

    def stage(self, id_lists: List) -> None:
        """Each local slot's permuted train ids into the bank: one
        copy."""
        with trace.hot_span("devrun.stage"):
            steps, _, B = self.bank.shape
            bank = torch.full(tuple(self.bank.shape), -1,
                              dtype=self.bank.dtype)
            for i, ids in enumerate(id_lists):
                for b in range(steps):
                    seeds = ids[b * B:(b + 1) * B]
                    bank[b, i, :len(seeds)] = torch.from_numpy(seeds)
            self.bank.copy_(bank)
            self._staged = id_lists

    def prepare(self, id_lists: List, call: List[Tuple[int, int]]
                ) -> Tuple[Tuple[int, int, int], int]:
        """``run_epochs``' ``sample`` for the device sampler: the epoch's
        ids staged at its first call, then the call ``(b, step, k)`` of
        its ``k`` ``(batch, global step)`` pairs and its seed count."""
        if self._staged is not id_lists:
            self.stage(id_lists)
        B = self.bank.shape[2]
        b, step = call[0]
        seeds = sum(len(ids[c * B:(c + 1) * B])
                    for c, _ in call for ids in id_lists)
        return (b, step, len(call)), seeds

    def _one(self) -> torch.Tensor:
        out = self.step(self.bank.index_select(0, self.idx)[0], self.gstep)
        self.idx += 1
        self.gstep += 1
        return torch.cat([v.reshape(-1) for v in out])

    def _steps(self) -> torch.Tensor:
        clock = self.clock
        if clock is not None:
            # only the capture marks: its events are the graph's nodes
            clock.armed = torch.cuda.is_current_stream_capturing()
            clock.mark(None)
        try:
            for j in range(self.out.shape[1]):
                self.out[:, j] = self._one()
                if clock is not None:
                    clock.mark("update")
        finally:
            if clock is not None:
                clock.armed = False
        return self.out

    def __call__(self, b: int, step: int, k: int) -> torch.Tensor:
        """``k`` steps from bank row ``b`` at global step ``step``; returns
        their results ``[n_out, k]`` on the device (no sync)."""
        self.idx.fill_(b)
        self.gstep.fill_(step)
        if k > 1 and self.graphed is not None:
            return self.graphed()
        with trace.hot_span("devrun.eager"):
            if k > 1:
                return self._steps().clone()
            return self._one().view(-1, 1)


def graph_stats(run: Optional[DeviceRun]) -> Dict:
    """An epoch record's graph fields: whether the run's calls replay a
    captured graph, and how many replays it took."""
    g = None if run is None else run.graphed
    return {"graph": g is not None and g.graph is not None,
            "graph_replays": 0 if g is None else g.replays}
