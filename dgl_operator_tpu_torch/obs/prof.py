"""Hardware-utilization telemetry: per-step MFU and roofline accounting,
compile telemetry, memory watermarks and a regression gate — the
port's counterpart of the JAX package's ``obs/prof.py``, with torch in
place of XLA.

- **Peaks** (:func:`resolve_peaks`): the roofline denominators, from
  the ``prof`` knob layer (``peak_flops`` / ``peak_hbm_gbps``), the
  environment, a tuned manifest, or the peak table of the card
  (``obs/peaks.py``, typed from the H100 SXM5 data sheet; the FLOP
  peak is the one of the trainer's compute: float32 on the CUDA cores,
  TF32 or BF16 on the tensor cores). On the CPU a core-count model.
- **Step cost** (:class:`StepCost`): one eager call of a training
  program under ``torch.utils.flop_counter.FlopCounterMode`` (the
  matrix products' FLOPs) beside a dispatch mode that sums every aten
  op's input and output bytes. The port's three kernels are ctypes
  libraries, so neither mode sees them: each wrapper reports its
  launch's work (:func:`note_kernel`). A K-step call costs K eager
  steps; a call that captures a CUDA graph is counted in the graph's
  eager warm-up and never inside the capture (:func:`suspended`).
  :func:`analytic_train_cost` is the fallback when the count fails,
  and :meth:`StepProfiler.cost_source` says which one a run used.
- **Compile telemetry** (:func:`instrument_call`, :func:`note_capture`,
  :func:`record_compile`): the port's compiles are CUDA-graph captures
  and kernel builds at first use. Each adds to
  ``jit_compiles_total{fn}`` and ``jit_compile_seconds`` and emits a
  ``jit_compile`` event; ``steady`` marks a capture after the
  program's warm-up calls (shape churn, a critical finding of
  ``obs/analyze.py``).
- **Watermarks** (:func:`device_watermarks_mib`): the allocator's peak
  per CUDA device (``torch.cuda.max_memory_allocated``, no sync).
- **The profiler** (:class:`StepProfiler`): the heartbeat turns each
  window's work into ``train_mfu`` and
  ``train_roofline_frac{bound=compute|memory|comm}`` gauges and Chrome
  counter tracks.
- **Regression gate**: :func:`prof_summary` reads the pinned keys
  (``benchkeys.PROF_KEYS``) of a run and :func:`diff_summaries` compares
  two; the CLI is ``python -m dgl_operator_tpu_torch.obs.prof
  [report] <obs-dir>`` and ``... diff <run> <baseline>`` (rc 1 on a
  regression, 2 on a usage error).

torch is imported inside the functions that need it, so the CLI reads a
run's files without touching a device.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from dgl_operator_tpu_torch.benchkeys import PROF_KEYS
from dgl_operator_tpu_torch.obs.peaks import H100_PEAKS

PEAK_FLOPS_ENV = "TPU_OPERATOR_PEAK_FLOPS"
PEAK_HBM_ENV = "TPU_OPERATOR_PEAK_HBM_GBPS"

# calls a training program may legitimately capture on before the
# capture counts as steady-state (call 0 captures a K-step graph; call
# 1 covers a second legitimate shape)
DEFAULT_WARMUP_CALLS = 2
# measured-vs-predicted HBM drift tolerance (the analytics finding)
DEFAULT_HBM_DRIFT_FRAC = 0.20
# default adoption margin of the regression gate
DEFAULT_DIFF_MARGIN = 0.15

# peak tables by card (obs/peaks.py), matched by substring of the
# device name
_DEVICE_PEAKS = (("h100", H100_PEAKS),)
COMPUTE_KINDS = ("fp32", "tf32", "bf16")
# CPU model: per-core peak (8-wide FMA at ~2 GHz) and a socket-ish
# memory bandwidth; round numbers, a test surface, not a headline
_CPU_FLOPS_PER_CORE = 32e9
_CPU_HBM_GBPS = 25.0
# aten ops that move no memory of their own
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_to_copy_meta")


@dataclasses.dataclass
class ProfConfig:
    """The prof knob layer (``autotune/knobs.py``, ``layer="prof"``):
    roofline peaks in FLOP/s and GB/s; 0 resolves them
    (:func:`resolve_peaks`)."""

    peak_flops: float = 0.0
    peak_hbm_gbps: float = 0.0


def compute_kind(compute_dtype: Optional[str] = None) -> str:
    """The FLOP peak a trainer's products run against: ``"bf16"`` under
    ``compute_dtype="bfloat16"``, ``"tf32"`` where PyTorch lets float32
    matrix products use TF32, else ``"fp32"``."""
    if compute_dtype == "bfloat16":
        return "bf16"
    import torch
    return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "fp32"


def resolve_peaks(cfg: Optional[ProfConfig] = None, device=None,
                  compute: str = "fp32") -> Dict:
    """The roofline denominators, in priority order: explicit config >
    ``TPU_OPERATOR_PEAK_*`` environment > tuned manifest (through
    ``apply_tuned`` on the default config) > the peak table of
    ``device``'s card for ``compute`` (:func:`compute_kind`). Every
    value passes the knob registry's validation."""
    from dgl_operator_tpu_torch.autotune.knobs import apply_tuned, validate
    cfg = apply_tuned(cfg or ProfConfig(), layer="prof")
    flops = validate("peak_flops", cfg.peak_flops)
    gbps = validate("peak_hbm_gbps", cfg.peak_hbm_gbps)
    if flops and gbps:
        return {"peak_flops": flops, "peak_hbm_gbps": gbps,
                "source": "config"}
    env_f = os.environ.get(PEAK_FLOPS_ENV)
    env_b = os.environ.get(PEAK_HBM_ENV)
    if env_f:
        flops = flops or validate("peak_flops", float(env_f))
    if env_b:
        gbps = gbps or validate("peak_hbm_gbps", float(env_b))
    if flops and gbps:
        return {"peak_flops": flops, "peak_hbm_gbps": gbps,
                "source": "env"}
    auto = _detect_peaks(device, compute)
    return {"peak_flops": flops or auto[0],
            "peak_hbm_gbps": gbps or auto[1], "source": auto[2]}


def _detect_peaks(device=None, compute: str = "fp32"
                  ) -> Tuple[float, float, str]:
    """The card's table entry (the first table's for a CUDA card the
    table does not name), or the CPU core-count model for a CPU
    device."""
    if compute not in COMPUTE_KINDS:
        raise ValueError(f"compute must be one of {COMPUTE_KINDS}, not "
                         f"{compute!r}")
    import torch
    dev = torch.device(device) if device is not None else None
    if dev is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev is not None and dev.type == "cuda":
        name = torch.cuda.get_device_name(dev).lower()
        for tag, peaks in _DEVICE_PEAKS:
            if tag in name:
                return peaks[compute], peaks["hbm_gbps"], \
                    f"auto:{tag}-{compute}"
        tag, peaks = _DEVICE_PEAKS[0]
        return peaks[compute], peaks["hbm_gbps"], f"auto:cuda-{compute}"
    cores = os.cpu_count() or 1
    return cores * _CPU_FLOPS_PER_CORE, _CPU_HBM_GBPS, "auto:cpu"


# ------------------------------------------------------- cost models
_cost_lock = threading.Lock()
# the StepCost counting now (process-wide: a backward on the card runs
# on autograd's own thread) and whether counting is suspended
_active: Optional["StepCost"] = None
_suspended = 0


def note_kernel(flops: float, nbytes: float) -> None:
    """A kernel wrapper's report of one launch's work to the active
    :class:`StepCost` (a no-op when none counts)."""
    cost = _active
    if cost is not None and not _suspended:
        with _cost_lock:
            cost.kernel_flops += float(flops)
            cost.kernel_bytes += float(nbytes)


@contextlib.contextmanager
def suspended() -> Iterator[None]:
    """Count nothing inside the block: the dispatch modes are taken off,
    the kernel wrappers' reports dropped and the comm seams' registration
    paused (a CUDA-graph capture runs here, so it is never counted and
    runs as without profiling)."""
    global _suspended
    from torch.utils._python_dispatch import _disable_current_modes

    from dgl_operator_tpu_torch.obs.comm import registration_paused
    with _cost_lock:
        _suspended += 1
    try:
        with registration_paused():
            if _active is None:
                yield
            else:
                with _disable_current_modes():
                    yield
    finally:
        with _cost_lock:
            _suspended -= 1


def _bytes_mode_cls():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class _BytesMode(TorchDispatchMode):
        """Sums the bytes of every tensor an aten op reads and writes
        (views and allocations move nothing and are skipped)."""

        def __init__(self):
            super().__init__()
            self.nbytes = 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if not (getattr(func, "is_view", False) or name in _NO_TRAFFIC):
                leaves, _ = tree_flatten((args, kwargs, out))
                self.nbytes += sum(t.numel() * t.element_size()
                                   for t in leaves
                                   if isinstance(t, torch.Tensor))
            return out

    return _BytesMode


class StepCost:
    """Counts the work done inside the block: ``flops`` (the matrix
    products FlopCounterMode knows, plus the kernels' reports) and
    ``nbytes`` (every aten op's input and output bytes, plus the
    kernels' reports). One counter at a time; a nested one raises."""

    def __init__(self):
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.flops = 0.0
        self.nbytes = 0.0
        self._stack: Optional[contextlib.ExitStack] = None

    def __enter__(self) -> "StepCost":
        global _active
        from torch.utils.flop_counter import FlopCounterMode
        with _cost_lock:
            if _active is not None:
                raise RuntimeError("a StepCost is already counting")
            _active = self
        self._fc = FlopCounterMode(display=False)
        self._bm = _bytes_mode_cls()()
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self._fc)
        self._stack.enter_context(self._bm)
        return self

    def __exit__(self, *exc) -> None:
        global _active
        try:
            self._stack.close()
        finally:
            with _cost_lock:
                _active = None
        self.flops = float(self._fc.get_total_flops()) + self.kernel_flops
        self.nbytes = float(self._bm.nbytes) + self.kernel_bytes


def analytic_train_cost(param_count: int, input_rows: int,
                        feat_dim: int, edge_count: int) -> Dict:
    """Coarse per-optimizer-step cost model for a sampled GNN train
    step, the fallback when the count fails: dense work ~ every
    parameter applied per input row, message work ~ one multiply-add
    per edge feature element, and fwd+bwd+update ~ 3x the forward.
    Bytes ~ one read+write of the activations plus two passes over the
    parameters. It bills every parameter against every input row, so
    on a sampled SAGE step it reads far above the work done: a run
    scored with it says so in its cost source."""
    fwd = 2.0 * float(param_count) * max(input_rows, 1) \
        + 2.0 * float(edge_count) * max(feat_dim, 1)
    act_bytes = 4.0 * max(input_rows, 1) * max(feat_dim, 1)
    nbytes = 3.0 * (2.0 * act_bytes + 2.0 * 4.0 * float(param_count))
    return {"flops": 3.0 * fwd, "bytes": nbytes, "source": "analytic"}


def dist_hbm_bill_mib(feat_bytes: int, label_bytes: int, num_slots: int,
                      params_mib: float, opt_state_mib: float,
                      csr_bytes: int = 0, staging_bytes: int = 0,
                      edges: int = 0, rows: int = 0, feat_dim: int = 0,
                      prefetch: int = 0) -> float:
    """The partition-parallel trainer's analytic per-slot memory bill
    (``train_hbm_predicted_mib``), the JAX ``DistTrainer``'s term for
    term: one slot's share of the feature and label stores
    (``feat_bytes`` and ``label_bytes`` over ``num_slots``), the
    parameters and optimizer state, one slot's share of the device
    sampler's CSR, the exchange pipeline's staged receive buffers, and
    up to ``prefetch + 2`` staged minibatches of ``edges`` neighbour
    slots and ``rows`` input rows."""
    mib = 1.0 / 2**20
    predicted = (feat_bytes / num_slots + label_bytes / num_slots) * mib
    predicted += params_mib + opt_state_mib
    predicted += csr_bytes / num_slots * mib
    predicted += staging_bytes * mib
    predicted += (prefetch + 2) * (edges * 8 + rows * feat_dim * 4) * mib
    return predicted


def gather_staging_mib(leaf_bytes, gather_depth: int) -> float:
    """ZeRO-3 transient-HBM term of the analytic per-slot bill: the
    ``gather_depth`` largest FULL parameter leaves in flight on top of
    the persistent shards. ``leaf_bytes`` is the per-leaf gathered byte
    sizes; returns MiB."""
    depth = max(int(gather_depth), 1)
    top = sorted((float(b) for b in leaf_bytes), reverse=True)[:depth]
    return sum(top) / 2.0**20


# --------------------------------------------- compile instrumentation
_tls = threading.local()


def record_compile(fn: str, call_idx: int, seconds: float,
                   steady: bool, **fields) -> None:
    """One compile of ``fn``: ``jit_compiles_total{fn}``,
    ``jit_compile_seconds`` and a ``jit_compile`` event."""
    from dgl_operator_tpu_torch.obs import get_obs
    obs = get_obs()
    obs.metrics.counter(
        "jit_compiles_total",
        "compiles per instrumented program (CUDA-graph captures, kernel "
        "builds at first use)", labels=("fn",)).inc(fn=fn)
    obs.metrics.histogram(
        "jit_compile_seconds",
        "wall-clock of calls that triggered a compile (compile + first "
        "run)").observe(seconds)
    obs.emit("jit_compile", fn=fn, call=int(call_idx),
             seconds=round(seconds, 4), steady=bool(steady), **fields)


def note_capture(seconds: float) -> None:
    """A CUDA-graph capture (``runtime/graphs.py::GraphedCall``): a
    compile of the instrumented program being called on this thread,
    at its call index, or of ``cuda_graph`` outside one."""
    cur = getattr(_tls, "call", None)
    if cur is None:
        record_compile("cuda_graph", 0, seconds, False)
        return
    wrapper, prog, call_idx = cur
    wrapper.compiles += 1
    record_compile(prog, call_idx, seconds,
                   wrapper.warmup_calls is not None
                   and call_idx >= wrapper.warmup_calls)


class _InstrumentedCall:
    """A trainer's call of K steps, instrumented: counts calls per
    program (``name`` for one step, ``multi_name`` for K > 1, K read
    by ``steps(batch)``), opens the comm ledger's call scope of the
    program around the call, counts each program's cost on its first call
    (:class:`StepCost`) and reports calls to the profiler. A capture
    inside a call is a compile of that call's program
    (:func:`note_capture`)."""

    def __init__(self, name: str, fn: Callable, role: Optional[str],
                 warmup_calls: Optional[int], multi_name: Optional[str],
                 steps: Optional[Callable]):
        self._inner = fn
        self.name = name
        self.multi_name = multi_name or name
        self.role = role
        self.warmup_calls = warmup_calls
        self._steps = steps
        self.calls: Dict[str, int] = {}
        self.compiles = 0
        self.last_program: Optional[str] = None
        self._costed: set = set()

    def __call__(self, batch):
        k = self._steps(batch) if self._steps is not None else 1
        prog = self.multi_name if k > 1 else self.name
        call_idx = self.calls.get(prog, 0)
        self.calls[prog] = call_idx + 1
        from dgl_operator_tpu_torch.obs import comm as _comm
        self.last_program = prog
        prev_call = getattr(_tls, "call", None)
        _tls.call = (self, prog, call_idx)
        try:
            with _comm.call_scope(prog):
                if (self.role in ("step", "exchange")
                        and prog not in self._costed and _active is None):
                    self._costed.add(prog)
                    with StepCost() as cost:
                        out = self._inner(batch)
                    if cost.flops > 0:
                        get_profiler().set_program_cost(
                            prog, self.role, cost.flops, cost.nbytes,
                            source="flop_counter")
                else:
                    out = self._inner(batch)
        finally:
            _tls.call = prev_call
        if self.role in ("step", "exchange"):
            get_profiler().note_call(prog)
        return out


def instrument_call(name: str, fn: Callable, role: Optional[str] = "step",
                    warmup_calls: Optional[int] = DEFAULT_WARMUP_CALLS,
                    multi_name: Optional[str] = None,
                    steps: Optional[Callable] = None) -> _InstrumentedCall:
    """Wrap a trainer's call with compile and cost telemetry
    (``role="step"``: its cost feeds the MFU; ``role=None`` counts
    compiles only)."""
    return _InstrumentedCall(name, fn, role, warmup_calls, multi_name,
                             steps)


# --------------------------------------------------------- watermarks
def device_watermarks_mib() -> Dict[str, float]:
    """The allocator's peak MiB per CUDA device this process has used
    (``torch.cuda.max_memory_allocated``, which synchronizes nothing);
    {} without CUDA or before the process touched a card."""
    try:
        import torch
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return {}
        out: Dict[str, float] = {}
        for i in range(torch.cuda.device_count()):
            peak = torch.cuda.max_memory_allocated(i)
            if peak:
                out[f"cuda:{i}"] = round(float(peak) / 2**20, 3)
        return out
    except Exception:  # noqa: BLE001 — telemetry never raises
        return {}


# ----------------------------------------------------- the profiler
class StepProfiler:
    """Per-process MFU/roofline accounting, fed by the trainers'
    heartbeat. Programs report per-call cost and call counts through
    :func:`instrument_call`; :meth:`on_heartbeat` turns the window's
    deltas into ``train_mfu`` / ``train_roofline_frac{bound}`` gauges,
    samples the memory watermark, and emits the Chrome counter tracks.
    Disabled (a cheap no-op) until :meth:`configure` runs."""

    def __init__(self, clock: Callable[[], float] = time.time,
                 window_s: float = 5.0, maxlen: int = 512):
        self._lock = threading.Lock()
        self._clock = clock
        self.window_s = float(window_s)
        self._maxlen = maxlen
        self.enabled = False
        self.peaks: Dict = {}
        self.fallback_cost: Optional[Dict] = None
        self.predicted_hbm_mib: Optional[float] = None
        # name -> {"role", "flops", "bytes", "calls", "source"}
        self._programs: Dict[str, Dict] = {}
        # (ts, step, flops_done, bytes_done, comm_done, CUDA event or
        # None) snapshots
        self._ticks: List[tuple] = []
        self._wm_ts = 0.0
        self.watermark_mib: Dict[str, float] = {}
        self.last: Dict = {}
        self.flops_scale = 1.0
        self._device = None

    # -- configuration (trainers) -------------------------------------
    def configure(self, peaks: Optional[Dict] = None,
                  fallback_cost: Optional[Dict] = None,
                  predicted_hbm_mib: Optional[float] = None,
                  flops_scale: float = 1.0, device=None) -> None:
        """Start a run's accounting (an earlier run's ticks are dropped,
        so no window spans two runs). ``flops_scale`` multiplies every
        program's per-call cost (1 in the port: a call's count already
        covers every slot of the process). With a CUDA ``device`` each
        tick records an event on the current stream and the windows are
        the card's time between completed ticks, not the host's: a
        replayed graph returns before the card finishes."""
        import torch
        with self._lock:
            self._ticks.clear()
            self._device = (torch.device(device) if device is not None
                            and torch.device(device).type == "cuda"
                            else None)
            self.peaks = peaks or resolve_peaks()
            if fallback_cost is not None:
                self.fallback_cost = fallback_cost
            if predicted_hbm_mib is not None:
                self.predicted_hbm_mib = float(predicted_hbm_mib)
            self.flops_scale = float(flops_scale)
            self.enabled = True
        from dgl_operator_tpu_torch.obs import get_obs
        m = get_obs().metrics
        m.gauge("prof_peak_flops",
                "roofline peak FLOP/s this run was scored against"
                ).set(self.peaks["peak_flops"])
        m.gauge("prof_peak_hbm_gbps",
                "roofline peak HBM GB/s this run was scored against"
                ).set(self.peaks["peak_hbm_gbps"])
        if self.predicted_hbm_mib is not None:
            m.gauge("train_hbm_predicted_mib",
                    "analytic per-device HBM bill of the active config"
                    ).set(self.predicted_hbm_mib)

    def set_program_cost(self, name: str, role: str, flops: float,
                         nbytes: float, source: str = "flop_counter"
                         ) -> None:
        with self._lock:
            prog = self._programs.setdefault(
                name, {"role": role, "calls": 0})
            prog.update(flops=float(flops), bytes=float(nbytes),
                        source=source)

    def note_call(self, name: str) -> None:
        with self._lock:
            prog = self._programs.setdefault(
                name, {"role": "step", "calls": 0})
            prog["calls"] += 1

    # -- accounting ----------------------------------------------------
    def _totals(self) -> Tuple[float, float, float]:
        """(flops, hbm bytes, comm bytes) completed so far, from the
        instrumented programs' call counts x per-call costs. A step
        program without a counted cost uses the analytic fallback."""
        fb = self.fallback_cost or {}
        flops = hbm = comm = 0.0
        for prog in self._programs.values():
            calls = prog["calls"]
            if not calls:
                continue
            f = prog.get("flops", fb.get("flops") if
                         prog["role"] == "step" else None)
            b = prog.get("bytes", fb.get("bytes") if
                         prog["role"] == "step" else None)
            if prog["role"] == "exchange":
                comm += calls * (b or 0.0)
            else:
                flops += calls * (f or 0.0)
                hbm += calls * (b or 0.0)
        k = self.flops_scale
        return flops * k, hbm * k, comm * k

    def cost_source(self) -> Optional[str]:
        with self._lock:
            for prog in self._programs.values():
                if prog["role"] == "step" and "flops" in prog:
                    return prog.get("source", "flop_counter")
            return "analytic" if self.fallback_cost else None

    def on_heartbeat(self, step: int) -> Optional[Dict]:
        """One profiler tick per trainer heartbeat: append the totals
        snapshot, derive the rolling-window MFU/roofline, refresh the
        watermark (rate-limited), set the gauges and counter tracks.
        Returns ``{"mfu", "hbm_mib", ...}`` for the live feed, or None
        while unconfigured or before the window has two edges."""
        if not self.enabled:
            return None
        now = self._clock()
        ev = None
        if self._device is not None:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self._device))
        with self._lock:
            flops, hbm, comm = self._totals()
            self._ticks.append((now, int(step), flops, hbm, comm, ev))
            if len(self._ticks) > self._maxlen:
                del self._ticks[: len(self._ticks) - self._maxlen]
        return self._evaluate(now)

    def refresh(self) -> Optional[Dict]:
        """Derive the gauges again from the ticks so far, adding none:
        at an epoch's end, after its sync, every tick's event is
        complete, so the last window reaches the last call."""
        if not self.enabled:
            return None
        return self._evaluate(self._clock())

    def _evaluate(self, now: float) -> Optional[Dict]:
        with self._lock:
            ticks = self._ticks
            if self._device is not None:
                # one stream: every tick before a completed one is
                # complete; query() waits for nothing
                done = len(ticks)
                while done and not ticks[done - 1][5].query():
                    done -= 1
                ticks = ticks[:done]
            window = ticks[bisect.bisect_left(
                ticks, now - self.window_s, key=lambda t: t[0]):]
            if len(window) < 2:
                window = ticks[-2:]
            peaks = dict(self.peaks)
            predicted = self.predicted_hbm_mib
        self._sample_watermark(now)
        if len(window) < 2:
            return None
        t0, s0, f0, b0, c0, e0 = window[0]
        t1, s1, f1, b1, c1, e1 = window[-1]
        dt = t1 - t0 if e0 is None else e0.elapsed_time(e1) / 1e3
        if dt <= 0 or s1 <= s0:
            return None
        compute = (f1 - f0) / dt / max(peaks["peak_flops"], 1.0)
        peak_bw = max(peaks["peak_hbm_gbps"], 1e-9) * 1e9
        memory = (b1 - b0) / dt / peak_bw
        comm_frac = (c1 - c0) / dt / peak_bw
        fracs = {"compute": compute, "memory": memory,
                 "comm": comm_frac}
        bound = max(fracs, key=fracs.get)
        wm = max(self.watermark_mib.values(), default=0.0)
        out = {"mfu": round(compute, 6), "bound": bound,
               "fracs": fracs, "hbm_mib": round(wm, 3),
               "step_rate_hz": round((s1 - s0) / dt, 4)}
        self.last = out
        self._emit(out, predicted)
        return out

    def _sample_watermark(self, now: float,
                          min_period_s: float = 0.25) -> None:
        if now - self._wm_ts < min_period_s and self.watermark_mib:
            return
        self._wm_ts = now
        for dev, mib in device_watermarks_mib().items():
            if mib > self.watermark_mib.get(dev, 0.0):
                self.watermark_mib[dev] = mib

    def _emit(self, out: Dict, predicted: Optional[float]) -> None:
        from dgl_operator_tpu_torch.obs import get_obs
        obs = get_obs()
        m = obs.metrics
        m.gauge("train_mfu",
                "model-FLOPs utilization of the rolling heartbeat "
                "window (achieved FLOP/s over peak_flops)"
                ).set(out["mfu"])
        g = m.gauge("train_roofline_frac",
                    "fraction of the per-resource peak achieved in the "
                    "window; the max label is the binding resource",
                    labels=("bound",))
        for k, v in out["fracs"].items():
            g.set(round(v, 6), bound=k)
        wm = m.gauge("train_hbm_watermark_mib",
                     "per-device live-buffer high-water MiB",
                     labels=("device",))
        for dev, mib in self.watermark_mib.items():
            wm.set(mib, device=dev)
        if obs.directory:
            # Chrome counter tracks: utilization under the span tree
            obs.tracer.counter("MFU", {"mfu": round(out["mfu"], 6)})
            track = {"watermark": out["hbm_mib"]}
            if predicted is not None:
                track["predicted"] = round(predicted, 3)
            obs.tracer.counter("HBM MiB", track)


_profiler: Optional[StepProfiler] = None
_profiler_lock = threading.Lock()


def get_profiler() -> StepProfiler:
    """The process-global profiler (trainers configure it; the shared
    heartbeat ticks it)."""
    global _profiler
    with _profiler_lock:
        if _profiler is None:
            _profiler = StepProfiler()
        return _profiler


def reset_profiler() -> None:
    """A fresh profiler (tests; a driver starting a second run)."""
    global _profiler
    with _profiler_lock:
        _profiler = None


# ------------------------------------------------- summaries + diff
def _merged_metrics(obs_dir: str) -> Dict:
    from dgl_operator_tpu_torch.obs._io import read_json
    from dgl_operator_tpu_torch.obs.collect import METRICS_JSON, job_dir_of
    for d in (job_dir_of(obs_dir), obs_dir):
        data = read_json(os.path.join(d, METRICS_JSON), {})
        if data.get("merged") or data.get("procs"):
            merged = data.get("merged")
            if merged:
                return merged
            from dgl_operator_tpu_torch.obs.metrics import merge_snapshots
            procs = data.get("procs") or {}
            return merge_snapshots(procs[p] for p in sorted(procs))
    return {}


def _gauge_value(merged: Dict, name: str, **labels) -> Optional[float]:
    fam = merged.get(name) or {}
    best = None
    for s in fam.get("samples", []):
        if labels and any(s.get("labels", {}).get(k) != v
                          for k, v in labels.items()):
            continue
        best = float(s["value"]) if best is None \
            else max(best, float(s["value"]))
    return best


def _counter_total(merged: Dict, name: str) -> float:
    fam = merged.get(name) or {}
    return float(sum(s.get("value", 0)
                     for s in fam.get("samples", [])))


def prof_summary(obs_dir: str) -> Optional[Dict]:
    """The pinned prof keys (``benchkeys.PROF_KEYS``) of a finished or
    running obs dir, read from the job view's merged metrics (a plain
    obs dir merges its own procs). None when the run carried no
    utilization telemetry."""
    merged = _merged_metrics(obs_dir)
    mfu = _gauge_value(merged, "train_mfu")
    if mfu is None:
        return None
    fracs = {}
    for s in (merged.get("train_roofline_frac") or {}).get(
            "samples", []):
        fracs[s.get("labels", {}).get("bound", "?")] = float(s["value"])
    bound = max(fracs, key=fracs.get) if fracs else None
    out = {
        "train_mfu": mfu,
        "roofline_bound": bound,
        "roofline_frac": (fracs.get(bound) if bound else None),
        "train_seeds_per_sec": _gauge_value(merged,
                                            "train_seeds_per_sec"),
        "hbm_watermark_mib": _gauge_value(merged,
                                          "train_hbm_watermark_mib"),
        "hbm_predicted_mib": _gauge_value(merged,
                                          "train_hbm_predicted_mib"),
        "jit_compiles": int(_counter_total(merged,
                                           "jit_compiles_total")),
    }
    assert tuple(out) == PROF_KEYS, (tuple(out), PROF_KEYS)
    out["peak_flops"] = _gauge_value(merged, "prof_peak_flops")
    out["peak_hbm_gbps"] = _gauge_value(merged, "prof_peak_hbm_gbps")
    return out


# the keys the regression gate compares (higher is better); the rest
# of PROF_KEYS ride along for the report
GATED_KEYS = ("train_mfu", "train_seeds_per_sec")


def diff_summaries(run: Dict, baseline: Dict,
                   margin: float = DEFAULT_DIFF_MARGIN) -> Dict:
    """Compare a run's prof summary against a baseline under an
    adoption margin: a gated key regresses when the run falls below
    ``baseline * (1 - margin)``, or when the baseline has it and the
    run lost it. Returns ``{"ok", "margin", "regressions",
    "compared"}``."""
    regressions: List[Dict] = []
    compared: Dict[str, Dict] = {}
    for key in GATED_KEYS:
        base = baseline.get(key)
        cur = run.get(key)
        if base is None or base <= 0:
            continue
        floor = base * (1.0 - margin)
        entry = {"run": cur, "baseline": base,
                 "floor": round(floor, 6)}
        compared[key] = entry
        if cur is None or cur < floor:
            regressions.append({"key": key, **entry})
    return {"ok": not regressions, "margin": margin,
            "regressions": regressions, "compared": compared}


def _load_summary(path: str) -> Dict:
    """A diff operand: an obs directory, a raw summary JSON, or a
    record holding one under ``"prof"``."""
    if os.path.isdir(path):
        summary = prof_summary(path)
        if summary is None:
            raise ValueError(f"{path}: no prof telemetry in the obs "
                             "view (did the run emit train_mfu?)")
        return summary
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict) and isinstance(data.get("prof"), dict):
        return data["prof"]
    if isinstance(data, dict):
        return data
    raise ValueError(f"{path}: not a prof summary")


def render_summary(summary: Dict) -> str:
    lines = ["tpu-prof"]
    lines.append(f"  MFU        : {summary['train_mfu']:.4f}"
                 + (f"  (peak {summary['peak_flops']:.3g} FLOP/s)"
                    if summary.get("peak_flops") else ""))
    if summary.get("roofline_bound"):
        lines.append(f"  roofline   : {summary['roofline_bound']}-bound"
                     f" at {summary['roofline_frac']:.4f} of peak")
    if summary.get("train_seeds_per_sec") is not None:
        lines.append(f"  throughput : "
                     f"{summary['train_seeds_per_sec']:.1f} seeds/s")
    if summary.get("hbm_watermark_mib") is not None:
        line = f"  HBM        : {summary['hbm_watermark_mib']:.1f} MiB" \
            " watermark"
        if summary.get("hbm_predicted_mib") is not None:
            line += f" vs {summary['hbm_predicted_mib']:.1f} predicted"
        lines.append(line)
    lines.append(f"  compiles   : {summary.get('jit_compiles', 0)}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-prof",
        description="Hardware-utilization introspection: render a "
                    "run's MFU/roofline/HBM summary, or diff two runs "
                    "as a perf-regression gate.")
    sub = ap.add_subparsers(dest="cmd")
    rep = sub.add_parser("report", help="render a run's prof summary")
    rep.add_argument("obs_dir")
    rep.add_argument("--json", action="store_true")
    dif = sub.add_parser(
        "diff", help="compare a run against a baseline (rc 1 when a "
                     "gated key regresses past the margin)")
    dif.add_argument("run", help="obs dir or summary JSON")
    dif.add_argument("baseline", help="same forms as the run operand")
    dif.add_argument("--margin", type=float,
                     default=DEFAULT_DIFF_MARGIN,
                     help="adoption margin (fraction below baseline "
                          "that still passes)")
    # a bare `<obs-dir>` reads as a report
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] not in ("report", "diff", "-h", "--help"):
        argv = ["report", *argv]
    args = ap.parse_args(argv)
    if args.cmd is None:
        ap.print_help()
        return 2
    try:
        if args.cmd == "report":
            summary = _load_summary(args.obs_dir)
            print(json.dumps(summary, indent=2, sort_keys=True)
                  if args.json else render_summary(summary))
            return 0
        run = _load_summary(args.run)
        baseline = _load_summary(args.baseline)
    except (OSError, ValueError) as exc:
        print(f"tpu-prof: {exc}", file=sys.stderr)
        return 2
    result = diff_summaries(run, baseline, margin=args.margin)
    print(json.dumps(result, indent=2, sort_keys=True))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
