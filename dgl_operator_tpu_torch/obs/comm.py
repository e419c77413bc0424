"""Communication telemetry: the per-collective ledger, the link
roofline, and the one in-flight watcher — the port's counterpart of the
JAX package's ``obs/comm.py``.

- **Ledger** (:class:`CommLedger`): each collective seam —
  ``halo_a2a_serve`` / ``halo_a2a_request`` (``parallel/halo.py``), the
  device sampler's ``halo_ring`` (``runtime/dist.py::owner_rows``), the
  gradient mean ``grad_pmean`` (``parallel/dp.py``) and the KGE
  ``emb_lookup`` / ``emb_push`` (``parallel/embedding.py``) — calls
  :func:`register_collective` each time it runs, with its op kind,
  slot axis and bytes from the port's byte models. Records are keyed by
  ``(program, op, axis)``, so each call overwrites its own record, as a
  JAX retrace does. The program is :func:`current_program`, bound by
  ``prof.instrument_call`` around each trainer call. The port runs
  every slot of a process in one call, so a record's bytes are the
  process's, every local slot's; inside a captured K-step graph no host
  code runs between collectives, so one window covers a whole replay.
- **Link roofline** (:func:`resolve_link_peaks`): the ``comm`` knob
  layer (``peak_ici_gbps`` / ``peak_dcn_gbps``), then the environment
  (``TPU_OPERATOR_PEAK_ICI_GBPS`` / ``TPU_OPERATOR_PEAK_DCN_GBPS``),
  then the card's table. ``ici`` is the link inside a host — NVLink on
  an H100 host — and ``dcn`` the network between hosts, which no table
  names: its auto-detected peak is 0 and it gets no utilization gauge.
- **Watcher** (:class:`CommWatcher`): one thread (``tpu-commwatch``)
  closes each submitted window in submission order. It only waits on
  what the window names — a ``torch.cuda.Event`` recorded on the stream
  the work ran on (``Event.synchronize``) — and launches nothing; a
  window with nothing to wait on (the CPU, a gloo request already
  finished) closes where it was submitted. Each closed window feeds the
  spans (cat=comm), ``comm_bytes_total{op,axis}`` /
  ``comm_seconds{op,axis}``, the ``comm_link_gbps`` /
  ``comm_link_util`` gauges, the trainers' ``OverlapTracker`` and the
  flight recorder's start/done samples (a crash names the collective
  in flight).

Standard library only at import; torch is imported in the watcher.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from dgl_operator_tpu_torch.benchkeys import COMM_KEYS
from dgl_operator_tpu_torch.obs.peaks import H100_NVLINK_GBPS

PEAK_ICI_ENV = "TPU_OPERATOR_PEAK_ICI_GBPS"
PEAK_DCN_ENV = "TPU_OPERATOR_PEAK_DCN_GBPS"

WATCH_THREAD_PREFIX = "tpu-commwatch"

# Link peaks (GB/s) by card, matched by substring of the device name:
# ``ici`` is the intra-host NVLink (obs/peaks.py: the data sheet's
# bidirectional figure counted in ONE direction, since a collective's
# bytes are what each GPU sends); ``dcn``, the inter-host network, is
# named by no table (0: no utilization gauge) unless the comm knobs or
# the environment name one.
_LINK_PEAKS = (
    ("h100", H100_NVLINK_GBPS, 0.0),
)
# CPU: loopback "links", so the utilization gauges stay meaningful on
# the CPU slots the tests run
_CPU_ICI_GBPS = 10.0
_CPU_DCN_GBPS = 1.0


# ------------------------------------------------------------------
# program attribution
# ------------------------------------------------------------------
_tls = threading.local()


def current_program() -> str:
    """The program being called on this thread, or ``"untraced"`` for
    seams run outside an instrumented call."""
    return getattr(_tls, "program", None) or "untraced"


@contextlib.contextmanager
def call_scope(program: str) -> Iterator[None]:
    """One call of ``program`` (``prof.instrument_call`` opens it): the
    seams' registrations inside it are summed per ``(op, axis)`` and
    committed to the ledger at its end, overwriting the program's
    previous records, so a call of K steps bills K steps' bytes."""
    prev = (getattr(_tls, "program", None), getattr(_tls, "acc", None))
    _tls.program, _tls.acc = program, {}
    try:
        yield
    finally:
        acc = _tls.acc
        _tls.program, _tls.acc = prev
        for rec in acc.values():
            get_ledger().register(rec)


@contextlib.contextmanager
def registration_paused() -> Iterator[None]:
    """Register nothing inside the block (a CUDA-graph capture: its
    steps were already billed by the eager warm-up before it)."""
    _tls.paused = getattr(_tls, "paused", 0) + 1
    try:
        yield
    finally:
        _tls.paused -= 1


# ------------------------------------------------------------------
# the ledger
# ------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CommOp:
    """One collective seam inside one program: what moves, where."""

    op: str               # op kind, e.g. "halo_a2a_serve", "grad_pmean"
    axis: str             # mesh axis the collective rides
    bytes_per_call: int   # analytic bytes per program call
    program: str          # owning instrumented program
    fused_depth: int = 1  # pipelined depth


class CommLedger:
    """Registry of every collective a program contains. Keyed by
    ``(program, op, axis)``: a later call of the same program overwrites
    its own records, so bytes never double-count."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ops: Dict[Tuple[str, str, str], CommOp] = {}

    def register(self, rec: CommOp) -> None:
        with self._lock:
            self._ops[(rec.program, rec.op, rec.axis)] = rec

    def ops_of(self, program: str) -> List[CommOp]:
        """Every collective registered under one program, largest
        first (the watcher attributes skew to the dominant one)."""
        with self._lock:
            recs = [o for o in self._ops.values()
                    if o.program == program]
        return sorted(recs, key=lambda o: -o.bytes_per_call)


_ledger: Optional[CommLedger] = None
_ledger_lock = threading.Lock()


def get_ledger() -> CommLedger:
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = CommLedger()
        return _ledger


def reset_ledger() -> None:
    global _ledger
    with _ledger_lock:
        _ledger = None


def register_collective(op: str, axis: str, nbytes,
                        fused_depth: int = 1) -> None:
    """Record one collective seam each time it runs: emits nothing, one
    locked ledger write (or, inside a :func:`call_scope`, one add into
    the call's sum) that the watcher reads back. A zero-byte record is
    dropped."""
    if getattr(_tls, "paused", 0):
        return
    try:
        rec = CommOp(op=str(op), axis=str(axis),
                     bytes_per_call=int(nbytes),
                     program=current_program(),
                     fused_depth=max(int(fused_depth), 1))
    except (TypeError, ValueError):
        return
    if rec.bytes_per_call <= 0:
        return
    acc = getattr(_tls, "acc", None)
    if acc is None:
        get_ledger().register(rec)
        return
    key = (rec.program, rec.op, rec.axis)
    old = acc.get(key)
    if old is not None:
        rec = dataclasses.replace(
            rec, bytes_per_call=old.bytes_per_call + rec.bytes_per_call)
    acc[key] = rec


# ------------------------------------------------------------------
# network roofline: the comm knob layer
# ------------------------------------------------------------------
@dataclasses.dataclass
class CommConfig:
    """Link-peak knobs (the ``comm`` layer, autotune/knobs.py).
    0 = resolve from env, else auto-detect per generation."""

    peak_ici_gbps: float = 0.0
    peak_dcn_gbps: float = 0.0


def _detect_link_peaks(device=None) -> Dict[str, object]:
    """The card's table entry (the first table's for a CUDA card the
    table does not name; an unnamed card's DCN stays 0), or the CPU's
    loopback figures."""
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev is not None and dev.type == "cuda":
        low = torch.cuda.get_device_name(dev).lower()
        for tag, ici, dcn in _LINK_PEAKS:
            if tag in low:
                return {"peak_ici_gbps": ici, "peak_dcn_gbps": dcn,
                        "source": f"auto:{tag}"}
        _, ici, dcn = _LINK_PEAKS[0]
        return {"peak_ici_gbps": ici, "peak_dcn_gbps": dcn,
                "source": "auto:cuda"}
    return {"peak_ici_gbps": _CPU_ICI_GBPS,
            "peak_dcn_gbps": _CPU_DCN_GBPS, "source": "auto:cpu"}


def resolve_link_peaks(cfg: Optional[CommConfig] = None,
                       device=None) -> Dict[str, object]:
    """Resolve the per-link peak GB/s the utilization gauges score
    against: tuned manifest → explicit config → environment
    (``TPU_OPERATOR_PEAK_ICI_GBPS`` / ``TPU_OPERATOR_PEAK_DCN_GBPS``)
    → the table of ``device``'s card. Returns
    ``{"peak_ici_gbps", "peak_dcn_gbps", "source"}``."""
    from dgl_operator_tpu_torch.autotune import knobs

    cfg = knobs.apply_tuned(cfg or CommConfig(), layer="comm")
    knobs.validate("peak_ici_gbps", cfg.peak_ici_gbps)
    knobs.validate("peak_dcn_gbps", cfg.peak_dcn_gbps)
    if cfg.peak_ici_gbps > 0 and cfg.peak_dcn_gbps > 0:
        return {"peak_ici_gbps": float(cfg.peak_ici_gbps),
                "peak_dcn_gbps": float(cfg.peak_dcn_gbps),
                "source": "config"}
    auto: Optional[Dict[str, object]] = None
    out: Dict[str, object] = {}
    sources = []
    for knob, env in (("peak_ici_gbps", PEAK_ICI_ENV),
                      ("peak_dcn_gbps", PEAK_DCN_ENV)):
        val = float(getattr(cfg, knob))
        if val > 0:
            out[knob] = val
            sources.append("config")
            continue
        raw = os.environ.get(env, "").strip()
        if raw:
            try:
                val = float(raw)
            except ValueError:
                val = 0.0
        if val > 0:
            out[knob] = val
            sources.append("env")
            continue
        if auto is None:
            auto = _detect_link_peaks(device)
        out[knob] = auto[knob]
        sources.append(str(auto["source"]))
    out["source"] = sources[0] if len(set(sources)) == 1 \
        else "+".join(sources)
    return out


def link_of(axis: str) -> str:
    """Which physical link a mesh axis rides: axes named for the
    data-center network (``dcn`` anywhere in the name, the ROADMAP
    item 1 multi-slice convention) score against the DCN peak,
    everything else against ICI."""
    return "dcn" if "dcn" in axis.lower() else "ici"


# ------------------------------------------------------------------
# per-axis byte accumulator (livez / tpu-top rider)
# ------------------------------------------------------------------
_axis_lock = threading.Lock()
_axis_bytes: Dict[str, float] = {}


def _account_axis(axis: str, nbytes: float) -> None:
    with _axis_lock:
        _axis_bytes[axis] = _axis_bytes.get(axis, 0.0) + float(nbytes)


def axis_bytes_total() -> Dict[str, float]:
    """Cumulative watched bytes per mesh axis this process — the
    heartbeat feeds this into /livez so ``tpu-top`` can render a
    per-axis MiB/s column (obs/live.py, obs/top.py)."""
    with _axis_lock:
        return dict(_axis_bytes)


def reset_axis_bytes() -> None:
    with _axis_lock:
        _axis_bytes.clear()


# ------------------------------------------------------------------
# the watcher
# ------------------------------------------------------------------
class CommWatcher:
    """The one in-flight-window watcher (thread prefix
    ``tpu-commwatch``). One FIFO worker closes windows in submission
    order; it only waits on the window's event and emits — it never
    launches work on the card.

    ``watch()`` takes the window's optional spans, overlap-tracker
    sides and the program whose ledger records it covers."""

    def __init__(self, name: str = WATCH_THREAD_PREFIX,
                 peaks: Optional[Dict[str, object]] = None,
                 device=None):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix=name)
        self._lock = threading.Lock()
        self._peaks = peaks
        self._device = device
        self._peaks_published = False
        self._seq = 0

    # -- link peaks ---------------------------------------------------
    def _link_peaks(self) -> Dict[str, object]:
        with self._lock:
            peaks = self._peaks
            published = self._peaks_published
        if peaks is None:
            try:
                peaks = resolve_link_peaks(device=self._device)
            except Exception:  # noqa: BLE001 — roofline is best-effort
                peaks = {"peak_ici_gbps": 0.0, "peak_dcn_gbps": 0.0,
                         "source": "none"}
            with self._lock:
                self._peaks = peaks
        if not published:
            try:
                from dgl_operator_tpu_torch.obs import get_obs
                m = get_obs().metrics
                m.gauge("comm_peak_ici_gbps",
                        "resolved ICI link peak GB/s the comm roofline "
                        "scores against").set(
                            float(peaks["peak_ici_gbps"]))
                m.gauge("comm_peak_dcn_gbps",
                        "resolved DCN link peak GB/s the comm roofline "
                        "scores against").set(
                            float(peaks["peak_dcn_gbps"]))
            except Exception:  # noqa: BLE001
                pass
            with self._lock:
                self._peaks_published = True
        return peaks

    # -- submission ---------------------------------------------------
    def watch(self, ref, t0: float, *, step=None,
              spans: Iterable[Tuple[str, str]] = (),
              compute: Iterable[object] = (),
              exchange: Iterable[object] = (),
              program: Optional[str] = None):
        """Watch one dispatched window.

        ``ref``      — a ``torch.cuda.Event`` recorded on the stream the
                       work ran on, after it (the watcher waits for it);
                       anything else (None, a CPU tensor) means the work
                       is done and the window closes now
        ``t0``       — perf_counter at dispatch
        ``spans``    — ``(name, cat)`` spans closed over the window
        ``compute``/``exchange`` — OverlapTracker sides fed the window
        ``program``  — ledger key: which program's collectives this
                       window covers (None = no comm emission)
        """
        t1 = None
        if not callable(getattr(ref, "synchronize", None)):
            ref, t1 = None, time.perf_counter()
        ops = tuple(get_ledger().ops_of(program)) if program else ()
        with self._lock:
            self._seq += 1
            seq = self._seq
        if ops:
            # note the start BEFORE waiting, on the caller's thread:
            # a crash mid-window must find this sample in the ring
            from dgl_operator_tpu_torch.obs.flight import get_flight
            get_flight().note("comm", phase="start", seq=seq,
                              op=ops[0].op, axis=ops[0].axis,
                              program=ops[0].program, step=step)
        return self._pool.submit(self._observe, ref, t0, t1, step,
                                 tuple(spans), tuple(compute),
                                 tuple(exchange), ops, seq)

    def drain(self) -> None:
        """Barrier on the FIFO: every submitted window is closed."""
        self._pool.submit(lambda: None).result()

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)

    # -- the observe body (watch thread) ------------------------------
    def _observe(self, ref, t0, t1, step, spans, compute, exchange, ops,
                 seq) -> None:
        if ref is not None:
            # an event on the work's own stream: waiting on it launches
            # nothing
            ref.synchronize()
            t1 = time.perf_counter()
        for tracker in compute:
            tracker.add_compute(t0, t1)
        for tracker in exchange:
            tracker.add_exchange(t0, t1)
        from dgl_operator_tpu_torch.obs import get_obs
        obs = get_obs()
        for name, cat in spans:
            obs.complete(name, t0, t1, cat=cat, step=step)
        if ops:
            # one process holds every local slot: no per-slot readiness
            self._emit_comm(obs, ops, t0, t1, step, ())
            from dgl_operator_tpu_torch.obs.flight import get_flight
            get_flight().note("comm", phase="done", seq=seq,
                              op=ops[0].op, step=step)

    def _emit_comm(self, obs, ops, t0, t1, step, slot_times) -> None:
        """Per-collective emission for one closed window: spans,
        byte/second counters, achieved-vs-peak gauges, slot skew."""
        dt = max(t1 - t0, 1e-9)
        peaks = self._link_peaks()
        m = obs.metrics
        bytes_c = m.counter(
            "comm_bytes_total",
            "analytic bytes moved per collective op",
            labels=("op", "axis"))
        secs_c = m.counter(
            "comm_seconds",
            "in-flight wall-clock attributed per collective op "
            "(window split by byte share when ops co-reside)",
            labels=("op", "axis"))
        bw_g = m.gauge(
            "comm_link_gbps",
            "achieved link bandwidth of the latest window per "
            "collective op (analytic bytes over the measured window "
            "— a lower bound when ops share the window)",
            labels=("op", "axis"))
        util_g = m.gauge(
            "comm_link_util",
            "achieved fraction of the resolved ICI/DCN link peak per "
            "collective op",
            labels=("op", "axis", "link"))
        total = float(sum(o.bytes_per_call for o in ops)) or 1.0
        for o in ops:
            share = dt * (o.bytes_per_call / total)
            gbps = o.bytes_per_call / dt / 1e9
            link = link_of(o.axis)
            peak = float(peaks.get(f"peak_{link}_gbps") or 0.0)
            obs.complete(
                o.op, t0, t1, cat="comm", axis=o.axis,
                bytes=o.bytes_per_call, program=o.program,
                fused_depth=o.fused_depth, step=step)
            bytes_c.inc(o.bytes_per_call, op=o.op, axis=o.axis)
            secs_c.inc(round(share, 6), op=o.op, axis=o.axis)
            bw_g.set(round(gbps, 6), op=o.op, axis=o.axis)
            if peak > 0:
                util_g.set(round(gbps / peak, 6), op=o.op,
                           axis=o.axis, link=link)
            _account_axis(o.axis, o.bytes_per_call)
        if slot_times:
            # attribute slot skew to the window's dominant collective
            # (ops_of sorts largest-first)
            top = ops[0]
            skew_c = m.counter(
                "comm_slot_seconds",
                "cumulative per-mesh-slot readiness lag of the "
                "dominant collective — the straggler-skew series "
                "(slot i ready at t_i, lag = t_i - dispatch)",
                labels=("op", "axis", "slot"))
            for i, ts in enumerate(slot_times):
                skew_c.inc(round(max(ts - t0, 0.0), 6), op=top.op,
                           axis=top.axis, slot=str(i))


# ------------------------------------------------------------------
# bench summary (pinned keys)
# ------------------------------------------------------------------
def comm_summary(obs_dir: str) -> Optional[Dict[str, object]]:
    """Comm-plane summary of a finished run's obs dir, shaped by the
    pinned ``benchkeys.COMM_KEYS`` (benchmarks/bench_comm.py tracks it
    as COMM.json; the doctor comm block renders it). None when the run
    emitted no comm metrics at all."""
    from dgl_operator_tpu_torch.obs.prof import _gauge_value, _merged_metrics

    merged = _merged_metrics(obs_dir)

    def _totals(name: str) -> Dict[Tuple[str, str], float]:
        fam = merged.get(name) or {}
        out: Dict[Tuple[str, str], float] = {}
        for s in fam.get("samples", []):
            lb = s.get("labels", {})
            key = (str(lb.get("op", "?")), str(lb.get("axis", "?")))
            out[key] = out.get(key, 0.0) + float(s.get("value", 0.0))
        return out

    byte_tot = _totals("comm_bytes_total")
    if not byte_tot:
        return None
    sec_tot = _totals("comm_seconds")
    per_op: Dict[str, Dict[str, float]] = {}
    for (op, axis), nbytes in sorted(byte_tot.items()):
        secs = sec_tot.get((op, axis), 0.0)
        per_op[f"{op}@{axis}"] = {
            "bytes": round(nbytes, 1),
            "seconds": round(secs, 6),
            "gbps": round(nbytes / max(secs, 1e-9) / 1e9, 6)
            if secs > 0 else 0.0,
        }
    top_key = max(per_op, key=lambda k: per_op[k]["bytes"])
    out: Dict[str, object] = {
        "comm_ops": sorted({op for op, _ in byte_tot}),
        "comm_bytes_total": round(sum(byte_tot.values()), 1),
        "comm_seconds": round(sum(sec_tot.values()), 6),
        "top_op": top_key,
        "top_op_gbps": per_op[top_key]["gbps"],
        "axis_util_max": _gauge_value(merged, "comm_link_util"),
        "overlap_ratio": _gauge_value(merged, "train_overlap_ratio"),
    }
    assert tuple(out) == COMM_KEYS
    out["per_op"] = per_op
    return out
