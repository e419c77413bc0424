"""Request micro-batcher: coalesce concurrent point queries into padded
fixed-shape batches.

The engine runs one padded request shape (``batch_size`` seeds), so a
server that ran one batch per request would spend most of each batch on
padding. The micro-batcher holds arrivals for up to ``max_wait_s`` and
flushes them together:

- a flush happens the moment ``batch_size`` seeds are pending, or when
  the OLDEST pending request has waited ``max_wait_s``;
- a burst larger than ``batch_size`` splits into consecutive batches in
  arrival order; a request spanning batches is reassembled;
- occupancy (valid seeds / padded slots) is accounted per batch.

``process_fn(seeds, seq)`` receives a ``[<=batch_size]`` int64 seed
vector and the batch sequence number and returns one result row per
seed. Failures propagate to every waiting future of that batch. Each
request carries its submitting thread's trace context
(``obs/tracectx.py``): a batch runs under its oldest request's, and
each request's submit-to-result span hangs under its own.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

import numpy as np

from dgl_operator_tpu_torch.obs import LATENCY_BUCKETS, get_obs, tracectx


class Overloaded(RuntimeError):
    """The batcher is shedding load: the request was rejected before
    entering the queue, or expired in it past its deadline."""


class _Pending:
    __slots__ = ("seeds", "future", "t_submit", "results", "filled",
                 "next_chunk", "ctx", "pc_submit", "priority", "deadline")

    def __init__(self, seeds: np.ndarray, t_submit: float,
                 priority: int = 0,
                 deadline: Optional[float] = None):
        self.seeds = seeds
        self.future: Future = Future()
        self.t_submit = t_submit
        self.priority = priority
        # absolute clock() time past which running this request only
        # wastes padded slots (the client already gave up)
        self.deadline = deadline
        # the submitting thread's trace context, carried explicitly: the
        # batcher thread serves many requests' chunks interleaved
        self.ctx = tracectx.current()
        self.pc_submit = time.perf_counter()
        # chunk index -> result rows; chunk indices are assigned in
        # FIFO take order under the batcher lock, so sorted order IS
        # seed order
        self.results: dict = {}
        self.filled = 0
        self.next_chunk = 0


class MicroBatcher:
    """Deadline-bounded request coalescer in front of a fixed-shape
    executor. Thread-safe; the background flusher is optional
    (``start()``) — :meth:`flush_now` drains synchronously."""

    def __init__(self, process_fn: Callable[[np.ndarray, int], np.ndarray],
                 batch_size: int, max_wait_s: float = 0.005,
                 clock: Callable[[], float] = time.monotonic,
                 capacity_of: Optional[Callable[[int], int]] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.process_fn = process_fn
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_s)
        self._clock = clock
        # padded slots a dispatch of n valid seeds occupies (the
        # engine's shape ladder may pad a small batch to less than
        # batch_size)
        self._capacity_of = (capacity_of if capacity_of is not None
                             else lambda n: self.batch_size)
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # queue of (request, offset): offset = seeds already consumed
        # by earlier batches
        self._queue: List[Tuple[_Pending, int]] = []
        self._pending_seeds = 0
        self._seq = 0
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.batches = 0
        self.valid_slots = 0
        self.padded_slots = 0
        # deadline-expired requests awaiting their Overloaded fan-out
        # (collected under the lock, completed outside it)
        self._expired: List[_Pending] = []
        m = get_obs().metrics
        self._m_requests = m.counter("serve_requests_total",
                                     "prediction requests accepted")
        self._m_seeds = m.counter("serve_seeds_total",
                                  "seed nodes across all requests")
        self._m_batches = m.counter("serve_batches_total",
                                    "padded micro-batches dispatched")
        self._m_qdepth = m.gauge("serve_queue_seeds",
                                 "seed nodes waiting in the batcher")
        self._m_latency = m.histogram(
            "serve_request_seconds",
            "end-to-end request latency (submit -> result)",
            buckets=LATENCY_BUCKETS)
        self._m_wait = m.histogram(
            "serve_batch_wait_seconds",
            "time the oldest request of each batch waited for coalescing",
            buckets=LATENCY_BUCKETS)
        self._m_occupancy = m.histogram(
            "serve_batch_occupancy",
            "valid seeds / padded slots per dispatched batch",
            buckets=tuple(i / 10 for i in range(1, 11)))
        self._m_shed = m.counter(
            "serve_requests_shed_total",
            "requests rejected at admission while shedding")
        self._m_deadline_shed = m.counter(
            "serve_deadline_shed_total",
            "queued requests expired past their deadline before dispatch")
        self._shedding = False
        self._shed_reason = ""
        # minimum priority admitted while shedding
        self._shed_floor = 1

    # -- admission control ---------------------------------------------
    def set_shedding(self, on: bool, reason: str = "",
                     floor: int = 1) -> None:
        """Flip load shedding. While on, :meth:`submit` raises
        :class:`Overloaded` for requests whose priority is below
        ``floor``; already-queued requests still complete."""
        on = bool(on)
        with self._lock:
            if on:
                self._shed_floor = int(floor)
            if on == self._shedding:
                return
            self._shedding = on
            self._shed_reason = reason if on else ""
        if on:
            get_obs().emit("serve_shed_start", reason=reason)
        else:
            get_obs().emit("serve_shed_stop")

    @property
    def shedding(self) -> bool:
        return self._shedding

    @property
    def shed_floor(self) -> int:
        return self._shed_floor

    @property
    def pending_seeds(self) -> int:
        """Seeds waiting in the queue."""
        return self._pending_seeds

    # -- submission ----------------------------------------------------
    def submit(self, node_ids, priority: int = 0,
               deadline_s: Optional[float] = None) -> Future:
        """Enqueue one request (1-D vector of seed node ids); the future
        resolves to one result row per seed, in request order. Never
        blocks on the executor. ``deadline_s`` bounds queue time: a
        request still fully undispatched after that many seconds
        completes with :class:`Overloaded`."""
        if self._shedding and priority < self._shed_floor:
            self._m_shed.inc()
            raise Overloaded("shedding load"
                             + (f": {self._shed_reason}"
                                if self._shed_reason else ""))
        seeds = np.asarray(node_ids, np.int64).reshape(-1)
        if len(seeds) == 0:
            f: Future = Future()
            f.set_result(np.zeros(0, np.int64))
            return f
        now = self._clock()
        req = _Pending(seeds, now, priority=int(priority),
                       deadline=(None if deadline_s is None
                                 else now + float(deadline_s)))
        with self._wake:
            if self._stop:
                raise RuntimeError("batcher is stopped")
            self._queue.append((req, 0))
            self._pending_seeds += len(seeds)
            self._m_qdepth.set(self._pending_seeds)
            self._wake.notify()
        self._m_requests.inc()
        self._m_seeds.inc(len(seeds))
        return req.future

    # -- batch formation ----------------------------------------------
    def _take_batch(self):
        """Pop up to ``batch_size`` seeds off the queue (caller holds
        the lock). Returns (seeds, parts, t_oldest, seq) or None when
        the queue is empty."""
        now = self._clock()
        if any(req.deadline is not None and now >= req.deadline
               and req.next_chunk == 0 for req, _ in self._queue):
            # expire only fully-undispatched requests: one with a chunk
            # in flight completes normally
            keep: List[Tuple[_Pending, int]] = []
            for req, off in self._queue:
                if req.deadline is not None and now >= req.deadline \
                        and req.next_chunk == 0:
                    self._pending_seeds -= len(req.seeds)
                    self._expired.append(req)
                else:
                    keep.append((req, off))
            self._queue = keep
            self._m_qdepth.set(self._pending_seeds)
        if not self._queue:
            return None
        taken: List[np.ndarray] = []
        parts: List[Tuple[_Pending, int, int]] = []  # req, chunk_i, n
        room = self.batch_size
        t_oldest = self._queue[0][0].t_submit
        while self._queue and room > 0:
            req, off = self._queue[0]
            chunk = req.seeds[off: off + room]
            chunk_i = req.next_chunk
            req.next_chunk += 1
            taken.append(chunk)
            parts.append((req, chunk_i, len(chunk)))
            room -= len(chunk)
            if off + len(chunk) >= len(req.seeds):
                self._queue.pop(0)
            else:
                self._queue[0] = (req, off + len(chunk))
        seeds = np.concatenate(taken)
        self._pending_seeds -= len(seeds)
        self._m_qdepth.set(self._pending_seeds)
        seq = self._seq
        self._seq += 1
        self.batches += 1
        self.valid_slots += len(seeds)
        self.padded_slots += self._capacity_of(len(seeds))
        return seeds, parts, t_oldest, seq

    def _fan_expired(self) -> None:
        """Complete deadline-expired requests with Overloaded, outside
        the lock (future callbacks may re-enter the batcher)."""
        with self._lock:
            if not self._expired:
                return
            expired, self._expired = self._expired, []
        for req in expired:
            self._m_deadline_shed.inc()
            self._m_shed.inc()
            if not req.future.done():
                req.future.set_exception(
                    Overloaded("deadline exceeded before dispatch"))

    def _dispatch(self, seeds: np.ndarray, parts, t_oldest: float,
                  seq: int) -> None:
        """Run one padded batch and fan results (or the failure) back
        out to the waiting futures. The batch runs under the oldest
        request's trace context (a coalesced batch carries one engine
        span tree); each request's submit→complete window is recorded as
        a ``serve_request`` span under its own context."""
        obs = get_obs()
        self._m_batches.inc()
        self._m_occupancy.observe(
            len(seeds) / max(self._capacity_of(len(seeds)), 1))
        self._m_wait.observe(max(self._clock() - t_oldest, 0.0))
        carrier = parts[0][0].ctx if parts else None
        try:
            with tracectx.use(carrier), \
                    tracectx.span("serve_batch", cat="serve", batch=seq,
                                  seeds=len(seeds)):
                out = np.asarray(self.process_fn(seeds, seq))
            if len(out) != len(seeds):
                raise RuntimeError(
                    f"process_fn returned {len(out)} rows for "
                    f"{len(seeds)} seeds")
        except BaseException as exc:  # noqa: BLE001 — fan out to waiters
            for req, _, _ in parts:
                if not req.future.done():
                    req.future.set_exception(exc)
            if not isinstance(exc, Exception):
                raise
            return
        lo = 0
        now = self._clock()
        for req, chunk_i, n in parts:
            with self._lock:
                req.results[chunk_i] = out[lo: lo + n]
                req.filled += n
                complete = req.filled >= len(req.seeds)
            lo += n
            if complete:
                self._m_latency.observe(max(now - req.t_submit, 0.0))
                ids = (req.ctx.child().ids() if req.ctx is not None
                       else {})
                obs.complete("serve_request", req.pc_submit,
                             time.perf_counter(), cat="serve",
                             seeds=len(req.seeds), **ids)
                req.future.set_result(np.concatenate(
                    [req.results[i] for i in sorted(req.results)]))

    def flush_now(self) -> int:
        """Drain everything pending into consecutive padded batches on
        the caller's thread; returns the number of batches dispatched."""
        n = 0
        while True:
            with self._lock:
                batch = self._take_batch()
            self._fan_expired()
            if batch is None:
                return n
            self._dispatch(*batch)
            n += 1

    # -- background flusher -------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._wake:
                while (not self._stop and not self._pending_seeds):
                    self._wake.wait()
                if self._stop and not self._pending_seeds:
                    return
                if self._pending_seeds < self.batch_size \
                        and not self._stop:
                    # under-full: hold until the oldest arrival's
                    # deadline, re-checking as new arrivals land
                    deadline = self._queue[0][0].t_submit \
                        + self.max_wait_s
                    remaining = deadline - self._clock()
                    if remaining > 0 and \
                            self._pending_seeds < self.batch_size:
                        self._wake.wait(timeout=remaining)
                        continue
                batch = self._take_batch()
            self._fan_expired()
            if batch is not None:
                self._dispatch(*batch)

    def start(self) -> "MicroBatcher":
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(target=self._loop,
                                            name="serve-batcher",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the background flusher; ``drain`` dispatches whatever
        is still queued first so no future is left hanging."""
        t, self._thread = self._thread, None
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        if t is not None:
            t.join(timeout=10.0)
        if drain:
            self.flush_now()
        else:
            with self._lock:
                leftovers = self._queue
                self._queue = []
                self._pending_seeds = 0
            for req, _ in leftovers:
                if not req.future.done():
                    req.future.set_exception(
                        RuntimeError("batcher stopped"))

    # -- accounting ----------------------------------------------------
    def occupancy(self) -> float:
        """Valid seeds / padded slots over every batch dispatched so far
        (1.0 before any batch)."""
        if self.batches == 0:
            return 1.0
        return self.valid_slots / self.padded_slots
