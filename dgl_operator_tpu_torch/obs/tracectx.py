"""Trace-context propagation — one request as a single span tree across
threads and HTTP hops.

A W3C-traceparent-shaped context (trace id, span id, parent span id)
crosses the two boundaries of the serving plane:

- **HTTP** (router → replica): the ``X-Tpu-Trace`` header carries
  ``trace_id-span_id`` of the caller's span, and the replica's spans
  hang under it;
- **threads** (HTTP handler → batcher thread → engine): the context is
  an explicit value (:func:`current` → carry → :func:`use`), never
  inherited thread-locally, so the batcher thread cannot leak one
  request's context into a concurrent one.

Every span recorded while a context is active carries ``trace_id``,
``span_id`` and ``parent_id`` in the port's in-memory ``Obs.spans``
(``obs/__init__.py``), so a request's tree can be rebuilt from them.

A third boundary is the process: ``span(export_env=True)`` publishes
the span as ``TPU_OPERATOR_TRACE_ID`` / ``TPU_OPERATOR_TRACE_PARENT``
for the processes started inside it (the launcher's phases and
trainers; ``launcher/launch.py`` folds :func:`env_of_current` into every
trainer's environment), and a process started so roots its spans under
that span (:func:`current` falls back to :func:`from_env`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import uuid
from typing import Dict, Iterator, Optional

from dgl_operator_tpu_torch.obs.trace import hot_span

TRACE_ID_ENV = "TPU_OPERATOR_TRACE_ID"
TRACE_PARENT_ENV = "TPU_OPERATOR_TRACE_PARENT"
# HTTP carrier: "trace_id-span_id"
TRACE_HEADER = "X-Tpu-Trace"


def _gen_id(nbytes: int = 8) -> str:
    return uuid.uuid4().hex[: nbytes * 2]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One span's identity: its trace, its own id, and the span it hangs
    under (None for a trace root)."""

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, _gen_id(), self.span_id)

    def header(self) -> str:
        return f"{self.trace_id}-{self.span_id}"

    @classmethod
    def from_header(cls, value: Optional[str]
                    ) -> Optional["TraceContext"]:
        if not value:
            return None
        parts = value.strip().split("-")
        if len(parts) != 2 or not all(parts):
            return None
        return cls(trace_id=parts[0], span_id=parts[1])

    def env(self) -> Dict[str, str]:
        """The environment pair a child process roots under: its spans
        become children of ``span_id``."""
        return {TRACE_ID_ENV: self.trace_id, TRACE_PARENT_ENV: self.span_id}

    def ids(self) -> Dict[str, str]:
        """Span-record fields (``parent_id`` omitted for roots)."""
        out = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            out["parent_id"] = self.parent_id
        return out


def new_root() -> TraceContext:
    return TraceContext(trace_id=_gen_id(16), span_id=_gen_id())


def from_env(environ=None) -> Optional[TraceContext]:
    """The context a parent process exported, or None: the remote parent
    span itself, so local spans under it become its children."""
    environ = os.environ if environ is None else environ
    tid = environ.get(TRACE_ID_ENV)
    if not tid:
        return None
    return TraceContext(trace_id=tid,
                        span_id=environ.get(TRACE_PARENT_ENV) or tid)


_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current() -> Optional[TraceContext]:
    """This thread's innermost :func:`span` / :func:`use` context, else
    the context the parent process exported, else None."""
    st = _stack()
    return st[-1] if st else from_env()


def current_ids() -> Dict[str, str]:
    """Span-record fields of the active context ({} when none)."""
    ctx = current()
    return ctx.ids() if ctx is not None else {}


@contextlib.contextmanager
def use(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Activate an explicitly carried context on this thread; None is a
    no-op, so carriers need no conditional."""
    if ctx is None:
        yield None
        return
    st = _stack()
    st.append(ctx)
    try:
        yield ctx
    finally:
        st.pop()


@contextlib.contextmanager
def span(name: str, cat: str = "trace", export_env: bool = False,
         ctx: Optional[TraceContext] = None,
         **args) -> Iterator[TraceContext]:
    """A child span of the active (or given) context, or a new trace
    root when there is none, recorded on ``get_obs().spans`` on exit and
    active for the block so nested spans attach under it; while a
    ``torch.profiler`` is active it is also a profiler range
    (``obs/trace.py::hot_span``). With
    ``export_env`` the span is also the process environment's context
    for the block, so the processes started inside it root their spans
    under it."""
    parent = ctx if ctx is not None else current()
    me = parent.child() if parent is not None else new_root()
    st = _stack()
    st.append(me)
    prev_env = None
    if export_env:
        prev_env = {k: os.environ.get(k) for k in (TRACE_ID_ENV,
                                                   TRACE_PARENT_ENV)}
        os.environ.update(me.env())
    t0 = time.perf_counter()
    try:
        with hot_span(name, aggregate=False):
            yield me
    finally:
        t1 = time.perf_counter()
        st.pop()
        if prev_env is not None:
            for k, v in prev_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        from dgl_operator_tpu_torch.obs import get_obs
        get_obs().complete(name, t0, t1, cat=cat, **me.ids(), **args)


def env_of_current() -> Dict[str, str]:
    """The environment pair of the active context ({} when none)."""
    ctx = current()
    return ctx.env() if ctx is not None else {}
