"""Layer: obs plane (sentry tap, heartbeat). The host µs a call of the
program's ``loop.sentry`` (the sentry's tap), ``loop.heartbeat`` (all of
``heartbeat()``) and ``loop.ckpt`` spans, over the window's calls.
Reads the program's trace switch (``spans.py``); nothing without it."""

UNIT = "us"
SOURCE = "program_span"
LAYER = "obs plane"
MOVES = "samples_per_s"


def read(ctx):
    spans = ctx.get("program_spans")
    if spans is None or not ctx.get("calls"):
        return None
    return sum(spans[n]["seconds"] for n in ("loop.sentry", "loop.heartbeat",
                                             "loop.ckpt")
               if n in spans) * 1e6 / ctx["calls"]
