"""Layer: device. The share of the traced stretch's idle device time
under no dotted program span (``loop.*``, ``epoch.*``, ``devrun.*``;
the ``train`` and ``epoch N`` ranges, open all run, name nothing), from
the stretch's ``idle_by_span`` (``spans.py::idle_by_span``). Reads the
program's spans in the profiler's trace; nothing without them."""

from portbench.spans import unspanned_pct

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "samples_per_s"


def read(ctx):
    by_span = (ctx.get("trace") or {}).get("idle_by_span")
    return unspanned_pct(by_span) if by_span else None
