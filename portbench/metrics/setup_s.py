"""Seconds from the process's start to the first timed call: imports,
kernel build or load, the graph, device uploads, the draws, warm-up,
capture and the checked steps."""

UNIT = "s"
SOURCE = "host_clock"


def read(ctx):
    return ctx.get("setup_s")
