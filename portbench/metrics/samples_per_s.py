"""Training samples (seed nodes) completed over the whole window,
divided by the window's seconds (its end a synchronize after the last
whole call)."""

UNIT = "samples/s"
SOURCE = "host_clock"


def read(ctx):
    if not ctx.get("samples") or not ctx.get("window_s"):
        return None
    return ctx["samples"] / ctx["window_s"]
