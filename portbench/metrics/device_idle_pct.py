"""Layer: device. The share of the window's seconds in which no
operation ran on the card: the traced stretch's busy device seconds a
step (``torch.profiler``, the union of its operations' intervals) times
the window's steps, against the window's seconds. The traced stretch's
own idle share (``device.busy_s`` against ``device.window_s``) reads
higher, because the profiler slows the host that paces the loop."""

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "samples_per_s"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx.get("window_s") or not ctx.get("steps"):
        return None
    busy = tr["busy_s"] / tr["steps"] * ctx["steps"]
    return 100.0 * (1.0 - busy / ctx["window_s"])
