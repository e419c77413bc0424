"""Layer: device sampler and plain ops (``ops/device_sample.py`` and the
model's elementwise torch ops, which a captured graph's trace does not
tell apart). Device microseconds a step of the kernels classed
``plain``, over the traced stretch."""

UNIT = "us"
SOURCE = "device_trace"
LAYER = "device sampler and plain ops"
MOVES = "samples_per_s"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["by_kind_us"].get("plain"):
        return None
    return tr["by_kind_us"]["plain"] / tr["steps"]
