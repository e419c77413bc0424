"""Layer: kernels (``csrc/{gather_rows,fanout_agg,scatter_add_rows}.cu``).
The least time of the work the port's launches do over the traced
stretch's steps (``arith/bounds.py``, at the card's peaks, from each
step's blocks drawn again by the reference's sampler), over those
launches' device time in the trace."""

from portbench.devtrace import PORT_KERNELS

UNIT = "%"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "samples_per_s"


def read(ctx):
    tr = ctx.get("trace")
    least = ctx.get("port_least_s")
    if not tr or not least:
        return None
    measured_us = sum(tr["by_kind_us"].get(k, 0.0) for k in PORT_KERNELS)
    if measured_us <= 0:
        return None
    return 100.0 * least / (measured_us * 1e-6)
