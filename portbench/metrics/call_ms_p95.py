"""Layer: K-step call (``runtime/graphs.py::DeviceRun``, ``GraphedCall``).
The 95th percentile of the device time between the CUDA events that the
traced run's window records after consecutive calls. Needs 200 gaps, so
that ten lie beyond it."""

import statistics

UNIT = "ms"
SOURCE = "device_trace"
LAYER = "K-step call"
MOVES = "samples_per_s"
MIN_SAMPLES = 200


def read(ctx):
    gaps = ctx.get("call_gap_ms") or []
    if len(gaps) < MIN_SAMPLES:
        return None
    return statistics.quantiles(gaps, n=20)[-1]
