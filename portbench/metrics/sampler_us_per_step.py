"""Layer: device sampler (``ops/device_sample.py``). The device µs a
step of the device sampler's ``sample`` phase in the K-step graph: from
the step's start, the bank's ``index_select`` included, to the tree
blocks (``runtime/graphs.py::PhaseClock``: the interval between two
timing events, the gaps between its kernels included). Reads the
program's trace switch (``spans.py``); nothing without it."""

from portbench.spans import phase_us_per_step

UNIT = "us"
SOURCE = "program_counter"
LAYER = "device sampler"
MOVES = "samples_per_s"


def read(ctx):
    return phase_us_per_step(ctx, "sample")
