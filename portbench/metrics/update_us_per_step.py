"""Layer: optimizer. The device µs a step of the ``update`` phase in
the K-step graph: Adam's step, the results' copy and the counters
(``runtime/graphs.py::PhaseClock``, the gaps between its kernels
included). Reads the program's trace switch (``spans.py``); nothing
without it."""

from portbench.spans import phase_us_per_step

UNIT = "us"
SOURCE = "program_counter"
LAYER = "optimizer"
MOVES = "samples_per_s"


def read(ctx):
    return phase_us_per_step(ctx, "update")
