"""Layer: model (``models/sage.py``, ``nn/conv.py``: forward, loss,
backward). The device µs a step of the ``model`` phase in the K-step
graph: ``zero_grad``, the gather, forward, loss and backward
(``runtime/graphs.py::PhaseClock``, the gaps between its kernels
included). Reads the program's trace switch (``spans.py``); nothing
without it."""

from portbench.spans import phase_us_per_step

UNIT = "us"
SOURCE = "program_counter"
LAYER = "model"
MOVES = "samples_per_s"


def read(ctx):
    return phase_us_per_step(ctx, "model")
