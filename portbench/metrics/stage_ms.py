"""Layer: trainer loop (``runtime/graphs.py::DeviceRun.stage``). The
mean of the program's ``devrun.stage`` span: an epoch's permuted ids
copied into the device sampler's bank. Reads the program's trace switch
(``spans.py``); nothing without it."""

from portbench.spans import span_mean_ms

UNIT = "ms"
SOURCE = "program_span"
LAYER = "trainer loop"
MOVES = "samples_per_s"


def read(ctx):
    return span_mean_ms(ctx, "devrun.stage")
