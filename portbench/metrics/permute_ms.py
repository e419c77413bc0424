"""Layer: trainer loop (``runtime/loop.py::run_epochs``). The mean of
the program's ``epoch.permute`` span over the window's epoch
boundaries: the next epoch's ``permute(rng)`` with the calls' set-up.
Reads the program's trace switch (``spans.py``); nothing without it."""

from portbench.spans import span_mean_ms

UNIT = "ms"
SOURCE = "program_span"
LAYER = "trainer loop"
MOVES = "samples_per_s"


def read(ctx):
    return span_mean_ms(ctx, "epoch.permute")
