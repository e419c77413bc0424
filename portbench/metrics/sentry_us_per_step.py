"""Layer: sentry (``obs/quality.py``). The device µs a step of the
``sentry`` phase in the K-step graph: ``grad_part`` and the parameters'
copy before the update, their stats after it
(``runtime/graphs.py::PhaseClock``, the gaps between its kernels
included). None with the sentry off. Reads the program's trace switch
(``spans.py``); nothing without it."""

from portbench.spans import phase_us_per_step

UNIT = "us"
SOURCE = "program_counter"
LAYER = "sentry"
MOVES = "samples_per_s"


def read(ctx):
    return phase_us_per_step(ctx, "sentry")
