"""Layer: trainer loop (``runtime/loop.py::run_epochs``). The mean of
the program's ``loop.loss_fetch`` span: the ``train_step`` event every
``log_every`` steps and its fetch of the call's last loss, a sync that
waits for the calls still on the card. Reads the program's trace switch
(``spans.py``); nothing without it."""

from portbench.spans import span_mean_ms

UNIT = "ms"
SOURCE = "program_span"
LAYER = "trainer loop"
MOVES = "samples_per_s"


def read(ctx):
    return span_mean_ms(ctx, "loop.loss_fetch")
