"""Layer: whole step (``models/``, ``nn/conv.py``, Adam). The model FLOPs
of the traced run's window (its steps times the mean FLOPs of the
traced stretch's steps, counted by ``arith/flops.py`` from the widths
and each traced step's blocks) over the window's seconds times the peak
of the configuration's precision. Only a run on the card reads it."""

from portbench.arith import peaks

UNIT = "%"
SOURCE = "host_clock"
LAYER = "whole step"
MOVES = "samples_per_s"


def read(ctx):
    if not (ctx.get("on_card") and ctx.get("step_flops")
            and ctx.get("window_s")):
        return None
    rate = ctx["step_flops"] * ctx["steps"] / ctx["window_s"]
    return 100.0 * rate / peaks.FLOPS[ctx["precision"]]
