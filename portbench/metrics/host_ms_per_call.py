"""Layer: K-step call (``SampledTrainer.train_call`` into
``runtime/graphs.py::DeviceRun``, a graph replay a call). The mean of
the host's time inside each call of the traced run's window, from the
harness's clock around the call the program's loop makes: the time to
issue a K-step call, with any wait for room in the launch queue."""

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "K-step call"
MOVES = "samples_per_s"


def read(ctx):
    spans = ctx.get("host_call_ms")
    return sum(spans) / len(spans) if spans else None
