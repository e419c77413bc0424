"""``torch.cuda.max_memory_allocated()`` over the run's process, read
once the window has closed and before the reference runs, in GiB."""

UNIT = "GiB"
SOURCE = "host_clock"


def read(ctx):
    peak = ctx.get("peak_bytes")
    return peak / 2**30 if peak else None
