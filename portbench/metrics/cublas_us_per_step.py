"""Layer: dense products (cuBLAS). Device microseconds a step of the
kernels that ``devtrace.kernel_kind`` classes as cuBLAS, over the traced
stretch."""

UNIT = "us"
SOURCE = "device_trace"
LAYER = "dense products"
MOVES = "samples_per_s"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["by_kind_us"].get("cublas"):
        return None
    return tr["by_kind_us"]["cublas"] / tr["steps"]
