"""Reading a ``torch.profiler`` trace of a stretch of calls.

The stretch is one ``record_function`` range (``RANGE``) on the host;
the device's operations inside it are every CUDA event of the trace but
the device-side copies of host annotations. From them: the seconds the
device was busy (the union of its operations' intervals within the
range), the range's seconds, device time by kind of kernel, the
operations that took most time, the longest idle gaps named by the
innermost host operation open at the gap's start, and the host's
seconds in each CUDA runtime call.

``kernel_kind`` copies ``chip_smoke.py::gnn_kernel_kind`` (the port's
three kernels, cuBLAS, copies, plain ops), with cuBLAS's ``nvjet`` and
split-K reduction kernels counted as cuBLAS.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

RANGE = "portbench.profiled"
PORT_KERNELS = ("fanout_agg", "gather_rows", "scatter_add_rows")
TOP = 10


def kernel_kind(name: str) -> str:
    for kernel, key in (("fanout_agg", "fanout_agg"),
                        ("gather_rows", "gather_rows"),
                        ("scatter_add_rows", "segment_sum_kernel"),
                        ("scatter_add_rows", "add_partials_kernel")):
        if key in name:
            return kernel
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "cublas", "cutlass", "xmma",
                              "nvjet", "splitkreduce")):
        return "cublas"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "plain"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events) -> Dict:
    """The stretch's figures from ``prof.events()``: ``window_s``,
    ``busy_s``, ``by_kind_us`` (device µs by :func:`kernel_kind`),
    ``launches`` (by kind), ``device_ops``, ``idle_gaps`` and
    ``host_cuda_calls`` (``[name, seconds]``, longest first, at most
    ``TOP``). Raises when the trace holds no device operation inside the
    range."""
    from torch.autograd import DeviceType

    cpu, dev, window = [], [], None
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) \
                    or e.name.startswith("Optimizer.") \
                    or e.name.startswith("portbench."):
                continue
            dev.append(e)
        else:
            if e.name == RANGE:
                window = (e.time_range.start, e.time_range.end)
            cpu.append(e)
    if window is None:
        raise RuntimeError(f"the trace has no {RANGE!r} range")
    w0, w1 = window
    spans, by_kind, launches, by_name = [], {}, {}, {}
    for e in dev:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        spans.append((s, t))
        kind = kernel_kind(e.name)
        us = t - s
        by_kind[kind] = by_kind.get(kind, 0.0) + us
        launches[kind] = launches.get(kind, 0) + 1
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    if not spans:
        raise RuntimeError("the trace holds no device operation in the "
                           "profiled range")
    busy = _union(spans)
    gaps = []
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:TOP]:
        inner = None
        for e in cpu:
            if e.name == RANGE:
                continue
            if e.time_range.start <= a < e.time_range.end and (
                    inner is None
                    or e.time_range.start >= inner.time_range.start):
                inner = e
        named.append([inner.name if inner is not None else "host: none",
                      (b - a) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    host: Dict[str, float] = {}
    for e in cpu:
        if e.name.startswith("cuda") and w0 <= e.time_range.start < w1:
            host[e.name] = host.get(e.name, 0.0) + (e.time_range.end
                                                    - e.time_range.start)
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "by_kind_us": by_kind, "launches": launches,
            "device_ops": [[n, us * 1e-6] for n, us in ops],
            "idle_gaps": named,
            "host_cuda_calls": [[n, us * 1e-6] for n, us in sorted(
                host.items(), key=lambda kv: -kv[1])[:TOP]]}
