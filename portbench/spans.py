"""The program's own spans and phase counters in a cell's run.

With the program's trace switch on (``TPU_OPERATOR_TRACE=1``,
``dgl_operator_tpu_torch/obs/trace.py``), the run's ``ctx`` holds the
window's difference of two ``trace.snapshot()`` readings: its
``program_spans`` (span name -> ``count``, ``seconds``) and its
``program_phases`` (``us`` per device-sampler phase, the ``steps`` they
were read over), and the traced stretch's summary holds
``idle_by_span`` (:func:`idle_by_span`). The readers of
``metrics/`` read them through the helpers here and read nothing (None)
where a key is absent, as on a program without the switch.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from portbench.devtrace import RANGE, _union

# the dotted spans, which name what the host was doing; ``train`` and
# ``epoch N`` are program ranges too, but span the whole run
LEAF_PREFIXES = ("loop.", "epoch.", "devrun.")


def is_program_span(name: str) -> bool:
    return (name.startswith(LEAF_PREFIXES) or name == "train"
            or (name.startswith("epoch ") and name[6:].isdigit()))


def span_mean_ms(ctx: Dict, name: str) -> Optional[float]:
    """The mean milliseconds of span ``name`` in the window."""
    s = (ctx.get("program_spans") or {}).get(name)
    return s["seconds"] / s["count"] * 1e3 if s and s["count"] else None


def phase_us_per_step(ctx: Dict, phase: str) -> Optional[float]:
    """The device µs of ``phase`` a sampled step (None where the phase
    took no time: the sentry off)."""
    ph = ctx.get("program_phases")
    if not ph or not ph["steps"] or ph["us"].get(phase, 0.0) <= 0:
        return None
    return ph["us"][phase] / ph["steps"]


def idle_pieces(events) -> Iterator[Tuple[float, float, Dict[str, float]]]:
    """Each idle stretch of the device inside the traced range
    (``devtrace.RANGE``) of ``prof.events()``: its start and end (µs)
    and its seconds by the innermost program span open at each moment
    (``"none"`` where none is)."""
    from torch.autograd import DeviceType

    window, dev, prog = None, [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) \
                    and not e.name.startswith(("Optimizer.", "portbench.")):
                dev.append((s, t))
        elif e.name == RANGE:
            window = (s, t)
        elif is_program_span(e.name) and t > s:
            prog.append((s, t, e.name))
    if window is None:
        return
    w0, w1 = window
    busy = _union([(max(s, w0), min(t, w1)) for s, t in dev
                   if min(t, w1) > max(s, w0)])
    edges = [w0] + [x for s, t in busy for x in (s, t)] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        cuts = sorted({a, b} | {x for s, t, _ in prog for x in (s, t)
                                if a < x < b})
        names: Dict[str, float] = {}
        for lo, hi in zip(cuts, cuts[1:]):
            mid, inner = (lo + hi) / 2, None
            for s, t, name in prog:
                if s <= mid < t and (inner is None or s >= inner[0]):
                    inner = (s, name)
            key = inner[1] if inner else "none"
            names[key] = names.get(key, 0.0) + (hi - lo) * 1e-6
        yield a, b, names


def idle_by_span(events) -> Dict[str, float]:
    """The idle seconds of the traced stretch by the innermost program
    span open at each moment, longest first."""
    out: Dict[str, float] = {}
    for _, _, names in idle_pieces(events):
        for k, v in names.items():
            out[k] = out.get(k, 0.0) + v
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def unspanned_pct(by_span: Dict[str, float]) -> Optional[float]:
    """The share of idle time under no dotted program span."""
    total = sum(by_span.values())
    if total <= 0:
        return None
    return 100.0 * sum(v for k, v in by_span.items()
                       if not k.startswith(LEAF_PREFIXES)) / total


def long_gaps(events) -> List[List]:
    """Each idle gap of 1 ms or more: its ms and its ms by span."""
    out = [[(b - a) * 1e-3, {k: v * 1e3 for k, v in names.items()}]
           for a, b, names in idle_pieces(events) if b - a >= 1e3]
    return sorted(out, key=lambda g: -g[0])
