"""Per-phase timing instrumentation for the training loop.

A copy of the JAX package's ``PhaseTimer`` (its wall-clock buckets;
the byte counters and metric-registry folding are not ported, as no
port code feeds them). The trainer's buckets are
``sample`` (host sampling done on the loop thread: inline sampling),
``stall`` (time the loop thread waited on the sampler pipeline for a
batch that was not ready) and ``dispatch`` (the step: host-to-device
copies, then the enqueue of forward, backward and the optimizer
update). Kernels run asynchronously, so device time shows up in
whichever host call next waits for the card; the epoch wall clock is
the throughput number.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class PhaseTimer:
    """Accumulating named wall-clock buckets."""

    def __init__(self) -> None:
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def reset(self) -> None:
        self.total.clear()
        self.count.clear()

    def as_dict(self) -> Dict[str, float]:
        """Seconds per bucket."""
        return dict(self.total)
