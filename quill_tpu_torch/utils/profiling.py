"""Phase timing / metrics collection (SURVEY §5: the reference has no
tracing or metrics; this is the TPU build's observability layer).

Usage:
    from quill_tpu_torch.utils.profiling import metrics, phase
    with phase("commit/witness"):
        ...
    print(metrics.report())

Phases are host spans; `torch.profiler` (chip_smoke.py --profile) traces
the device.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict

logger = logging.getLogger("quill_tpu")


class Metrics:
    def __init__(self):
        self.times: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def add(self, name: str, seconds: float) -> None:
        self.times[name] += seconds
        self.counts[name] += 1

    def incr(self, name: str, n: int = 1) -> None:
        self.counts[name] += n

    def reset(self) -> None:
        self.times.clear()
        self.counts.clear()

    def report(self) -> dict:
        return {
            name: {"total_sec": round(t, 4), "count": self.counts[name]}
            for name, t in sorted(self.times.items())
        }


metrics = Metrics()


@contextlib.contextmanager
def phase(name: str):
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        metrics.add(name, dt)
        logger.debug("phase %s: %.4fs", name, dt)
