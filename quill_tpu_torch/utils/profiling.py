"""The port's host spans: seconds by span name always, and intervals with
their parents while a recording is open.

Usage:
    from quill_tpu_torch.utils.profiling import metrics, phase, recording
    with phase("prove/zerocheck"):
        ...
    print(metrics.report())            # seconds and calls by span name

    with recording() as rec:           # off unless opened
        hp.prove(...)
    rec.spans                          # Span(name, id, parent, start_ns, end_ns)
    rec.self_ns()                      # span id -> time in no child span

`phase` adds each span's host seconds into `metrics.times`.  While a
`recording()` is open it also keeps the span, with the id of the span it
opened in, on `time.time_ns()`: the clock the traced run of
`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace 1` clips the profiler's device events against, so a recorded
span compares directly with a device event.  Spans nest on the one
thread a prove runs on; a span opened at the top is a root, and its id
is the identifier of the prove (or the serialisation) it holds
(`Recording.roots`).  With no recording open a span costs one branch
more than the seconds alone.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import NamedTuple


class Metrics:
    def __init__(self):
        self.times: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def add(self, name: str, seconds: float) -> None:
        self.times[name] += seconds
        self.counts[name] += 1

    def reset(self) -> None:
        self.times.clear()
        self.counts.clear()

    def report(self) -> dict:
        return {
            name: {"total_sec": round(t, 4), "count": self.counts[name]}
            for name, t in sorted(self.times.items())
        }


metrics = Metrics()


class Span(NamedTuple):
    name: str
    id: int
    parent: int       # -1 for a span opened at the top
    start_ns: int     # time.time_ns()
    end_ns: int


class Recording:
    """The spans closed while it was open, in the order they closed."""

    def __init__(self):
        self.spans: list[Span] = []
        self._open: list[tuple] = []   # (name, id, parent, start_ns)

    def _begin(self, name: str, t: int) -> tuple:
        parent = self._open[-1][1] if self._open else -1
        entry = (name, len(self.spans) + len(self._open), parent, t)
        self._open.append(entry)
        return entry

    def _end(self, entry: tuple, t: int) -> None:
        self._open.remove(entry)
        self.spans.append(Span(*entry, t))

    def self_ns(self) -> dict[int, int]:
        """Span id -> its duration minus the part its child spans cover
        (children run on the span's thread, inside it, one at a time)."""
        out = {s.id: s.end_ns - s.start_ns for s in self.spans}
        for s in self.spans:
            if s.parent in out:
                out[s.parent] -= s.end_ns - s.start_ns
        return out

    def roots(self) -> dict[int, int]:
        """Span id -> the id of its outermost ancestor (itself at the
        top): the prove it belongs to."""
        out: dict[int, int] = {}
        for s in sorted(self.spans, key=lambda s: s.id):
            out[s.id] = out.get(s.parent, s.id)
        return out


_recording: Recording | None = None


@contextlib.contextmanager
def recording():
    """Keep every span closed inside the block; -> the Recording."""
    global _recording
    outer, rec = _recording, Recording()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = outer


@contextlib.contextmanager
def phase(name: str):
    rec = _recording
    t0 = time.time_ns()
    if rec is not None:
        entry = rec._begin(name, t0)
    try:
        yield
    finally:
        t1 = time.time_ns()
        metrics.add(name, (t1 - t0) / 1e9)
        if rec is not None:
            rec._end(entry, t1)
