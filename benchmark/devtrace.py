"""Reduces a profiler trace of the traced window to per-layer numbers.

Device events are the kernels, copies and fills that the profiler saw on
the card, as (start_ns, end_ns, name) on the host's clock.  Host spans are
(name, start_ns, end_ns), nested, recorded around the program's own
`phase` spans and the benchmark's calls.
"""

from __future__ import annotations

import bisect
from collections import defaultdict


def ident(name: str) -> str:
    """A kernel's name without `void`, template and argument lists:
    `void tree_up_kernel<2, false>(unsigned int const*, ...)` ->
    `tree_up_kernel`; `void at::native::(anonymous namespace)::f<...>(...)`
    -> `at::native::f`."""
    s = name.strip().replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    for stop in "<(":
        cut = s.find(stop)
        if cut > 0:
            s = s[:cut]
    return s.strip()


def device_events(kineto_events, t0: int, t1: int) -> tuple:
    """The device's events clipped to [t0, t1], as (start, end, ident),
    and the count of device events the trace held."""
    from torch.autograd import DeviceType

    out = []
    seen = 0
    for e in kineto_events:
        if e.device_type() != DeviceType.CUDA:
            continue
        seen += 1
        s, d = e.start_ns(), e.duration_ns()
        a, b = max(s, t0), min(s + d, t1)
        if b > a:
            out.append((a, b, ident(e.name())))
    return out, seen


def union(events) -> list:
    """Merged busy intervals [(start, end)], in order."""
    merged: list = []
    for s, e, _ in sorted(events):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def by_name(events) -> dict:
    """Seconds of device time by kernel name (overlaps counted twice)."""
    out: dict = defaultdict(float)
    for s, e, name in events:
        out[name] += (e - s) / 1e9
    return dict(out)


def segments(spans, t0: int, t1: int, outside: str) -> tuple:
    """The window cut into pieces, each labelled by the innermost host
    span that covers it; -> (starts, ends, labels)."""
    marks = []
    for name, s, e in spans:
        marks.append((s, 1, name))
        marks.append((e, 0, name))
    marks.sort()
    starts, ends, labels = [], [], []
    stack: list = []
    cur = t0
    for t, kind, name in marks:
        t = min(max(t, t0), t1)
        if t > cur:
            starts.append(cur)
            ends.append(t)
            labels.append(stack[-1] if stack else outside)
            cur = t
        if kind:
            stack.append(name)
        elif name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()
    if t1 > cur:
        starts.append(cur)
        ends.append(t1)
        labels.append(stack[-1] if stack else outside)
    return starts, ends, labels


def idle_by_span(merged, spans, t0: int, t1: int, outside: str) -> dict:
    """Seconds the device sat idle, by the host span that was running."""
    starts, ends, labels = segments(spans, t0, t1, outside)
    gaps = []
    cur = t0
    for s, e in merged:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    out: dict = defaultdict(float)
    for a, b in gaps:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(starts) and starts[i] < b:
            lo, hi = max(a, starts[i]), min(b, ends[i])
            if hi > lo:
                out[labels[i]] += (hi - lo) / 1e9
            i += 1
    return dict(out)


def top(d: dict, k: int = 10) -> list:
    return [[name, secs] for name, secs in
            sorted(d.items(), key=lambda kv: -kv[1])[:k]]


def busy_within(merged, intervals) -> float:
    """Seconds of the merged busy intervals that fall inside the given
    (start, end) host intervals, which do not overlap."""
    starts = [s for s, _ in merged]
    total = 0
    for a, b in intervals:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(merged) and merged[i][0] < b:
            lo, hi = max(a, merged[i][0]), min(b, merged[i][1])
            if hi > lo:
                total += hi - lo
            i += 1
    return total / 1e9
