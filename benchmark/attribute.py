"""Device time and host syncs by the program span that caused them, and
the cost of the program's span recorder.

Each device event (kernel, copy, fill) of a traced window is given the
innermost host span open when its launch ran: the runtime or driver call
that carries the same correlation id.  A host sync is a runtime or driver
call that blocks the host until the device drains, counted by the
innermost span open at the call.  Spans are (name, start_ns, end_ns) on
`time.time_ns()`, the program's recorded spans (`quill_tpu_torch.utils.
profiling.recording`) and the prove spans around them.

    python3 benchmark/attribute.py --workload <cell> --seed <n> \
        [--proves K] [--cost N] [--out FILE]

sets a cell up as `run.py` does, then with `--cost N` proves N times with
the recorder off and N times with it on, in turns (no profiler: the
recorder's own cost), and traces K proves under the profiler (CUDA
activity, as the traced run) with the recorder on.  Last line of standard
output: one JSON object (also written to FILE): the device's idle time,
device time and plain-torch device time, and host syncs, each by span;
the share of device time whose launch was not found; host self time by
span; spans a prove; and the recorder's cost.  It reads what `run.py
--trace 1` cannot yet: `device_s_by_span` and `syncs_by_span`.
"""

from __future__ import annotations

import bisect
import contextlib
import statistics
from collections import Counter, defaultdict

import devtrace

# runtime and driver calls that return only when the device has drained
# (a stream, the device or an event), or that copy synchronously
SYNCS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
    "cuMemcpy", "cuMemcpyDtoH", "cuMemcpyDtoH_v2", "cuMemcpyHtoD",
    "cuMemcpyHtoD_v2", "cuMemcpyDtoD", "cuMemcpyDtoD_v2",
})
HOST_CALLS = ("cuda_runtime", "cuda_driver")


def from_kineto(kineto_events, t0: int, t1: int) -> tuple:
    """-> (device events (start, end, ident, correlation) clipped to
    [t0, t1], as `devtrace.device_events` clips them; host calls (start,
    end, name, correlation, kind) of the runtime and the driver)."""
    from torch.autograd import DeviceType

    dev, calls = [], []
    for e in kineto_events:
        if e.device_type() == DeviceType.CUDA:
            s, d = e.start_ns(), e.duration_ns()
            a, b = max(s, t0), min(s + d, t1)
            if b > a:
                dev.append((a, b, devtrace.ident(e.name()),
                            e.correlation_id()))
        else:
            kind = call_kind(e)
            if kind:
                s = e.start_ns()
                calls.append((s, s + e.duration_ns(), e.name(),
                              e.correlation_id(), kind))
    return dev, calls


def call_kind(e) -> str | None:
    """`cuda_runtime`, `cuda_driver` or None for a host-side event: its
    activity type where PyTorch gives one (2.13 does, 2.11 does not), else
    its name (`cudaLaunchKernel`, `cuLaunchKernel`)."""
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        return kind if kind in HOST_CALLS else None
    name = e.name()
    if name.startswith("cuda"):
        return "cuda_runtime"
    if len(name) > 2 and name.startswith("cu") and name[2].isupper():
        return "cuda_driver"
    return None


class _Labels:
    """The innermost span open at a time, from `devtrace.segments`."""

    def __init__(self, spans, t0: int, t1: int, outside: str):
        self.starts, _, self.labels = devtrace.segments(spans, t0, t1,
                                                        outside)
        self.t0, self.t1, self.outside = t0, t1, outside

    def at(self, t: int) -> str:
        if not self.starts or not self.t0 <= t < self.t1:
            return self.outside
        return self.labels[bisect.bisect_right(self.starts, t) - 1]


def attribute(dev, calls, spans, t0: int, t1: int, outside: str) -> dict:
    """Device seconds by the span open at their launch (and by kernel name
    within it), the device seconds whose launch is not among the calls,
    and host syncs by span.  A driver call inside a runtime call is the
    runtime's own work: only the runtime call counts as a sync."""
    labels = _Labels(spans, t0, t1, outside)
    launch: dict = {}
    for s, _, _, corr, kind in calls:
        if corr not in launch or kind == "cuda_runtime":
            launch[corr] = s
    by_span: dict = defaultdict(float)
    by_span_name: dict = defaultdict(lambda: defaultdict(float))
    unmatched = total = 0.0
    for a, b, name, corr in dev:
        secs = (b - a) / 1e9
        total += secs
        t = launch.get(corr)
        if t is None:
            unmatched += secs
            continue
        label = labels.at(t)
        by_span[label] += secs
        by_span_name[label][name] += secs
    runtime = sorted((s, e) for s, e, _, _, k in calls
                     if k == "cuda_runtime")
    r_starts = [s for s, _ in runtime]
    syncs: dict = defaultdict(int)
    for s, _, name, _, kind in calls:
        if name not in SYNCS or not t0 <= s < t1:
            continue
        if kind != "cuda_runtime":
            i = bisect.bisect_right(r_starts, s) - 1
            if i >= 0 and runtime[i][1] >= s:
                continue
        syncs[labels.at(s)] += 1
    return {"device_s": total, "unmatched_s": unmatched,
            "device_s_by_span": dict(by_span),
            "device_s_by_span_name": {k: dict(v)
                                      for k, v in by_span_name.items()},
            "syncs_by_span": dict(syncs)}


def torch_op_s(by_span_name: dict, kernel_names, prefix: str = "") -> float:
    """Device seconds of names outside the hand-written kernels' lists,
    under spans whose label starts with `prefix`."""
    return sum(s for label, names in by_span_name.items()
               if label.startswith(prefix)
               for name, s in names.items() if name not in kernel_names)


def self_s_by_name(rec) -> dict:
    """Host seconds by span name, each span's time in no child span."""
    own = rec.self_ns()
    out: dict = defaultdict(float)
    for s in rec.spans:
        out[s.name] += own[s.id] / 1e9
    return dict(out)


def recorder_cost(cell, n: int) -> dict:
    """n proves with the recorder off and n with it on, in turns, no
    profiler: each side's prove times and median, and spans a prove."""
    import time

    from quill_tpu_torch.utils import profiling

    off, on, spans = [], [], []
    for _ in range(n):
        t = time.perf_counter()
        cell._one()
        off.append(time.perf_counter() - t)
        with profiling.recording() as rec:
            t = time.perf_counter()
            cell._one()
            on.append(time.perf_counter() - t)
        spans.append(len(rec.spans))
    return {"off_s": off, "on_s": on, "off_median_s": statistics.median(off),
            "on_median_s": statistics.median(on),
            "spans_a_prove": statistics.median(spans),
            "span_off_ns": span_ns(False), "span_on_ns": span_ns(True)}


def span_ns(on: bool, n: int = 200_000) -> float:
    """Host ns an empty span takes, with the recorder off or on."""
    import time

    from quill_tpu_torch.utils import profiling

    with profiling.recording() if on else contextlib.nullcontext():
        t = time.perf_counter_ns()
        for _ in range(n):
            with profiling.phase("attribute/empty"):
                pass
        t = time.perf_counter_ns() - t
    profiling.metrics.times.pop("attribute/empty", None)
    profiling.metrics.counts.pop("attribute/empty", None)
    return t / n


def traced(cell, proves: int, kernel_names) -> dict:
    """`proves` proves under the profiler as the traced run takes them,
    with the recorder on: everything this module attributes, per prove
    where it is time or a count."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from harness import _sync
    from quill_tpu_torch.utils import profiling

    outer: list = []
    acts = [ProfilerActivity.CUDA if cell.device == "cuda"
            else ProfilerActivity.CPU]
    with profiling.recording() as rec, profile(activities=acts) as prof:
        _sync(cell.device)
        t0 = time.time_ns()
        for _ in range(proves):
            cell._one(outer)
        _sync(cell.device)
        t1 = time.time_ns()
    dev, calls = from_kineto(prof.profiler.kineto_results.events(), t0, t1)
    spans = outer + [(s.name, s.start_ns, s.end_ns) for s in rec.spans]
    out = attribute(dev, calls, spans, t0, t1, "between proves")
    merged = devtrace.union([(a, b, n) for a, b, n, _ in dev])
    idle = devtrace.idle_by_span(merged, spans, t0, t1, "between proves")
    per = 1.0 / proves
    by_name = out.pop("device_s_by_span_name")
    msm_idle = [s for k, s in idle.items() if k.startswith("msm/")]
    return {
        "proves": proves, "seconds": (t1 - t0) / 1e9 * per,
        "busy_s": sum(e - s for s, e in merged) / 1e9 * per,
        "device_events": len(dev), "host_calls": len(calls),
        "host_calls_by_name": dict(Counter(c[2] for c in calls)
                                   .most_common(15)),
        "spans_a_prove": len(rec.spans) * per,
        "unmatched_pct": (100.0 * out["unmatched_s"] / out["device_s"]
                          if out["device_s"] else None),
        "unspanned_idle_s": (idle.get("prove", 0.0)
                             + idle.get("between proves", 0.0)) * per,
        "msm_host_idle_s": sum(msm_idle) * per,
        "msm_torch_op_s": torch_op_s(by_name, kernel_names, "msm/") * per,
        "torch_op_s": torch_op_s(by_name, kernel_names) * per,
        "host_syncs": sum(out["syncs_by_span"].values()) * per,
        "idle_by_span": _per(idle, per),
        "device_s_by_span": _per(out["device_s_by_span"], per),
        "torch_op_s_by_span": _per({k: torch_op_s({k: v}, kernel_names)
                                    for k, v in by_name.items()}, per),
        "syncs_by_span": _per(out["syncs_by_span"], per),
        "host_self_s_by_span": _per(self_s_by_name(rec), per),
        "top_torch_ops_by_span": {
            k: devtrace.top({n: s * per for n, s in v.items()
                             if n not in kernel_names}, 5)
            for k, v in by_name.items()},
    }


def _per(d: dict, per: float) -> dict:
    return dict(sorted(((k, v * per) for k, v in d.items()),
                       key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import sys
    import time

    t_start = time.time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--proves", type=int, default=1)
    ap.add_argument("--cost", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    bench = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [bench, os.path.dirname(bench)]
    import run

    run.hygiene()
    import torch

    from harness import Cell
    from registry import Registry

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = Cell(args.workload, args.seed, "cuda")
    cell.set_up()
    out = {"workload": args.workload, "seed": args.seed,
           "card": run.card_line(), "setup_s": time.time() - t_start}
    if args.cost:
        out["cost"] = recorder_cost(cell, args.cost)
    if args.proves:
        out["traced"] = traced(cell, args.proves, Registry().kernel_names())
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
