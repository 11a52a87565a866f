"""Benchmark of quill_tpu_torch on one NVIDIA card: whole HyperPlonk
proves, timed per proof, one cell and one seed a run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell (`workloads/<cell>.json`) names a
configuration and a traffic mix.  Set-up builds or loads the program's
kernels, makes the CRS from the seed's tau, the statement and its witness,
preprocesses the circuit and runs the cell's warm-up proves.  Then proves
run back to back, one in flight, while less than `--seconds` have passed.
With `--trace 1` the same window runs untraced first, then the cell's
traced proves run under the profiler twice: as the window runs them (the
device's busy and idle time, time by kernel), then with the engine's
sumchecks and MSMs each between two synchronises (their time).  Once the windows have closed, the program's state is freed and
the plain reference (`reference/`) checks every proof.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones, each read by `metrics/<name>.py`),
`device`, `msm_routes` (the window's MSMs by the route the engine
took), with `--trace 1` `breakdown`, and last `checks`, the numbers
compared with their limits, which also end standard error.

Exit codes: 2 without a CUDA card (or fewer than the cell asks for) or for
an unknown cell, 3 if jax, jaxlib, flax or quill_tpu was imported.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "quill_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: quill_tpu_torch is not quill_tpu."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def hygiene() -> None:
    """The program's switches from the environment cleared, the CRS made
    in every run (no `build/crs/` cache), and every build or kernel cache
    at a fixed path inside the checkout."""
    for k in [k for k in os.environ if k.startswith("QUILL_")]:
        del os.environ[k]
    os.environ["QUILL_CRS_CACHE"] = "0"
    cache = os.path.join(ROOT, "build", "benchmark")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not available"


def read_metrics(reg, cell: str, record: dict, traced: bool) -> dict:
    out = {}
    for m in reg.metrics_for(cell, traced):
        value = reg.reader(m["name"])(record)
        if value is None:
            print(f"metric {m['name']}: nothing to read", file=sys.stderr)
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", chips: int = 1, t_start: float = T_START,
        fault=None, registry=None) -> dict:
    """One run of a cell; -> the result line as a dict.  Set-up counts
    from `t_start`.  `fault` (the tests and the control only) breaks the
    timed path: `faults.plant(fault, cell)`."""
    import torch

    from harness import Cell

    cell = Cell(cell_name, seed, device, registry)
    reg = cell.reg
    cell.set_up()
    if fault is not None:
        import faults

        faults.plant(fault, cell)
    record = {"setup": dict(cell.setup, setup_s=time.time() - t_start)}
    print("setup: " + json.dumps({k: round(v, 4) for k, v in
                                  record["setup"].items()}), flush=True)
    record["window"] = cell.window(seconds)
    w = record["window"]
    print(f"window: {w['proves']} proves in {w['seconds']:.3f}s, each "
          f"{[round(x, 3) for x in w['prove_times']]}; MSMs by route "
          f"{w['routes']}", flush=True)
    if trace:
        n = int(cell.workload["traced_proves"])
        traced = cell.traced_window(n)
        record["traced"] = traced
        record["timed"] = cell.timed_window(n)
        untraced = w["seconds"] / max(1, w["proves"])
        per = traced["seconds"] / max(1, traced["proves"])
        print(f"tracing overhead: traced prove_s {per:.4f} - untraced "
              f"prove_s {untraced:.4f} = {per - untraced:.4f} s "
              f"({traced['device_events']} of {traced['trace_events']} "
              f"device events in the window, reduced in "
              f"{traced['reduce_s']:.2f}s)", flush=True)
        tm = record["timed"]
        print(f"timed pass: {tm['proves']} proves in {tm['seconds']:.3f}s; "
              f"MSMs {len(tm['msm_points'])} in {tm['msm_s']:.4f}s, the "
              f"device busy {tm['msm_device_s']:.4f}s of it; sumchecks "
              f"{tm['sumcheck_calls']} in {tm['sumcheck_s']:.4f}s", flush=True)
    kind = torch.cuda.get_device_name(0) if device == "cuda" else device
    record["peaks"] = reg.peaks(kind)
    record["kernel_names"] = reg.kernel_names()
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
           "count": chips}
    if device == "cuda":
        dev["memory_peak_bytes"] = max(cell.setup.get("setup_peak_bytes", 0),
                                       torch.cuda.max_memory_allocated(),
                                       w.get("peak_bytes", 0))
    metrics = read_metrics(reg, cell_name, record, trace)
    result = {"correct": False, "attempted": 0, "failed": 0,
              "metrics": metrics, "device": dev, "msm_routes": w["routes"]}
    if trace:
        import devtrace

        t = record["traced"]
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["seconds"]
        result["breakdown"] = {
            "device_ops": devtrace.top(t["device_s_by_name"]),
            "idle_gaps": devtrace.top(t["idle_by_span"])}
    # every proof the run made is judged: the warm-up proves count too
    attempted = (cell.setup["warmup_proves"] + w["proves"]
                 + (2 * record["traced"]["proves"] if trace else 0))
    cell.release()
    checks = cell.judge()
    print(f"reference: {len(cell.proofs)} distinct proofs checked in "
          f"{cell.reference_s:.3f}s", flush=True)
    rejected = checks["proofs_rejected"]["value"]
    result["attempted"] = attempted
    result["failed"] = cell.failed + rejected
    result["correct"] = (attempted > 0 and cell.failed == 0
                         and all(c["value"] <= c["limit"]
                                 for c in checks.values()))
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    hygiene()
    sys.path.insert(0, BENCH)
    from registry import Missing, Registry

    reg = Registry()
    try:
        entry = next(c for c in reg.manifest()["workloads"]
                     if c["name"] == args.workload)
        reg.workload(args.workload)
    except (StopIteration, Missing):
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 chips=chips)
    print(card_line(), flush=True)
    found = forbidden_modules()
    if found:
        print(f"loaded in the process: {found}; the run is void",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
