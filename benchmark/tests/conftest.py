"""The benchmark's own tests (run on the CPU; the ones marked `cuda` need
the card and skip elsewhere):

    python -m pytest benchmark/tests -q

A tiny cell (`fib-cpu.seq`, 8 rows, every MSM on kernels C + D's plain
twins) runs through the whole harness in a temporary copy of the
benchmark's folder, so no file of the benchmark is edited; so does a tiny
statement of two traces and two lookups (`limbs-cpu.seq`,
`limb_fibonacci.py`).
"""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = "fib-cpu.seq"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere")


def copy_benchmark(dest) -> str:
    """A copy of the benchmark's folder and BENCHMARK.json under dest;
    -> the copy's benchmark folder."""
    bench = os.path.join(dest, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    return bench


def add_cell(bench: str, cfg: dict, workload: dict) -> str:
    """A configuration and a cell of it, added as files and manifest
    entries the way a later change adds them; -> the cell's name."""
    name = cfg["name"]
    cell = f"{name}.{workload['traffic']}"
    with open(os.path.join(bench, "configs", f"{name}.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "workloads", f"{cell}.json"), "w") as f:
        json.dump(dict(workload, config=name), f)
    path = os.path.join(os.path.dirname(bench), "BENCHMARK.json")
    with open(path) as f:
        man = json.load(f)
    man["configs"].append({"name": name, "source": "test",
                           "file": f"benchmark/configs/{name}.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": cell, "config": name,
                             "traffic": workload["traffic"], "chips": 1,
                             "why": "test"})
    with open(path, "w") as f:
        json.dump(man, f)
    return cell


def add_tiny_cell(bench: str, log2_rows: int = 3) -> None:
    """A CPU-sized configuration and cell of the Fibonacci circuit."""
    with open(os.path.join(bench, "configs", "fibonacci-2e16.json")) as f:
        cfg = json.load(f)
    cfg.update(name="fib-cpu", log2_rows=log2_rows,
               engine={"msm_small_chunks": 0})
    add_cell(bench, cfg, {"traffic": "seq", "warmup_proves": 0,
                          "traced_proves": 1,
                          "why": "the harness end to end on the CPU"})


def add_lookup_cell(bench: str, name: str = "limbs-cpu", log2_rows: int = 5,
                    limb_bits: int = 4, engine: dict | None = None) -> str:
    """A statement of two traces and two lookups (`limb_fibonacci.py`,
    copied in as a circuit file) and a cell of it; -> the cell's name.
    The CPU's (the default) sends every MSM to C + D's twins."""
    shutil.copy(os.path.join(BENCH, "tests", "limb_fibonacci.py"),
                os.path.join(bench, "circuits", "limb_fibonacci.py"))
    cfg = {"name": name, "source": "test", "circuit": "limb_fibonacci",
           "circuit_args": {"limb_bits": limb_bits}, "log2_rows": log2_rows,
           "reduced": [],
           "engine": {"msm_small_chunks": 0} if engine is None else engine}
    if not cfg["engine"]:
        del cfg["engine"]
    return add_cell(bench, cfg, {"traffic": "seq", "warmup_proves": 0,
                                 "traced_proves": 1,
                                 "why": "two traces and two lookups"})


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """The copy with the tiny cell: -> its Registry."""
    import torch

    from registry import Registry

    torch.set_num_threads(1)
    os.environ["QUILL_CRS_CACHE"] = "0"
    bench = copy_benchmark(tmp_path_factory.mktemp("bench"))
    add_tiny_cell(bench)
    return Registry(bench)


def run_tiny(reg, trace=False, fault=None, seed=1234567890123):
    import time

    import run

    return run.run(TINY, seed, 0.0, trace, device="cpu", t_start=time.time(),
                   fault=fault, registry=reg)


@pytest.fixture(scope="session")
def traced_result(tiny):
    return run_tiny(tiny, trace=True)
