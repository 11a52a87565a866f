"""The benchmark's own tests (run on the CPU; the ones marked `cuda` need
the card and skip elsewhere):

    python -m pytest benchmark/tests -q

A tiny cell (`fib-cpu.seq`, 8 rows, every MSM on kernels C + D's plain
twins) runs through the whole harness in a temporary copy of the
benchmark's folder, so no file of the benchmark is edited.
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


def add_tiny_cell(bench: str, log2_rows: int = 3) -> None:
    """A CPU-sized configuration and cell, added as files and manifest
    entries the way a later change adds one."""
    with open(os.path.join(bench, "configs", "fibonacci-2e16.json")) as f:
        cfg = json.load(f)
    cfg.update(name="fib-cpu", log2_rows=log2_rows,
               engine={"msm_small_chunks": 0})
    with open(os.path.join(bench, "configs", "fib-cpu.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "workloads", f"{TINY}.json"), "w") as f:
        json.dump({"config": "fib-cpu", "traffic": "seq",
                   "warmup_proves": 0, "traced_proves": 1,
                   "why": "the harness end to end on the CPU"}, f)
    path = os.path.join(os.path.dirname(bench), "BENCHMARK.json")
    with open(path) as f:
        man = json.load(f)
    man["configs"].append({"name": "fib-cpu", "source": "test",
                           "file": "benchmark/configs/fib-cpu.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": TINY, "config": "fib-cpu",
                             "traffic": "seq", "chips": 1, "why": "test"})
    with open(path, "w") as f:
        json.dump(man, f)


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
