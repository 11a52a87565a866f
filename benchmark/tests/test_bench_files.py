"""Every part of the benchmark parses and is found by name, and a part
added as a file is found without editing any file."""

import json
import os
import re

from conftest import BENCH, ROOT, add_tiny_cell, copy_benchmark
from registry import Registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_has_the_contract_keys():
    man = manifest()
    assert set(man) == TOP
    assert man["command"] == ["python3", "benchmark/run.py"]
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}
    assert len(json.dumps(man)) < 64 * 1024


def test_every_part_parses_and_is_found_by_name():
    reg = Registry()
    man = reg.manifest()
    for c in man["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = reg.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        # the cells run on TorchEngine's defaults, so a later change to a
        # default is measured
        assert "engine" not in cfg
        assert reg.circuit(cfg["circuit"]).Statement
    for w in man["workloads"]:
        wl = reg.workload(w["name"])
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert reg.traffic(wl["traffic"])["what"]
        assert int(wl["traced_proves"]) >= 1
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(reg.reader(m["name"]))
    assert set(reg.names("metrics")) == {
        m["name"] for m in man["end_to_end"] + man["per_layer"]}
    assert set(reg.names("workloads")) == {w["name"] for w in man["workloads"]}
    peak = reg.peaks("NVIDIA H100 80GB HBM3")
    assert set(peak) == {"sms", "sm_clock_hz", "imads_per_sm_clock",
                         "imads_per_product", "source"}
    assert peak["sms"] == 132


def test_kernel_names_are_identifiers():
    names = Registry().kernel_names()
    assert len(names) >= 25
    assert all(re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", n) for n in names)


def test_a_cell_added_as_files_is_found(tmp_path):
    bench = copy_benchmark(tmp_path)
    before = {f: open(os.path.join(bench, f), "rb").read()
              for f in ("run.py", "harness.py", "registry.py")}
    add_tiny_cell(bench)
    reg = Registry(bench)
    assert "fib-cpu.seq" in reg.names("workloads")
    assert reg.workload("fib-cpu.seq")["config"] == "fib-cpu"
    assert reg.config("fib-cpu")["log2_rows"] == 3
    assert {m["name"] for m in reg.metrics_for("fib-cpu.seq", True)} == {
        m["name"] for m in reg.manifest()["per_layer"]}
    for f, data in before.items():
        assert open(os.path.join(bench, f), "rb").read() == data


def test_paths_hold_only_names_of_the_contract():
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
