"""Finds the benchmark's parts by name: cells, configurations, traffic
mixes, circuits, metric readers, the kernel-name lists and the table of
peaks.  Each lives in a file of its own under the benchmark's folder, so a
new one is a new file and an entry in `BENCHMARK.json`, never an edit.

    workloads/<cell>.json    config, traffic, warm-up and traced proves
    configs/<config>.json    circuit, rows, seed use; an optional `engine`
                             holds TorchEngine options (the cells' have
                             none, so they run on its defaults), an
                             optional `circuit_args` more keyword
                             arguments of the circuit's `from_seed`
    traffic/<traffic>.json   the mix (`seq`: proves back to back, one in
                             flight, a loop with no parameters)
    circuits/<circuit>.py    a `Statement` class (below)
    metrics/<metric>.py      `read(record) -> float | None`
    kernels/*.txt            names of the program's hand-written kernels
    peaks.json               the card's peak rates, by device name

A circuit module's `Statement.from_seed(log2_rows, seed, **circuit_args)`
makes the statement.  A statement of one trace has the trace's members:
`rows`, `columns`, `constraint_degree`, `witness()` (the columns as lists
of ints), `public_columns()`, `constraints(e)` (the zero check's
expressions at column values e, in the order the program batches them),
`permutation()` (the id and copy maps) and `program_circuit()` (the same
circuit built by the program's frontend).  A statement of several traces
offers `traces()`, a list of such per-trace objects in the program's
order, and may offer `lookups()`, the cross-table lookups as plain tuples
(src_trace, src_cols, dst_trace, dst_cols): every row tuple of the source
columns is among the destination's.  Then it also offers
`program_lookups()`, the program's `CrossTableLookup` objects for them.
`program_circuit` and `program_lookups` are the only members that import
the program; the reference reads the rest.  A statement without
`traces()` is its own single trace (`reference/verify.py: traces_of`).
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


class Missing(LookupError):
    """A name that has no file."""


def _json(path: str) -> dict:
    if not os.path.isfile(path):
        raise Missing(path)
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    if not os.path.isfile(path):
        raise Missing(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Registry:
    def __init__(self, bench: str = BENCH, manifest_path: str | None = None):
        self.bench = bench
        self.manifest_path = manifest_path or os.path.join(
            os.path.dirname(bench), "BENCHMARK.json")

    def manifest(self) -> dict:
        return _json(self.manifest_path)

    def workload(self, name: str) -> dict:
        return _json(os.path.join(self.bench, "workloads", f"{name}.json"))

    def config(self, name: str) -> dict:
        return _json(os.path.join(self.bench, "configs", f"{name}.json"))

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(self.bench, "traffic", f"{name}.json"))

    def circuit(self, name: str):
        return _module(os.path.join(self.bench, "circuits", f"{name}.py"),
                       f"bench_circuit_{name}")

    def reader(self, name: str):
        return _module(os.path.join(self.bench, "metrics", f"{name}.py"),
                       f"bench_metric_{name}").read

    def names(self, kind: str) -> list[str]:
        """The names a folder holds (files with the folder's suffix)."""
        suffix = {"workloads": ".json", "configs": ".json",
                  "traffic": ".json", "circuits": ".py",
                  "metrics": ".py"}[kind]
        folder = os.path.join(self.bench, kind)
        return sorted(f[:-len(suffix)] for f in os.listdir(folder)
                      if f.endswith(suffix) and not f.startswith("_"))

    def kernel_names(self) -> set[str]:
        folder = os.path.join(self.bench, "kernels")
        out: set[str] = set()
        for f in sorted(os.listdir(folder)):
            if f.endswith(".txt"):
                with open(os.path.join(folder, f)) as fh:
                    out.update(line.split("#")[0].strip() for line in fh)
        out.discard("")
        return out

    def peaks(self, kind: str) -> dict | None:
        return _json(os.path.join(self.bench, "peaks.json")).get(kind)

    def metrics_for(self, cell: str, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with `traced` its per-layer
        ones: those that list the cell, or list no cells."""
        entries = self.manifest()["per_layer" if traced else "end_to_end"]
        return [m for m in entries if cell in m.get("workloads", [cell])]
