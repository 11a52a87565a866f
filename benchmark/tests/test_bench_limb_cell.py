"""The cell `limb-fibonacci-2e18.seq`: its circuit file is the statement
of the test helper `limb_fibonacci.py` (witness, constraints, public
columns, permutation and lookups equal at a small size), its config and
workload are as `BENCHMARK.json` names them, and the readers of its
lookup spans give a value with the spans and nothing without."""

import importlib.util
import json
import os
import random

import pytest

from conftest import BENCH
from registry import Registry

CELL = "limb-fibonacci-2e18.seq"
SEED = 2147483901


def helper():
    spec = importlib.util.spec_from_file_location(
        "limb_fibonacci_helper",
        os.path.join(BENCH, "tests", "limb_fibonacci.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("log2_rows,limb_bits,seed", [
    (4, 4, SEED), (5, 4, SEED + 1), (3, 8, SEED + 2)])
def test_the_circuit_is_the_helpers_statement(log2_rows, limb_bits, seed):
    mine = Registry().circuit("limb_fibonacci_logup").Statement.from_seed(
        log2_rows, seed, limb_bits=limb_bits)
    theirs = helper().Statement.from_seed(log2_rows, seed,
                                          limb_bits=limb_bits)
    assert mine.lookups() == theirs.lookups()
    rng = random.Random(seed)
    for a, b in zip(mine.traces(), theirs.traces()):
        assert (a.rows, a.columns, a.constraint_degree) == (
            b.rows, b.columns, b.constraint_degree)
        assert a.witness() == b.witness()
        assert a.public_columns() == b.public_columns()
        assert a.permutation() == b.permutation()
        for _ in range(8):
            e = [rng.randrange(1 << 254)
                 for _ in range(a.columns + len(a.public_columns()))]
            assert a.constraints(e) == b.constraints(e)


def test_the_config_and_workload():
    reg = Registry()
    man = reg.manifest()
    entry = next(w for w in man["workloads"] if w["name"] == CELL)
    assert entry["chips"] == 1
    wl = reg.workload(CELL)
    assert (wl["warmup_proves"], wl["traced_proves"]) == (1, 1)
    cfg = reg.config(wl["config"])
    st = reg.circuit(cfg["circuit"]).Statement(cfg["log2_rows"],
                                               a0=1, b0=2,
                                               **cfg["circuit_args"])
    traces = st.traces()
    assert [(t.columns, t.rows, t.columns * t.rows) for t in traces] == [
        (t["columns"], t["rows"], t["trace_cells"]) for t in cfg["traces"]]
    assert cfg["crs_points"] == max(t.columns * t.rows for t in traces) + 1
    assert [(lk["src_trace"], lk["src_cols"], lk["dst_trace"],
             lk["dst_cols"]) for lk in cfg["lookups"]] == [
        (s, list(sc), d, list(dc)) for s, sc, d, dc in st.lookups()]
    assert traces[1].rows == 1 << 16
    for m in man["per_layer"]:
        if m["name"] in ("lookup_s", "lookup_host_idle_s"):
            assert m["workloads"] == [CELL] and m["layer"] == "PIOPs"
    json.dumps(cfg)


def window(spans: dict, proves: int = 2) -> dict:
    return {"window": {"proves": proves, "seconds": 10.0, "spans": spans}}


def test_lookup_s_sums_the_lookup_spans_per_prove():
    read = Registry().reader("lookup_s")
    rec = window({"prove/lookup_multiplicities": 1.0,
                  "prove/lookup_commit": 0.5, "prove/lookup_piop": 2.0,
                  "prove/lookup_openings": 0.5, "prove/zerocheck": 9.0,
                  "set_inclusion/sumcheck": 1.5})
    assert read(rec) == pytest.approx(2.0)
    # a program without the two newer spans: what it has
    assert read(window({"prove/lookup_piop": 3.0})) == pytest.approx(1.5)


def test_lookup_s_is_none_without_the_spans():
    read = Registry().reader("lookup_s")
    assert read(window({"prove/zerocheck": 9.0})) is None
    assert read(window({"prove/lookup_piop": 3.0}, proves=0)) is None


def traced(idle: dict, busy: float = 1.0, proves: int = 2) -> dict:
    return {"traced": {"proves": proves, "busy_s": busy,
                       "idle_by_span": idle}}


def test_lookup_host_idle_s_reads_the_lookup_spans_idle():
    read = Registry().reader("lookup_host_idle_s")
    rec = traced({"prove/lookup_multiplicities": 1.2,
                  "prove/lookup_piop": 0.2, "set_inclusion/sumcheck": 0.4,
                  "set_inclusion/eq_table": 0.2, "msm/cd": 5.0,
                  "prove": 0.1, "between proves": 0.3})
    assert read(rec) == pytest.approx(1.0)


def test_lookup_host_idle_s_is_none_without_a_trace_or_spans():
    read = Registry().reader("lookup_host_idle_s")
    assert read({"window": {}}) is None
    assert read(traced({"prove/lookup_piop": 1.0}, busy=0.0)) is None
    assert read(traced({"msm/cd": 5.0, "prove": 0.1})) is None
