"""The harness end to end on the CPU at 8 rows: the last line's keys, the
checks last, and `correct` true; the 8-row proof of the source's boundary
values on seed 0's CRS is the repository's pinned proof."""

import hashlib

import pytest

from conftest import TINY, run_tiny

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "msm_routes", "checks"}
GOLDEN_8_ROWS = ("4559f7026c1b53bd6bac0762010b7ee926a27c94a43b7f91cc2e3e34"
                 "f3be4d22")


def test_untraced_line(tiny):
    res = run_tiny(tiny)
    assert set(res) == RESULT_KEYS
    assert list(res)[-1] == "checks"
    assert res["correct"] is True
    assert res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"prove_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert res["checks"] == {"proofs_rejected": {"value": 0, "limit": 0},
                             "checks_failed": {"value": 0, "limit": 0}}
    # the tiny cell's one option sends every MSM to C + D
    assert res["msm_routes"]["cd"] > 0 and res["msm_routes"]["small"] == 0


def test_traced_line(traced_result):
    res = traced_result
    assert set(res) == RESULT_KEYS | {"breakdown"}
    assert list(res)[-1] == "checks"
    # the window's prove, the traced pass's and the timed pass's
    assert res["correct"] is True and res["attempted"] == 3
    # on the CPU the profiler sees no device: the device metrics are left
    # out, never written as 0
    assert {"preprocess_s", "crs_s", "sumcheck_s", "msm_s",
            "piop_s", "pcs_open_s"} <= set(res["metrics"])
    assert not {"csrc_kernel_s", "torch_op_s", "device_idle_pct",
                "msm_roofline"} & set(res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_pinned_8_row_proof(tiny):
    from harness import Cell, tau_from_seed
    from reference.verify import Verifier

    cell = Cell(TINY, 0, "cpu", tiny)
    cell.statement = type(cell.statement)(3, 0, 1)
    cell.tau = tau_from_seed(0)
    cell.set_up()
    data = cell.prove()
    assert hashlib.sha256(data).hexdigest() == GOLDEN_8_ROWS
    assert Verifier(cell.statement, cell.tau).check(data) == []


@pytest.mark.cuda
def test_a_card_run_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import subprocess
    import sys

    from conftest import ROOT

    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "fibonacci-2e16.seq", "--seed", "2147483711", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
