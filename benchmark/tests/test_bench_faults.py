"""Each fault the cells can have, planted in the timed path of the tiny
cell on the CPU, makes `correct` come out false; the CPU run skips only
the harness's look for a card."""

import pytest

from conftest import run_tiny
from faults import FAULTS


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny, fault):
    res = run_tiny(tiny, fault=fault)
    assert res["correct"] is False
    assert res["failed"] >= 1
    assert res["checks"]["proofs_rejected"]["value"] >= 1
