"""A statement of two traces joined by two cross-table lookups
(`limb_fibonacci.py`: 2^5 rows of Fibonacci over u8 in 4-bit limbs and a
2^4-row range table), added as files, runs through the harness on the
CPU, and the reference rejects altered proofs of it and an honest proof
of a limb outside the table."""

import os

import pytest

from conftest import ROOT, add_lookup_cell, copy_benchmark
from reference import verify
from registry import Registry

SEED = 3141592653589
UNEDITED = ("run.py", "harness.py", "registry.py", "reference/verify.py")


@pytest.fixture(scope="module")
def lookup_reg(tmp_path_factory):
    """A copy of the benchmark with the lookup cell added as files, and
    the bytes of the harness's files before it was added."""
    import torch

    torch.set_num_threads(1)
    os.environ["QUILL_CRS_CACHE"] = "0"
    bench = copy_benchmark(tmp_path_factory.mktemp("bench"))
    before = {f: open(os.path.join(bench, f), "rb").read() for f in UNEDITED}
    cell = add_lookup_cell(bench)
    return Registry(bench), cell, before


def test_the_statement(lookup_reg):
    reg, cell, _ = lookup_reg
    st = reg.circuit("limb_fibonacci").Statement.from_seed(5, SEED,
                                                            limb_bits=4)
    limbs, table = st.traces()
    assert (limbs.rows, limbs.columns, table.rows, table.columns) == (
        32, 8, 16, 2)
    for tr in (limbs, table):
        w = tr.witness()
        pub = tr.public_columns()
        for row in range(tr.rows):
            e = [c[row] for c in w] + [c[row] for c in pub]
            assert not any(tr.constraints(e)), (tr, row)
        ids, perm = tr.permutation()
        flat = [x for c in w for x in c]
        assert sorted(perm) == ids
        for i, j in zip(ids, perm):
            assert flat[i - 1] == flat[j - 1]
    w, values = limbs.witness(), set(table.witness()[0])
    for src, src_cols, dst, dst_cols in st.lookups():
        assert (src, dst, dst_cols) == (0, 1, [0])
        assert set(w[src_cols[0]]) <= values
    mult = verify.multiplicities([w[5]], [table.witness()[0]])
    assert sum(mult) == 32


def test_a_multi_trace_cell_added_as_files_runs(lookup_reg):
    import time

    import run

    reg, cell, before = lookup_reg
    res = run.run(cell, SEED, 0.0, False, device="cpu", t_start=time.time(),
                  registry=reg)
    assert res["correct"] is True and res["attempted"] == 1
    assert res["checks"] == {"proofs_rejected": {"value": 0, "limit": 0},
                             "checks_failed": {"value": 0, "limit": 0}}
    for f, data in before.items():
        assert open(os.path.join(reg.bench, f), "rb").read() == data
    # nothing of the repository's own benchmark was touched either
    assert not os.path.exists(os.path.join(ROOT, "benchmark", "circuits",
                                           "limb_fibonacci.py"))


@pytest.fixture(scope="module")
def proof(lookup_reg):
    from harness import Cell

    reg, cell_name, _ = lookup_reg
    cell = Cell(cell_name, SEED, "cpu", reg)
    cell.set_up()
    data = cell.prove()
    cell.release()
    return data, verify.Verifier(cell.statement, cell.tau)


def lookup_section(data: bytes) -> int:
    """The offset of the lookup section: past the witness commitments and
    the traces' proofs."""
    rd = verify.Reader(data)
    n = rd.usize()
    for _ in range(n):
        rd.g1()
    for _ in range(rd.usize()):
        verify.read_trace(rd)
    return rd.pos


def test_accepts_the_proof(proof):
    data, v = proof
    assert v.check(data) == []
    assert len(verify.parse(data, 2, 2)["lookups"]) == 2


@pytest.mark.parametrize("at", [0, 8, 70, 200, 777, 1500, 3000, 5000, -600,
                                -1])
def test_rejects_an_altered_byte_in_the_lookup_section(proof, at):
    data, v = proof
    start = lookup_section(data)
    where = start + at if at >= 0 else len(data) + at
    assert start <= where < len(data)
    bad = bytearray(data)
    bad[where] ^= 1
    assert v.check(bytes(bad))


def test_rejects_the_multiplicities_evaluation_plus_one(proof):
    data, v = proof
    # the last opening is the multiplicities': point, evaluation, S
    # commitment (64 bytes), then four KZG openings of 128 bytes
    at = len(data) - 4 * 128 - 64 - 32
    value = int.from_bytes(data[at:at + 32], "little")
    bad = data[:at] + ((value + 1) % verify.R).to_bytes(32, "little") + \
        data[at + 32:]
    failed = v.check(bad)
    assert "lookup 1: right sumcheck: final evaluation" in failed
    assert any(f.startswith("lookup 1: multiplicities") for f in failed)


def test_rejects_a_limb_outside_the_table(lookup_reg):
    """An honest prover of a witness whose last new low limb is outside
    the table, with every constraint met: the carry is moved into the
    limb (or out of it), so only the lookup is broken."""
    from harness import Cell

    reg, cell_name, _ = lookup_reg
    cell = Cell(cell_name, SEED + 1, "cpu", reg)
    limbs = cell.statement.traces()[0]
    honest = limbs.witness

    def witness():
        w = honest()
        last, base = limbs.rows - 1, limbs.base
        s = w[0][last] + w[4][last]
        carry = 0 if s >= base else 1
        w[5][last] = (s - carry * base) % verify.R
        w[7][last] = (w[2][last] + w[6][last] + carry) % base
        assert not 0 <= w[5][last] < base
        return w

    limbs.witness = witness
    cell.set_up()
    data = cell.prove()
    cell.release()
    failed = verify.Verifier(cell.statement, cell.tau).check(data)
    assert failed == ["lookup 0: log-derivative sums differ"]


def test_rejects_another_seeds_statement(proof, lookup_reg):
    data, v = proof
    reg = lookup_reg[0]
    other = reg.circuit("limb_fibonacci").Statement.from_seed(5, SEED + 7,
                                                               limb_bits=4)
    failed = verify.Verifier(other, v.tau).check(data)
    assert "trace 0: witness commitment" in failed
