"""The reference's parts on their own: BLAKE3's published vector, the
curve, the circuit's plain description, and rejections of altered
proofs."""

import pytest

from conftest import TINY
from reference import blake3, curve, verify
from registry import Registry


def test_blake3_published_vector():
    assert blake3.digest(b"").hex() == (
        "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262")


def test_curve():
    assert curve.on_curve(1, 2)
    assert curve.is_infinity(curve.mul(curve.G, curve.R))
    two = curve.add(curve.G, curve.G)
    assert curve.equal(two, curve.double(curve.G))
    assert curve.equal(curve.mul(curve.G, 5),
                       curve.add(two, curve.add(two, curve.G)))


def test_statement():
    st = Registry().circuit("fibonacci").Statement.from_seed(4, 99)
    w = st.witness()
    for row in range(st.rows):
        e = [c[row] for c in w] + [int(row == 0)] * 2
        assert st.constraints(e) == [0, 0, 0, 0]
    ids, perm = st.permutation()
    assert sorted(perm) == ids == list(range(1, st.rows * 4 + 1))
    flat = [x for c in w for x in c]
    for i, j in zip(ids, perm):
        assert flat[i - 1] == flat[j - 1]
    assert st.a0 != Registry().circuit("fibonacci").Statement.from_seed(
        4, 100).a0


@pytest.fixture(scope="module")
def proof(tiny):
    from harness import Cell

    cell = Cell(TINY, 77, "cpu", tiny)
    cell.set_up()
    return cell.prove(), verify.Verifier(cell.statement, cell.tau)


def test_accepts_the_proof(proof):
    data, v = proof
    assert v.check(data) == []


@pytest.mark.parametrize("where", [8, 200, 1000, 3000, -40])
def test_rejects_an_altered_byte(proof, where):
    data, v = proof
    bad = bytearray(data)
    bad[where] ^= 1
    assert v.check(bytes(bad))


def test_rejects_another_statement(proof, tiny):
    data, v = proof
    st = Registry(tiny.bench).circuit("fibonacci").Statement(3, 1, 2)
    assert verify.Verifier(st, v.tau).check(data)
    assert verify.Verifier(v.st, v.tau + 1).check(data)
