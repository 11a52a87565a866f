"""The prover's witness path (`proof/hyperplonk.py: _prove`): each trace
converted once a prove, read by every reader from that one copy, and the
constraint check run on the device.

- `fields/device.py: from_ints` and `ints_to_tensor` take a list of ints
  in [0, 2^256) in one C call (`native/pyints.c`), reduced there; any
  other list takes the Python path.  Both are held against the Python path
  value by value, and `CONVERSIONS` says which path took each case.
- The prover rejects a bad witness with the host check's ValueError text
  on the port's `HostEngine` (host check) and on `TorchEngine("cpu",
  min_device_size=1)` (device check): a recurring constraint, a boundary
  value, a state continuity, and a limb statement's carry.  With both
  checks patched out, the permutation argument alone rejects a broken
  continuity.
- One upload: the zero check's columns and a lookup's columns are views
  of the committed trace, the public columns are the proving key's, the
  multiplicities are converted once, and `witness_counts` counts each
  trace's rows x cols every prove.  Below the engine's device size the
  columns stay host vectors, checked on the host.
"""

import random

import numpy as np
import pytest
import torch

from quill_tpu_torch.engine.device import TorchEngine, TVec
from quill_tpu_torch.engine.host import HostEngine
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.fields.bn254 import R
from quill_tpu_torch.frontend.transition_circuit import TransitionCircuit
from quill_tpu_torch.pcs.kzg import cached_trusted_setup
from quill_tpu_torch.pcs.mlpcs import MultilinearPCS
from quill_tpu_torch.piops import lookup as lookup_piop
from quill_tpu_torch.piops import zerocheck
from quill_tpu_torch.piops.virtual_poly import Const
from quill_tpu_torch.proof import hyperplonk
from quill_tpu_torch.transcript.transcript import Transcript
from tests.test_torch_lookup import limb_statement
from tests.test_torch_proof import fibonacci, modified_fibonacci

torch.set_num_threads(1)

ENGINES = ("host", "torch")


def make_engine(name: str, min_device_size: int = 1):
    if name == "host":
        return HostEngine()
    return TorchEngine("cpu", min_device_size=min_device_size,
                       msm_small_chunks=0)


def preprocess(engine, circuits, lookups=None):
    pcs = MultilinearPCS(cached_trusted_setup(
        engine, max(c.num_cols() * c.num_rows() for c in circuits)))
    return hyperplonk.HyperPlonk.preprocess(circuits, pcs, lookups=lookups)


# -- the bulk conversion -------------------------------------------------------

FIELDS = {"fr": fd.FR, "fq": fd.FQ}
BULK_CASES = {
    "edges": lambda m: [0, 1, m - 1, m, m + 1, 2 * m - 1, 5 * m,
                        (1 << 256) - 1, 1 << 255, (1 << 64) - 1, 1 << 64],
    "random": lambda m: [random.Random(m).getrandbits(256)
                         for _ in range(257)],
    "small": lambda m: list(range(300)),
}
PYTHON_CASES = {
    "negative": lambda m: [3, -1, -m, -(1 << 300)],
    "wide": lambda m: [3, 1 << 256, (1 << 300) + 7],
    "bool": lambda m: [2, True, False],
    "numpy_scalars": lambda m: [np.int64(7), np.uint64(1 << 63), 9],
    "numpy_array": lambda m: np.arange(40, dtype=np.int64),
}


def python_path(xs, field):
    """The conversion value by value: `int(x) % m`, bytes, Montgomery."""
    return fd.to_mont(fd._limbs_python([int(x) % field.modulus for x in xs]),
                      field)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("case", list(BULK_CASES) + list(PYTHON_CASES))
def test_from_ints_matches_the_python_path(case, field):
    f = FIELDS[field]
    bulk = case in BULK_CASES
    xs = (BULK_CASES if bulk else PYTHON_CASES)[case](f.modulus)
    before = dict(fd.CONVERSIONS)
    got = fd.from_ints(xs, f)
    n = len(xs)
    assert fd.CONVERSIONS["bulk"] - before["bulk"] == (n if bulk else 0)
    assert fd.CONVERSIONS["python"] - before["python"] == (0 if bulk else n)
    assert torch.equal(got, python_path(xs, f))
    assert fd.to_ints(got, f) == [int(x) % f.modulus for x in xs]


@pytest.mark.parametrize("case", list(BULK_CASES))
def test_ints_to_tensor_matches_the_python_path(case):
    xs = BULK_CASES[case](R)
    before = fd.CONVERSIONS["bulk"]
    got = fd.ints_to_tensor(xs)
    assert fd.CONVERSIONS["bulk"] - before == len(xs)
    assert torch.equal(got, fd._limbs_python(xs))
    assert fd.tensor_to_ints(got) == xs


def test_ints_to_tensor_refuses_what_it_refused():
    """Outside [0, 2^256) the Python path raises, as it did."""
    for xs in ([1, 1 << 256], [-1]):
        with pytest.raises(OverflowError):
            fd.ints_to_tensor(xs)
    assert fd.ints_to_tensor([]).shape == (0, fd.NLIMB)
    assert fd.from_ints([]).shape == (0, fd.NLIMB)


# -- the prover's rejections ---------------------------------------------------

S1_CUR, S1_NEXT, S2_CUR, S2_NEXT = range(4)


def fibonacci_from(rows: int, a: int, b: int) -> list[list[int]]:
    """The witness of `fibonacci(rows)`'s circuit from (a, b) at row 0."""
    cols = [[0] * rows for _ in range(4)]
    for row in range(rows):
        cols[S1_CUR][row], cols[S2_CUR][row] = a, b
        cols[S1_NEXT][row], cols[S2_NEXT][row] = b, (a + b) % R
        a, b = b, (a + b) % R
    return cols


def broken_continuity(cols: list[list[int]]) -> None:
    """Break the 4 -> 5 seam of s1, then recompute rows 5..7 so that every
    in-row constraint holds again (`tests/test_hyperplonk.py`)."""
    cols[S1_CUR][5] = (cols[S1_NEXT][4] + 1) % R
    for row in range(5, 8):
        if row > 5:
            cols[S1_CUR][row] = cols[S1_NEXT][row - 1]
            cols[S2_CUR][row] = cols[S2_NEXT][row - 1]
        cols[S1_NEXT][row] = cols[S2_CUR][row]
        cols[S2_NEXT][row] = (cols[S1_CUR][row] + cols[S2_CUR][row]) % R


def fib_case(breaker):
    def make():
        circuit, trace = fibonacci(8)
        breaker(trace.columns)
        return [circuit], [trace], None
    return make


def recurring(cols):
    cols[S2_NEXT][3] = (cols[S2_NEXT][3] + 1) % R


def boundary(cols):
    # a Fibonacci run from (2, 1): every row and seam holds, row 0 does not
    cols[:] = fibonacci_from(8, 2, 1)


def limb_carry():
    """The limb statement at 2^4 rows of 4-bit limbs with a carry into the
    high limb of row 6 that the low limbs do not give."""
    st = limb_statement()
    traces = st.traces()
    witnesses = [hyperplonk.TraceWitness(columns=t.witness())
                 for t in traces]
    cols, base = witnesses[0].columns, traces[0].base
    cols[7][6] = (cols[7][6] + 1) % base        # b_hi' of row 6
    return ([t.program_circuit() for t in traces], witnesses,
            st.program_lookups())


REJECTIONS = {
    "recurring": (fib_case(recurring),
                  "Recurring constraint ", " not satisfied at row 3; "),
    "boundary": (fib_case(boundary),
                 "Boundary constraint ", " not satisfied at row 0; "),
    "continuity": (fib_case(broken_continuity),
                   "Permutation constraint not satisfied for state cell at "
                   "row 4", ""),
    "limb_carry": (limb_carry,
                   "Recurring constraint ", " not satisfied at row 6; "),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", list(REJECTIONS))
def test_prover_rejects_a_bad_witness(case, engine):
    make, head, middle = REJECTIONS[case]
    circuits, witnesses, lookups = make()
    with pytest.raises(ValueError) as host:
        circuits[0].check_constraints(witnesses[0].columns)
    hp = preprocess(make_engine(engine), circuits, lookups)
    with pytest.raises(ValueError) as err:
        hp.prove(witnesses)
    text = str(err.value)
    assert text == str(host.value)
    assert text.startswith(head) and middle in text
    checks = {"host": 0, "torch": 0}
    checks[engine] = 1
    assert hp.witness_counts["host_checks"] == checks["host"]
    assert hp.witness_counts["device_checks"] == checks["torch"]


def _check_text(check) -> str | None:
    try:
        check()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("circuit_of", [fibonacci, lambda rows:
                                        modified_fibonacci()],
                         ids=["fibonacci", "modified_fibonacci"])
def test_device_check_agrees_with_the_host_check(circuit_of):
    """Each cell of an 8-row witness changed in turn, and the witness
    whole: the device check raises what the host check raises, or
    nothing where it raises nothing (every cell of a used column is
    constrained)."""
    eng = make_engine("torch")
    circuit, trace = circuit_of(8)
    rows, cols = circuit.num_rows(), circuit.num_cols()
    cases = [trace.columns]
    for c in range(circuit.num_columns):
        for r in range(rows):
            w = [list(col) for col in trace.columns]
            w[c][r] = (w[c][r] + 1 + r) % R
            cases.append(w)
    texts = []
    for w in cases:
        full = eng.vec_from_ints([x for col in w for x in col])
        views = hyperplonk._column_views(eng, full, rows, cols)
        host = _check_text(lambda: circuit.check_constraints(w))
        device = _check_text(
            lambda: circuit.check_constraints_device(eng, views, w))
        assert device == host
        texts.append(host)
    assert texts[0] is None and all(texts[1:])


@pytest.mark.parametrize("value", [0, 1])
def test_device_check_of_a_constant_constraint(value):
    eng = make_engine("torch")
    circuit, trace = fibonacci(8)
    circuit.enforce_constraint(Const(value))
    full = eng.vec_from_ints([x for col in trace.columns for x in col])
    views = hyperplonk._column_views(eng, full, 8, circuit.num_cols())
    host = _check_text(lambda: circuit.check_constraints(trace.columns))
    assert host == _check_text(lambda: circuit.check_constraints_device(
        eng, views, trace.columns))
    assert (host is None) == (value == 0)


@pytest.mark.parametrize("engine", ENGINES)
def test_broken_continuity_rejected_by_the_permutation_alone(engine,
                                                             monkeypatch):
    """Both checks patched out: the prover makes an honest proof of the
    bad witness, and the verifier rejects it."""
    monkeypatch.setattr(TransitionCircuit, "check_constraints",
                        lambda self, w: None)
    monkeypatch.setattr(TransitionCircuit, "check_constraints_device",
                        lambda self, e, c, w: None)
    circuits, witnesses, _ = fib_case(broken_continuity)()
    hp = preprocess(make_engine(engine), circuits)
    proof = hp.prove(witnesses)
    with pytest.raises(ValueError):
        hyperplonk.verify(proof, hp.to_vk(), hp.pcs, batch_pairings=True)


# -- one upload ------------------------------------------------------------------


class Stop(Exception):
    pass


def _storage(v) -> int:
    return v.data.untyped_storage().data_ptr()


def _spy_commits(monkeypatch, pcs, name: str) -> list:
    seen = []
    orig = getattr(pcs, name)

    def spy(arg):
        seen.append(arg)
        return orig(arg)

    monkeypatch.setattr(pcs, name, spy)
    return seen


def _stop_at_zerocheck(monkeypatch) -> list:
    stores = []

    def at_zerocheck(store, h, transcript):
        stores.append(list(store.polynomials))
        raise Stop

    monkeypatch.setattr(zerocheck, "prove", at_zerocheck)
    return stores


def test_zero_check_reads_the_committed_trace(monkeypatch):
    """Two 2^6-row proves, each stopped at its zero check: each converts
    its trace once, its columns in the zero check's store are views of
    the trace it committed, and its public columns are the key's."""
    eng = make_engine("torch")
    circuit, trace = fibonacci(64)
    hp = preprocess(eng, [circuit])
    commits = _spy_commits(monkeypatch, hp.pcs, "commit_many")
    stores = _stop_at_zerocheck(monkeypatch)
    for k in (1, 2):
        bulk = fd.CONVERSIONS["bulk"]
        with pytest.raises(Stop):
            hp.prove([trace])
        assert hp.witness_counts == {"values_uploaded": k * 64 * 4,
                                     "device_checks": k, "host_checks": 0}
        assert fd.CONVERSIONS["bulk"] - bulk >= 64 * 4
        (flat,) = commits[-1]
        polys = stores[-1]
        assert len(polys) == 4 + 2
        for c, col in enumerate(polys[:4]):
            assert isinstance(col, TVec) and _storage(col) == _storage(flat)
            assert torch.equal(col.rows(), flat.rows()[c * 64:(c + 1) * 64])
        assert all(p is q for p, q in zip(polys[4:],
                                          hp.trace_pks[0].public_values))
    # every prove converted its own witness
    assert _storage(commits[0][0]) != _storage(commits[1][0])


@pytest.mark.parametrize("engine,min_size", [("host", 1), ("torch", 16)])
def test_below_the_device_size_the_columns_stay_host_vectors(
        engine, min_size, monkeypatch):
    """8 rows: on `HostEngine`, and on a `TorchEngine` whose device size
    is above the rows but not the trace's cells, the store's columns are
    host vectors of the witness and the host checks it."""
    eng = make_engine(engine, min_size)
    circuit, trace = fibonacci(8)
    hp = preprocess(eng, [circuit])
    stores = _stop_at_zerocheck(monkeypatch)
    with pytest.raises(Stop):
        hp.prove([trace])
    assert hp.witness_counts == {"values_uploaded": 8 * 4,
                                 "device_checks": 0, "host_checks": 1}
    host = HostEngine()
    for col, want in zip(stores[0][:4], trace.columns):
        assert host.is_vec(col) and list(col) == want


def test_lookup_reads_the_committed_traces(monkeypatch):
    """The limb statement's first lookup, stopped at its PIOP: its source
    and table columns are views of the traces, and the store's
    multiplicities are the committed vector."""
    eng = make_engine("torch")
    st = limb_statement()
    traces = st.traces()
    circuits = [t.program_circuit() for t in traces]
    hp = preprocess(eng, circuits, st.program_lookups())
    witnesses = [hyperplonk.TraceWitness(columns=t.witness())
                 for t in traces]
    full = [eng.vec_from_ints([x for col in w.columns for x in col])
            for w in witnesses]
    views = [hyperplonk._column_views(eng, f, c.num_rows(), c.num_cols())
             for f, c in zip(full, circuits)]
    commits = _spy_commits(monkeypatch, hp.pcs, "commit")
    seen = []

    def at_piop(src_store, src_refs, dst_store, dst_refs, mult_ref, *rest):
        seen.append((src_store, dst_store))
        raise Stop

    monkeypatch.setattr(lookup_piop, "prove", at_piop)
    lk = hp.lookups[0]
    with pytest.raises(Stop):
        hp._prove_lookup(lk, witnesses, full, views,
                         Transcript(hyperplonk.DOMAIN))
    src_store, dst_store = seen[0]
    (src,) = src_store.polynomials
    table, mult = dst_store.polynomials
    rows_src, rows_dst = traces[0].rows, traces[1].rows
    c, v = lk.src_cols[0], lk.dst_cols[0]
    assert _storage(src) == _storage(full[0])
    assert torch.equal(src.rows(),
                       full[0].rows()[c * rows_src:(c + 1) * rows_src])
    assert _storage(table) == _storage(full[1])
    assert torch.equal(table.rows(),
                       full[1].rows()[v * rows_dst:(v + 1) * rows_dst])
    assert mult is commits[-1]
