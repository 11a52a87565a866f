"""The port's statements of several traces and its cross-table lookups
(`proof/hyperplonk.py: _prove_lookup`, `piops/lookup.py`,
`piops/set_inclusion.py`).

- The JAX package's cases (`tests/test_hyperplonk.py`: multitrace, and
  the lookup cases of `TestCrossTableLookup`) on the port's modules, on
  the port's `HostEngine` and on `TorchEngine("cpu")` with every table on
  its device path and every MSM on kernels C + D's plain twins.  The
  port's proofs have the JAX package's bytes.
- The benchmark's range-checked limb statement
  (`benchmark/circuits/limb_fibonacci_logup.py`) at 2^4 rows of 4-bit limbs:
  the port's proof is accepted by the benchmark's plain reference
  (`benchmark/reference/verify.py`), and an honest proof of a limb
  outside the table is rejected by both verifiers.
- The lookup path's spans, recorded in order; `HyperPlonk.lookup_counts`;
  the same bytes with the recorder on and off.
"""

import importlib.util
import os
import sys

import pytest
import torch

from quill_tpu_torch.engine.device import TorchEngine
from quill_tpu_torch.engine.host import HostEngine
from quill_tpu_torch.fields.bn254 import R
from quill_tpu_torch.pcs.kzg import KZG, cached_trusted_setup
from quill_tpu_torch.pcs.mlpcs import MultilinearPCS
from quill_tpu_torch.proof import hyperplonk as port_hp
from quill_tpu_torch.utils import profiling, proof_io
from tests.test_torch_proof import PORT, fibonacci, modified_fibonacci

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
LIMB_SEED = 2718281828459
ENGINES = ("host", "torch")


def _load(name: str, path: str, package: bool = False):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py") if package else path,
        submodule_search_locations=[path] if package else None)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference_verify():
    """`benchmark/reference/verify.py`, loaded as a package of its own
    name, so the benchmark's folder stays off `sys.path`."""
    _load("bench_reference", os.path.join(BENCH, "reference"), package=True)
    import bench_reference.verify

    return bench_reference.verify


def limb_statement(seed: int = LIMB_SEED):
    mod = _load("bench_circuit_limb_fibonacci_logup",
                os.path.join(BENCH, "circuits", "limb_fibonacci_logup.py"))
    return mod.Statement.from_seed(4, seed, limb_bits=4)


def make_engine(name: str):
    if name == "host":
        return HostEngine()
    return TorchEngine("cpu", min_device_size=1, msm_small_chunks=0)


def jax_package():
    from quill_tpu.frontend import transition_circuit
    from quill_tpu.piops import virtual_poly
    from quill_tpu.proof import hyperplonk

    return transition_circuit, virtual_poly, hyperplonk


def square_table_pair(pkg=PORT, bad_row: int | None = None):
    """`tests/test_hyperplonk.py: get_square_table_pair`: source rows
    (a, a^2) looked up in a table trace (v, v^2).  With `bad_row`, one
    source row is a consistent pair that is not in the table."""
    tc, _, hp = pkg
    table = tc.TransitionCircuit.new(8)
    tv = table.allocate_witness_cell()
    tv2 = table.allocate_witness_cell()
    table.enforce_constraint(tv2.to_expr() - tv.to_expr() * tv.to_expr())
    tw = [[0] * 8 for _ in range(table.num_cols())]
    for row in range(8):
        tw[tv.col][row] = row
        tw[tv2.col][row] = row * row % R

    src = tc.TransitionCircuit.new(8)
    sa = src.allocate_witness_cell()
    sb = src.allocate_witness_cell()
    src.enforce_constraint(sb.to_expr() - sa.to_expr() * sa.to_expr())
    sw = [[0] * 8 for _ in range(src.num_cols())]
    for row, v in enumerate([3, 1, 4, 1, 5, 2, 6, 5]):
        sw[sa.col][row] = v
        sw[sb.col][row] = v * v % R
    if bad_row is not None:
        sw[sa.col][bad_row] = 9          # 9 is not in the 0..7 table
        sw[sb.col][bad_row] = 81
    lk = hp.CrossTableLookup(src_trace=0, src_cols=[sa.col, sb.col],
                             dst_trace=1, dst_cols=[tv.col, tv2.col])
    return ([src, table],
            [hp.TraceWitness(columns=sw), hp.TraceWitness(columns=tw)], lk)


def port_prove(engine, circuits, traces, lookups=None):
    pcs = MultilinearPCS(cached_trusted_setup(
        engine, max(c.num_cols() * c.num_rows() for c in circuits)))
    hp = port_hp.HyperPlonk.preprocess(circuits, pcs, lookups=lookups)
    return hp, pcs, hp.prove(traces)


def jax_proof_bytes(circuits, traces, lookups=None) -> bytes:
    from quill_tpu.engine.host import HostEngine as JaxHost
    from quill_tpu.pcs.kzg import cached_trusted_setup as jax_setup
    from quill_tpu.pcs.mlpcs import MultilinearPCS as JaxPCS
    from quill_tpu.proof import hyperplonk
    from quill_tpu.utils import proof_io as jax_io

    pcs = JaxPCS(jax_setup(
        JaxHost(), max(c.num_cols() * c.num_rows() for c in circuits)))
    hp = hyperplonk.HyperPlonk.preprocess(circuits, pcs, lookups=lookups)
    return jax_io.serialize_proof(hp.prove(traces))


# -- the JAX package's cases ---------------------------------------------------


def test_multitrace_matches_the_jax_package():
    """`test_hyperplonk.py: test_multitrace`: two traces proved together."""
    c1, t1 = fibonacci(8)
    c2, t2 = modified_fibonacci()
    hp, pcs, proof = port_prove(HostEngine(), [c1, c2], [t1, t2])
    assert len(proof.trace_proofs) == 2 and proof.lookup_proofs == []
    port_hp.verify(proof, hp.to_vk(), pcs, batch_pairings=True)
    jc1, jt1 = fibonacci(8, jax_package())
    jc2, jt2 = modified_fibonacci(jax_package())
    assert proof_io.serialize_proof(proof) == jax_proof_bytes(
        [jc1, jc2], [jt1, jt2])


@pytest.fixture(scope="module", params=ENGINES)
def square(request):
    """The square-table pair proved once an engine: -> (engine name, hp,
    pcs, proof bytes)."""
    circuits, traces, lk = square_table_pair()
    hp, pcs, proof = port_prove(make_engine(request.param), circuits, traces,
                                [lk])
    assert len(proof.lookup_proofs) == 1
    return request.param, hp, pcs, proof_io.serialize_proof(proof)


def test_lookup_accepts_valid(square):
    _, hp, pcs, data = square
    port_hp.verify(proof_io.deserialize_proof(data), hp.to_vk(), pcs,
                   strict=True, batch_pairings=True)


def test_lookup_accepts_valid_pairing_by_pairing():
    """The unbatched verifier, as the JAX case runs it: each KZG check its
    own pairing (~25 s on a CPU, so on the host engine's proof alone; the
    engines' bytes are equal, `test_lookup_proof_bytes_match_the_jax_
    package`)."""
    circuits, traces, lk = square_table_pair()
    hp, pcs, proof = port_prove(HostEngine(), circuits, traces, [lk])
    port_hp.verify(proof, hp.to_vk(), pcs)


def test_lookup_batched_pairings(square):
    _, hp, pcs, data = square
    port_hp.verify(proof_io.deserialize_proof(data), hp.to_vk(), pcs,
                   batch_pairings=True)


def test_lookup_missing_tuple_rejected():
    """(9, 81) meets the square constraint but is not in the table: the
    prover runs honestly, the verifier rejects."""
    circuits, traces, lk = square_table_pair(bad_row=4)
    hp, pcs, proof = port_prove(HostEngine(), circuits, traces, [lk])
    with pytest.raises(ValueError):
        port_hp.verify(proof, hp.to_vk(), pcs, batch_pairings=True)


def test_lookup_mutated_multiplicities_rejected(square):
    _, hp, pcs, data = square
    proof = proof_io.deserialize_proof(data)
    op = proof.lookup_proofs[0].multiplicities_opening
    op.evaluation = (op.evaluation + 1) % R
    with pytest.raises(ValueError):
        port_hp.verify(proof, hp.to_vk(), pcs, batch_pairings=True)


def test_lookup_proof_roundtrip(square):
    _, hp, pcs, data = square
    back = proof_io.deserialize_proof(data)
    assert proof_io.serialize_proof(back) == data
    assert len(back.lookup_proofs) == 1


def test_lookup_proof_bytes_match_the_jax_package(square):
    """Both engines' proofs are the JAX package's HostEngine proof."""
    _, _, _, data = square
    circuits, traces, lk = square_table_pair(jax_package())
    assert data == jax_proof_bytes(circuits, traces, [lk])


# -- the benchmark's limb statement --------------------------------------------


@pytest.fixture(scope="module")
def limb():
    """The limb statement preprocessed on the host engine with the
    reference's tau, proved with the recorder off and then on."""
    verify = reference_verify()
    st = limb_statement()
    traces = st.traces()
    tau = 123456789123456789 % R
    eng = HostEngine()
    kzg = KZG.trusted_setup(eng, max(t.rows * t.columns for t in traces),
                            tau=tau)
    pcs = MultilinearPCS(kzg)
    hp = port_hp.HyperPlonk.preprocess(
        [t.program_circuit() for t in traces], pcs,
        lookups=st.program_lookups())
    witnesses = [port_hp.TraceWitness(columns=t.witness()) for t in traces]
    off = proof_io.serialize_proof(hp.prove(witnesses))
    with profiling.recording() as rec:
        on = proof_io.serialize_proof(hp.prove(witnesses))
    return {"st": st, "tau": tau, "hp": hp, "pcs": pcs, "off": off,
            "on": on, "rec": rec, "verify": verify}


def test_limb_statement_accepted_by_the_reference(limb):
    v = limb["verify"].Verifier(limb["st"], limb["tau"])
    assert v.check(limb["off"]) == []
    port_hp.verify(proof_io.deserialize_proof(limb["off"]),
                   limb["hp"].to_vk(), limb["pcs"], batch_pairings=True)


def test_limb_outside_the_table_rejected(limb):
    """An honest proof of a witness whose last new low limb lies outside
    the table with every constraint met (the carry moved into the limb or
    out of it): both verifiers reject it, and the reference for the
    lookup alone."""
    verify = limb["verify"]
    st = limb_statement(LIMB_SEED + 1)
    limbs = st.traces()[0]
    honest = limbs.witness

    def witness():
        w = honest()
        last, base = limbs.rows - 1, limbs.base
        s = w[0][last] + w[4][last]
        carry = 0 if s >= base else 1
        w[5][last] = (s - carry * base) % R
        w[7][last] = (w[2][last] + w[6][last] + carry) % base
        assert not 0 <= w[5][last] < base
        return w

    limbs.witness = witness
    traces = st.traces()
    kzg = KZG.trusted_setup(HostEngine(),
                            max(t.rows * t.columns for t in traces),
                            tau=limb["tau"])
    pcs = MultilinearPCS(kzg)
    hp = port_hp.HyperPlonk.preprocess(
        [t.program_circuit() for t in traces], pcs,
        lookups=st.program_lookups())
    proof = hp.prove([port_hp.TraceWitness(columns=t.witness())
                      for t in traces])
    failed = verify.Verifier(st, limb["tau"]).check(
        proof_io.serialize_proof(proof))
    assert failed == ["lookup 0: log-derivative sums differ"]
    with pytest.raises(ValueError):
        port_hp.verify(proof, hp.to_vk(), pcs, batch_pairings=True)


LOOKUP_SPANS = [
    "prove/lookup_multiplicities", "prove/lookup_commit",
    "set_inclusion/log_derivative_tables", "set_inclusion/commits",
    "set_inclusion/eq_table", "set_inclusion/sumcheck",
    "set_inclusion/eq_table", "set_inclusion/sumcheck",
    "set_inclusion/opens", "prove/lookup_piop", "prove/lookup_openings",
]


def test_lookup_spans_recorded_in_order(limb):
    """Each lookup's spans, in the order they close; the set-inclusion
    PIOP's inside `prove/lookup_piop`, the lookup's own inside `prove`."""
    rec = limb["rec"]
    by_id = {s.id: s for s in rec.spans}
    mine = [s for s in rec.spans
            if s.name.startswith(("prove/lookup_", "set_inclusion/"))]
    assert [s.name for s in mine] == LOOKUP_SPANS * 2
    for s in mine:
        parent = by_id[s.parent].name
        want = ("prove/lookup_piop" if s.name.startswith("set_inclusion/")
                else "prove")
        assert parent == want, (s.name, parent)


def test_lookup_counts(limb):
    """Two lookups a prove, each of 2^4 source rows into 2^4 table rows,
    over the fixture's two proves."""
    assert limb["hp"].lookup_counts == {"lookups": 4, "source_rows": 64,
                                        "table_rows": 64}


def test_proof_bytes_the_same_with_recording_on_and_off(limb):
    assert limb["on"] == limb["off"]
