"""The port's span recorder (`quill_tpu_torch/utils/profiling.py`).

- `phase` adds seconds by name whether or not a recording is open, and
  keeps nothing else unless one is; a recording keeps each span with its
  parent on `time.time_ns()`.
- The pinned 8-row proofs (`tests/test_golden_proof_bytes.py`), every MSM
  on kernels C + D's plain twins, have the same bytes with the recorder on
  and off; the recorded spans nest, and the prove's steps each have one.
- The v8 and small routes open their own spans inside `msm/<route>`.
"""

import hashlib
import time

import numpy as np
import pytest
import torch

from quill_tpu_torch.ec import curve, msm8
from quill_tpu_torch.ec import device as ed
from quill_tpu_torch.engine.device import TorchEngine
from quill_tpu_torch.pcs.mlpcs import MultilinearPCS
from quill_tpu_torch.pcs.setup import setup
from quill_tpu_torch.proof import hyperplonk
from quill_tpu_torch.utils import profiling, proof_io
from tests.test_torch_proof import fibonacci, golden, modified_fibonacci

torch.set_num_threads(1)

# the spans an 8-row prove on C + D opens (the names a prove can reach
# beyond them: the other routes' `msm/*`, and the lookup spans)
PROVE_SPANS = {
    "prove", "prove/check_constraints", "prove/witness_upload",
    "prove/witness_commit", "prove/zerocheck_expr", "prove/zerocheck",
    "prove/permutation_check", "prove/witness_openings",
    "prove/public_openings", "prove/id_perm_trace_openings",
    "proof_io/serialize", "msm/cd", "msm/cd/sort", "msm/cd/combine",
    "kzg/commit_msm", "kzg/open_msm", "kzg/quotient",
}


def test_phase_adds_seconds_and_records_nothing_when_off():
    with profiling.recording() as rec:
        pass
    before = profiling.metrics.counts["test/off"]
    with profiling.phase("test/off"):
        time.sleep(0.001)
    assert profiling.metrics.counts["test/off"] == before + 1
    assert profiling.metrics.times["test/off"] >= 0.001
    assert rec.spans == [] and profiling._recording is None


def test_recording_keeps_spans_with_parents():
    t0 = time.time_ns()
    with profiling.recording() as rec:
        with profiling.phase("test/a"):
            with profiling.phase("test/b"):
                time.sleep(0.002)
            with profiling.phase("test/c"):
                pass
        with profiling.phase("test/d"):
            pass
    t1 = time.time_ns()
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["test/b", "test/c", "test/a",
                                           "test/d"]
    a, b, c, d = (by[k] for k in ("test/a", "test/b", "test/c", "test/d"))
    assert len({s.id for s in rec.spans}) == 4
    assert a.parent == d.parent == -1 and b.parent == c.parent == a.id
    assert t0 <= a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns
    assert c.end_ns <= a.end_ns <= d.start_ns <= d.end_ns <= t1
    own = rec.self_ns()
    assert own[a.id] == (a.end_ns - a.start_ns - (b.end_ns - b.start_ns)
                         - (c.end_ns - c.start_ns))
    assert own[b.id] == b.end_ns - b.start_ns >= 2_000_000
    assert rec.roots() == {a.id: a.id, b.id: a.id, c.id: a.id, d.id: d.id}


def test_recordings_nest_and_spans_close_on_error():
    with profiling.recording() as outer:
        with profiling.recording() as inner:
            with pytest.raises(RuntimeError):
                with profiling.phase("test/raises"):
                    raise RuntimeError
        assert profiling._recording is outer
        with profiling.phase("test/after"):
            pass
    assert profiling._recording is None
    assert [s.name for s in inner.spans] == ["test/raises"]
    assert [s.name for s in outer.spans] == ["test/after"]


@pytest.fixture(scope="module")
def fib_proves():
    """The pinned 8-row Fibonacci proof twice on one preprocessed circuit:
    recorder off, then on; -> bytes, the spans' names of each
    (`metrics.times` before and after), and the recording."""
    eng = TorchEngine("cpu", min_device_size=1, msm_small_chunks=0)
    circuit, trace = fibonacci(8)
    pcs = MultilinearPCS(setup(eng, circuit.num_cols() * circuit.num_rows()))
    hp = hyperplonk.HyperPlonk.preprocess([circuit], pcs)

    def prove():
        counts = dict(profiling.metrics.counts)
        data = proof_io.serialize_proof(hp.prove([trace]))
        names = {k for k, n in profiling.metrics.counts.items()
                 if n != counts.get(k, 0)}
        return data, names

    off, off_names = prove()
    with profiling.recording() as rec:
        on, on_names = prove()
    return {"off": off, "on": on, "off_names": off_names,
            "on_names": on_names, "rec": rec}


def test_pinned_proof_bytes_with_recording_on_and_off(fib_proves):
    want_hash, want_len = golden("fib")
    for side in ("off", "on"):
        data = fib_proves[side]
        assert len(data) == want_len
        assert hashlib.sha256(data).hexdigest() == want_hash


def test_seconds_by_name_the_same_on_and_off(fib_proves):
    assert fib_proves["on_names"] == fib_proves["off_names"]
    assert {s.name for s in fib_proves["rec"].spans} == fib_proves["on_names"]
    # the spans the benchmark's metrics read are among them
    assert {"prove/zerocheck", "prove/permutation_check",
            "prove/witness_openings", "prove/id_perm_trace_openings",
            "prove/check_constraints",
            "prove/witness_upload"} <= fib_proves["off_names"]


def test_the_prove_has_its_spans(fib_proves):
    names = {s.name for s in fib_proves["rec"].spans}
    assert PROVE_SPANS <= names
    assert not {n for n in names if n.startswith(("msm/v8", "msm/small"))}


def test_every_span_ends_inside_its_parent(fib_proves):
    rec = fib_proves["rec"]
    by_id = {s.id: s for s in rec.spans}
    assert len(by_id) == len(rec.spans)
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent != -1:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, s
    # two roots: the prove, and the serialisation after it
    roots = {by_id[r].name for r in rec.roots().values()}
    assert roots == {"prove", "proof_io/serialize"}
    assert all(v >= 0 for v in rec.self_ns().values())


def test_msm_steps_inside_their_route(fib_proves):
    rec = fib_proves["rec"]
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name.startswith("msm/cd/"):
            assert by_id[s.parent].name == "msm/cd"
        if s.name == "msm/cd":
            assert by_id[s.parent].name in {"kzg/commit_msm", "kzg/open_msm",
                                            "mlpcs/s_commit",
                                            "multiset/commits"}


def test_modified_fibonacci_pin_with_recording_on():
    circuit, trace = modified_fibonacci()
    eng = TorchEngine("cpu", min_device_size=1, msm_small_chunks=0)
    pcs = MultilinearPCS(setup(eng, circuit.num_cols() * circuit.num_rows()))
    hp = hyperplonk.HyperPlonk.preprocess([circuit], pcs)
    with profiling.recording() as rec:
        data = proof_io.serialize_proof(hp.prove([trace]))
    want_hash, want_len = golden("fib2")
    assert len(data) == want_len
    assert hashlib.sha256(data).hexdigest() == want_hash
    assert PROVE_SPANS <= {s.name for s in rec.spans}


def _msm_spans(eng, n: int, rng) -> list:
    g = curve.g1_generator()
    pts = [g.scalar_mul(int(k)).to_affine()
           for k in rng.integers(2, 1 << 40, size=n)]
    basis = eng.load_points(pts)
    scalars = [int(x) for x in rng.integers(0, 1 << 62, size=n)]
    with profiling.recording() as rec:
        eng.msm(basis, eng.vec_from_ints(scalars))
    return rec.spans


def test_v8_steps_inside_msm_v8(monkeypatch):
    """Two chunks of 64 points.  The triangle's 20 x 8192-bucket plain adds
    are left out (its window sums stand as identities): the v8 MSM's
    result is `tests/test_torch_msm8.py`'s."""
    monkeypatch.setattr(msm8, "CHUNK", 64)
    monkeypatch.setattr(msm8, "triangle",
                        lambda acc: ed.identity(msm8.NWIN, acc.device))
    eng = TorchEngine("cpu", min_device_size=1, msm_shift_max=0)
    spans = _msm_spans(eng, 100, np.random.default_rng(11))
    top = [s for s in spans if s.parent == -1]
    assert [s.name for s in top] == ["msm/v8"]
    names = [s.name for s in spans if s.parent == top[0].id]
    assert names == (["msm/v8/digits"]
                     + ["msm/v8/digits", "msm/v8/scan", "msm/v8/collect"] * 2
                     + ["msm/v8/triangle", "msm/v8/combine"])
    assert eng.msm_counts["v8"] == 1


def test_small_route_steps_inside_msm_small():
    eng = TorchEngine("cpu", min_device_size=1)
    spans = _msm_spans(eng, 16, np.random.default_rng(12))
    top = [s for s in spans if s.parent == -1]
    assert [s.name for s in top] == ["msm/small"]
    names = {s.name for s in spans if s.parent == top[0].id}
    assert names == {"msm/small/sort", "msm/small/combine"}
    assert eng.msm_counts["small"] == 1
