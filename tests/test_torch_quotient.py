"""The batched KZG quotient of quill_tpu_torch (`engine/quotient.py`, kernel
M's plain twin and its host emulation) against the JAX package.

- `quotient_many_plain` and `quotient_many_device` on `TorchEngine("cpu")`
  against one call of JAX `quill_tpu.engine.quotient.quotient_many_device`
  (3 jobs of one 2^16-coefficient chunk, one of them full, x including
  R - 7), exact `==` on
  canonical integers; the JAX quotient keeps n coefficients, the last 0,
  the port's n - 1;
- batches of two jobs against JAX `HostEngine.quotient_by_linear` at odd
  lengths across kernel M's tiles (4,096 coefficients; the JAX call above
  covers a whole chunk);
- `TorchEngine.quotient_many` sends device vectors with x != 0 through
  `quotient_many_device`, all in one call in input order (split at
  MAX_JOBS inside it), and x = 0 and host vectors through
  `quotient_by_linear`; `KZG.open_many` gives the JAX host prover's
  opening proofs;
- kernel M's phases (`csrc/quotient.cuh`), run by the host emulation
  `q_quotient_blocked` (`csrc/bn254_host.cpp`, built with g++) for several
  tile shapes and lengths, against the plain twin; skips only without g++.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from quill_tpu.engine.host import HostEngine
from quill_tpu.fields.bn254 import R

from quill_tpu_torch.convert import limbs12_to_ints
from quill_tpu_torch.engine import quotient as Q
from quill_tpu_torch.engine.device import TVec, TorchEngine
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.kernels import build
from quill_tpu_torch.pcs.kzg import KZG

torch.set_num_threads(1)

XS = [55555555555 % R, 123456789123456789 % R, R - 7]


def _ints(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for row in rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64):
        out.append(sum(int(w) << (32 * i) for i, w in enumerate(row)) % R)
    return out


def _host_quotient(coeffs, x):
    y, q = HostEngine().quotient_by_linear(HostEngine().vec_from_ints(coeffs),
                                           x)
    return y, [int(v) for v in q]


@pytest.fixture(scope="module")
def jax_batch():
    """One call of the JAX batched quotient, 3 jobs of one chunk (a full
    one, 4,097 and 100 coefficients) -> the polynomials, and per job y and
    the quotient's canonical (n, 8) limbs, its last coefficient (0) held
    apart."""
    from quill_tpu.engine.device import CHUNK, TpuEngine
    from quill_tpu.engine.quotient import quotient_many_device

    eng = TpuEngine()
    polys = [_ints(10 + j, n) for j, n in enumerate((CHUNK, 4097, 100))]
    polys[0][:4] = [0, 1, R - 1, R - 2]
    # two are shorter than a chunk, which vec_from_ints keeps on the host
    outs = quotient_many_device(
        eng, [(eng._dvec_from_ints(p), x) for p, x in zip(polys, XS)])
    want = []
    for y, q in outs:
        ints = limbs12_to_ints(np.concatenate(
            [np.asarray(c) for c in q.chunks], axis=1)[:, :q.length])
        want.append((y, fd.ints_to_tensor(ints[:-1]), ints[-1]))
    return polys, want


@pytest.mark.parametrize("fn", ["plain", "device"])
def test_matches_jax_quotient_many_device(jax_batch, fn):
    polys, want = jax_batch
    eng = TorchEngine("cpu", min_device_size=1)
    jobs = [(eng.vec_from_ints(p), x) for p, x in zip(polys, XS)]
    outs = (Q.quotient_many_plain(jobs) if fn == "plain"
            else Q.quotient_many_device(eng, jobs))
    for (y, q), (wy, wq, last) in zip(outs, want):
        assert isinstance(q, TVec) and q.length == wq.shape[0]
        assert y == wy and last == 0
        assert torch.equal(fd.from_mont(q.rows(), fd.FR), wq)


@pytest.mark.parametrize("n", [2, 4095, 4097, 8193])
def test_matches_host_at_odd_lengths(n):
    """A batch of two jobs, of length n and 3, against the host; the
    engine counts the batch."""
    eng = TorchEngine("cpu", min_device_size=1)
    polys = [_ints(n, n), _ints(n + 1, 3)]
    xs = [R - 7, 1]
    got = Q.quotient_many_device(
        eng, [(eng.vec_from_ints(p), x) for p, x in zip(polys, xs)])
    assert eng.quotient_batches == {(n, 3): 1}
    for p, x, (y, q) in zip(polys, xs, got):
        wy, wq = _host_quotient(p, x)
        assert y == wy
        assert [int(v) for v in eng.vec_to_ints(q)] == wq


def _route(eng, lengths, xs, monkeypatch):
    """`eng.quotient_many` on the given jobs -> (the lengths of each
    quotient_many_device call, the per-job calls), every result checked
    against the host."""
    batches, single = [], []
    real_many, real_one = Q.quotient_many_device, eng.quotient_by_linear

    def many(engine, jobs):
        batches.append([engine.vec_len(p) for p, _ in jobs])
        return real_many(engine, jobs)

    def one(poly, x):
        single.append((eng.vec_len(poly), x))
        return real_one(poly, x)

    monkeypatch.setattr(Q, "quotient_many_device", many)
    monkeypatch.setattr(eng, "quotient_by_linear", one)
    polys = [_ints(30 + i, n) for i, n in enumerate(lengths)]
    jobs = [(eng.vec_from_ints(p), x) for p, x in zip(polys, xs)]
    got = eng.quotient_many(jobs)
    for p, x, (y, q) in zip(polys, xs, got):
        wy, wq = _host_quotient(p, x)
        assert y == wy
        assert [int(v) for v in eng.vec_to_ints(q)] == wq
    return batches, single


def test_quotients_route(monkeypatch):
    """Device vectors with x != 0 make one batch in input order, whatever
    their chunk counts; x = 0 and host vectors take the per-job path; all
    equal the host."""
    eng = TorchEngine("cpu", min_device_size=64)
    lengths = [100, (1 << 16) + 5, 200, 10, 100]
    xs = [XS[0], XS[1], XS[2], XS[0], 0]
    batches, single = _route(eng, lengths, xs, monkeypatch)
    assert batches == [[100, (1 << 16) + 5, 200]]
    assert single == [(10, XS[0]), (100, 0)]
    assert eng.quotient_batches == {(100, (1 << 16) + 5, 200): 1}


def test_quotients_route_splits_at_max_jobs(monkeypatch):
    """MAX_JOBS + 2 device jobs of mixed lengths: one call, two kernel M
    batches (MAX_JOBS, then 2) in input order."""
    eng = TorchEngine("cpu", min_device_size=64)
    lengths = [64 + 7 * i for i in range(Q.MAX_JOBS + 2)]
    xs = [(XS[i % 3] + i) % R for i in range(len(lengths))]
    batches, single = _route(eng, lengths, xs, monkeypatch)
    assert batches == [lengths] and single == []
    assert eng.quotient_batches == {tuple(lengths[:Q.MAX_JOBS]): 1,
                                    tuple(lengths[Q.MAX_JOBS:]): 1}


@pytest.mark.parametrize("lengths,run", [
    ([1], 32), ([1 << 16] * 8, 32), ([(1 << 21) - 64], 32),
    ([(1 << 21) - 63], 64), ([1 << 18, (1 << 18) - 1] * 4, 64),
    ([1 << 20, (1 << 20) - 1] * 4, 128), ([1 << 22, (1 << 22) - 1] * 2, 128),
    ([1] * 16, 32)])
def test_run_for_batch(lengths, run):
    """Kernel M's run: the longest of RUNS that leaves MIN_RUNS runs (a
    job's last run may be short), else the shortest."""
    assert Q.run_for(lengths) == run
    runs = sum(-(-n // run) for n in lengths)
    assert runs >= Q.MIN_RUNS or run == Q.RUNS[-1]
    if run != Q.RUNS[0]:
        assert sum(-(-n // (2 * run)) for n in lengths) < Q.MIN_RUNS


def test_open_many_matches_jax_host():
    """Opening proofs of a batch (two device vectors, one host vector,
    x = 0 among the points) on TorchEngine("cpu") equal the JAX
    package's KZG on its HostEngine over the same CRS."""
    from quill_tpu.pcs.kzg import KZG as JaxKZG

    n = 1 << 7
    jax_kzg = JaxKZG.trusted_setup(HostEngine(), n)
    eng = TorchEngine("cpu", min_device_size=16)
    kzg = KZG.trusted_setup(eng, n)
    polys = [_ints(40, 100), _ints(41, 60), _ints(42, 10)]
    xs = [R - 7, 0, 12345]
    got = kzg.open_many([(eng.vec_from_ints(p), x)
                         for p, x in zip(polys, xs)])
    want = jax_kzg.open_many([(HostEngine().vec_from_ints(p), x)
                              for p, x in zip(polys, xs)])
    for g, w in zip(got, want):
        assert (g.x, g.y) == (w.x, w.y)
        ga, wa = g.proof.to_affine(), w.proof.to_affine()
        assert (ga.x.v, ga.y.v, ga.infinity) == (wa.x.v, wa.y.v, wa.infinity)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = ctypes.CDLL(str(build.build_host()))
    lib.q_quotient_blocked.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p]
    lib.q_quotient_blocked.restype = None
    return lib


@pytest.mark.parametrize("n", [1, 2, 383, 4097, 9001])
@pytest.mark.parametrize("blk,run", [(1, 1), (4, 3), (128, 1), (128, 32)])
def test_blocked_phases_match_twin(lib, blk, run, n):
    """Kernel M's decomposition: tiles of blk runs of `run` coefficients,
    each run's map scanned from the top, then the recurrence again."""
    c = fd.from_ints(_ints(n * 7 + run, n))
    x = (n * 1000003 + blk) % R
    xw = torch.tensor(fd.mont_words(x), dtype=torch.int64).to(torch.int32)
    out = torch.zeros_like(c)
    y = torch.zeros(fd.NLIMB, dtype=torch.int32)
    lib.q_quotient_blocked(c.data_ptr(), n, xw.data_ptr(), blk, run,
                           out.data_ptr(), y.data_ptr())
    ys, outs = Q.scan_plain([c], [x])
    assert fd.FR.unmont(fd.tensor_to_ints(y[None])[0]) == ys[0]
    assert torch.equal(out, outs[0])
