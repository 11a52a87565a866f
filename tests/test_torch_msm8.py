"""The v8 MSM route of quill_tpu_torch (`ec/msm8.py`: kernel I's and
kernel E's plain twins on the CPU) against the JAX package's curve code.

- kernel I's twin against a serial fold with `quill_tpu.ec.curve`, for
  several flag patterns (its twin against the Pallas kernel itself is
  `tests/test_torch_seg_scan.py`);
- one MSM of three chunks (the chunk width cut to 64 points, the last
  chunk short) with zero scalars, 1, r - 1, one digit of 8191 per window
  and a point at infinity, against `quill_tpu.ec.curve.msm_host` and
  against the port's kernels C + D on the same scalars;
- `TorchEngine(msm_shift_max=0)` sends MSMs to this route, one at a time,
  and counts them;
- the collect's plain twin (dense, no compaction) against the earlier
  sparse collect (`probe_collect.collect_sparse`: `torch.nonzero`, kernel
  E's two modes, a gather and a scatter), the same triples, on chunks with
  absent digits, all-equal digits and runs across blocks.

The JAX route (`quill_tpu.ec.msm8.msm_device`) is not run: it does not
finish on a CPU.  Each v8 MSM runs its triangle over 20 x 8192 buckets,
~20 s of plain adds on one CPU thread, so this file runs one.
"""

import numpy as np
import pytest
import torch

from quill_tpu.ec import curve
from quill_tpu.fields.bn254 import R

from quill_tpu_torch.ec import device as ed
from quill_tpu_torch.ec import msm as M
from quill_tpu_torch.ec import msm8
from quill_tpu_torch.engine.device import TorchEngine
from quill_tpu_torch.fields import device as fd

torch.set_num_threads(1)

G = curve.g1_generator()
IDENT = curve.Jacobian.identity(curve.Fq(1))
INF = curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True)


def _ints(rng, n):
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % R
            for row in words]


def _points(rng, n):
    return [G.scalar_mul(int(k)) for k in rng.integers(2, 1 << 40, size=n)]


def _affine_ints(pt):
    a = pt.to_affine()
    return None if a.infinity else (a.x.v, a.y.v)


@pytest.mark.parametrize("pattern", ["none", "all", "first", "random"])
def test_seg_scan_twin_matches_host_fold(pattern):
    """y[t] = flag[t] ? x[t] : y[t-1] + x[t] per lane, identity entries
    included."""
    rng = np.random.default_rng(8)
    m, s = 3, 9
    pts = _points(rng, m * s)
    pts[4] = pts[13] = IDENT
    flags = {"none": np.zeros((m, s), bool), "all": np.ones((m, s), bool),
             "first": np.eye(m, s, dtype=bool),
             "random": rng.random((m, s)) < 0.4}[pattern]
    xs = ed.jacobians_to_proj(pts).reshape(m, s, 3, fd.NLIMB)
    got = msm8.seg_scan(xs, None if pattern == "none"
                        else torch.from_numpy(flags))
    got = ed.proj_to_jacobians(got.reshape(-1, 3, fd.NLIMB))
    for lane in range(m):
        acc = IDENT
        for t in range(s):
            x = pts[lane * s + t]
            acc = x if flags[lane, t] else acc.add(x)
            assert _affine_ints(got[lane * s + t]) == _affine_ints(acc), \
                (lane, t)


def test_three_chunk_msm_matches_host_and_cd(monkeypatch):
    """Chunks of 64 points: a 150-point basis has three, the last 22
    points long."""
    monkeypatch.setattr(msm8, "CHUNK", 64)
    rng = np.random.default_rng(9)
    n = 150
    pts = [p.to_affine() for p in _points(rng, n)]
    pts[70] = INF
    scalars = _ints(rng, n)
    scalars[:3] = [0, 1, R - 1]
    scalars[64:67] = [0, 0, R - 1]
    # one bucket per window: digit 8191 in window w only
    for w in range(19):
        scalars[80 + w] = 8191 << (13 * w)
    scalars[140:] = [0] * 10
    basis = M.load_basis(pts, "cpu")
    s = fd.from_ints(scalars)
    got = msm8.msm(basis, s)
    assert got == curve.msm_host(pts, scalars)
    assert got == M.msm(basis, s)


def test_engine_takes_v8_route(monkeypatch):
    """At msm_shift_max 0 every MSM over a nonempty basis takes v8, over
    a basis slice of its own length and the engine's Montgomery scalars;
    msm_many runs the jobs one at a time, each by its own route (an empty
    basis has no chunk: C + D, as `TpuEngine._msm_impl` sends it to v7).
    The v8 MSM itself is the test above's: here C + D's plain twins stand
    in for it, which saves a 20 x 8192-bucket triangle of plain adds."""
    calls = []

    def spy(basis, scalars):
        calls.append((basis.length, scalars.shape[0]))
        return M.msm(basis, scalars)

    monkeypatch.setattr(msm8, "msm", spy)
    rng = np.random.default_rng(10)
    pts = [p.to_affine() for p in _points(rng, 48)]
    eng = TorchEngine("cpu", min_device_size=1, msm_shift_max=0)
    basis = eng.load_points(pts)
    scalars = _ints(rng, 40)
    jobs = [(eng.basis_slice(basis, 40), eng.vec_from_ints(scalars)),
            (eng.basis_slice(basis, 0), eng.vec_from_ints([])),
            (eng.basis_slice(basis, 48), eng.vec_from_ints(scalars))]
    got = eng.msm_many(jobs)
    assert calls == [(40, 40), (48, 40)]
    assert got[0] == got[2] == curve.msm_host(pts[:40], scalars)
    assert got[1].is_identity()
    assert eng.msm_counts == {"small": 0, "small_batches": 0, "cd": 1,
                              "v8": 2}


@pytest.mark.parametrize("case", ["random", "equal", "runs"])
def test_collect_twin_matches_sparse_collect(case):
    """One chunk of 300 points (two blocks a window): uniform scalars (most
    digits absent), all scalars equal (one digit a window, its run across
    the block boundary), two runs of 150; into accumulators that hold
    points and identities."""
    from quill_tpu_torch.probe_collect import collect_sparse

    rng = np.random.default_rng(11)
    n = 300
    pts = [p.to_affine() for p in _points(rng, n)]
    pts[7] = INF
    basis = M.load_basis(pts, "cpu")
    ints = {"random": _ints(rng, n), "equal": [R - 12345] * n,
            "runs": _ints(rng, 1) * 150 + _ints(rng, 1) * 150}[case]
    canon = fd.from_mont(fd.from_ints(ints), fd.FR)
    sd, xs, fl = msm8.chunk_entries(canon, basis.xy, basis.inf)
    ys, wf, offs = msm8.chunk_scan(xs, fl)
    pool = ed.jacobians_to_proj(_points(rng, 15) + [IDENT])
    acc0 = pool[torch.from_numpy(rng.integers(
        0, 16, size=msm8.NWIN * msm8.NBUCK))]
    got = msm8.collect(sd, ys, wf, offs, acc0.clone())
    assert torch.equal(got, collect_sparse(sd, ys, wf, offs, acc0.clone()))
    assert not torch.equal(got, acc0)
