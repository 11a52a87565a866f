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
  absent digits, all-equal digits and runs across blocks;
- the entries' plain twin (`chunk_entries_plain`, which takes Montgomery
  scalars) against `fd.from_mont` followed by the entries step as the route
  ran it before it took Montgomery scalars (`_entries_of_canonical`),
  exactly, at ragged chunk widths and on edge scalars;
- the entries kernels' host emulation (`csrc/bn254_host.cpp:
  q_v8_entries_blocked`, over `csrc/entries.cuh`, built with g++: the
  digits, each segment's histograms, their prefixes, the place kernel's
  warps round by round, the gather) against that twin with `torch.equal`,
  at the kernels' segment width and at 64 (several segments a window), and
  on a whole chunk of 2^16 scalars; skips only without g++.

The JAX route (`quill_tpu.ec.msm8.msm_device`) is not run: it does not
finish on a CPU.  Each v8 MSM runs its triangle over 20 x 8192 buckets,
~20 s of plain adds on one CPU thread, so this file runs one.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from quill_tpu.ec import curve
from quill_tpu.fields.bn254 import R

from quill_tpu_torch.ec import device as ed
from quill_tpu_torch.ec import msm as M
from quill_tpu_torch.ec import msm5, msm8
from quill_tpu_torch.engine.device import TorchEngine
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.kernels import build

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
    sd, xs, fl = msm8.chunk_entries(fd.from_ints(ints), basis.xy, basis.inf)
    ys, wf, offs = msm8.chunk_scan(xs, fl)
    pool = ed.jacobians_to_proj(_points(rng, 15) + [IDENT])
    acc0 = pool[torch.from_numpy(rng.integers(
        0, 16, size=msm8.NWIN * msm8.NBUCK))]
    got = msm8.collect(sd, ys, wf, offs, acc0.clone())
    assert torch.equal(got, collect_sparse(sd, ys, wf, offs, acc0.clone()))
    assert not torch.equal(got, acc0)


def _entries_of_canonical(scs, xy, inf):
    """The entries step as the route ran it on canonical scalars (after
    `fd.from_mont` at the head of the MSM): digits, a stable sort, the
    points gathered, dead entries the identity, flags where digits change."""
    n = scs.shape[0]
    nb = -(-n // msm8.BS)
    d = msm5.window_digits(scs).T.to(torch.int32).contiguous()
    if nb * msm8.BS > n:
        d = torch.cat((d, d.new_zeros((msm8.NWIN, nb * msm8.BS - n))), 1)
    sorted_d, perm = torch.sort(d, dim=1, stable=True)
    pc = perm.clamp(max=n - 1)
    dead = (sorted_d == 0) | inf[pc]
    one = fd.const(1, fd.FQ, "cpu").expand(*pc.shape, 1, fd.NLIMB)
    pts = torch.cat((xy[pc], one), -2)
    pts = torch.where(dead[..., None, None], ed.identity(1, "cpu"), pts)
    flags = torch.ones_like(dead)
    flags[:, 1:] = sorted_d[:, 1:] != sorted_d[:, :-1]
    return (sorted_d, pts.reshape(msm8.NWIN * nb, msm8.BS, 3, fd.NLIMB),
            flags.reshape(msm8.NWIN * nb, msm8.BS))


def entries_case(case, seed):
    """-> (scalar ints, affine points) of one entries case: uniform
    scalars at the widths n1 .. n600 (a chunk of 1, one block short of
    full, one full, two and three ragged blocks), points at infinity, all
    scalars equal, all zero, r - 1 and 1 between uniform ones, and one run
    of equal scalars across a block boundary."""
    rng = np.random.default_rng(seed)
    n = int(case[1:]) if case.startswith("n") else 300
    pool = [p.to_affine() for p in _points(rng, 16)]
    pts = [pool[i] for i in rng.integers(0, 16, size=n)]
    ints = _ints(rng, n)
    if case == "inf":
        for i in (0, 7, 150, 299):
            pts[i] = INF
    elif case == "equal":
        ints = [R - 12345] * n
    elif case == "zero":
        ints = [0] * n
    elif case == "edges":
        ints[::3] = [R - 1] * len(ints[::3])
        ints[1::3] = [1] * len(ints[1::3])
    elif case == "cross":
        ints[200:280] = [ints[200]] * 80
    return ints, pts


ENTRY_CASES = ["n1", "n255", "n256", "n300", "n600", "inf", "equal", "zero",
               "edges", "cross"]


@pytest.mark.parametrize("case", ENTRY_CASES)
def test_entries_plain_takes_montgomery_scalars(case):
    ints, pts = entries_case(case, 12)
    basis = M.load_basis(pts, "cpu")
    s = fd.from_ints(ints)
    got = msm8.chunk_entries_plain(s, basis.xy, basis.inf)
    want = _entries_of_canonical(fd.from_mont(s, fd.FR), basis.xy,
                                 basis.inf)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # the CPU wrapper is the twin
    assert all(torch.equal(g, w) for g, w in zip(
        msm8.chunk_entries(s, basis.xy, basis.inf), want))


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = ctypes.CDLL(str(build.build_host()))
    vp, long_ = ctypes.c_void_p, ctypes.c_long
    lib.q_v8_entries_blocked.argtypes = [vp] * 3 + [long_] * 3 + [vp] * 3
    lib.q_v8_entries_blocked.restype = None
    return lib


@pytest.mark.parametrize("case,seg", [(c, s) for c in ENTRY_CASES
                                      for s in (msm8.SEG, 64)]
                         + [("n65536", msm8.SEG)])
def test_entries_kernels_emulated(host, case, seg):
    """The outputs start as garbage, so every position is written."""
    if case == "n65536":
        rng = np.random.default_rng(13)
        pool = [p.to_affine() for p in _points(rng, 16)]
        pool[3] = INF
        xy, inf = ed.affines_to_tensor(pool)
        pick = torch.from_numpy(rng.integers(0, 16, size=1 << 16))
        xy, inf = xy[pick].contiguous(), inf[pick].contiguous()
        s = fd.from_ints(_ints(rng, 1 << 16))
    else:
        ints, pts = entries_case(case, 14)
        basis = M.load_basis(pts, "cpu")
        xy, inf, s = basis.xy, basis.inf, fd.from_ints(ints)
    n = s.shape[0]
    nb = -(-n // msm8.BS)
    sd = torch.full((msm8.NWIN, nb * msm8.BS), -7, dtype=torch.int32)
    pts = torch.full((msm8.NWIN * nb, msm8.BS, 3, fd.NLIMB), 5,
                     dtype=torch.int32)
    flags = torch.ones((msm8.NWIN * nb, msm8.BS), dtype=torch.bool)
    host.q_v8_entries_blocked(s.data_ptr(), xy.data_ptr(), inf.data_ptr(),
                              n, nb * msm8.BS, seg, sd.data_ptr(),
                              pts.data_ptr(), flags.data_ptr())
    want = msm8.chunk_entries_plain(s, xy, inf)
    assert torch.equal(sd, want[0])
    assert torch.equal(pts, want[1])
    assert torch.equal(flags, want[2])
