"""Kernels C and D's decomposition on the CPU: `csrc/bucket.cuh` run by the
host emulations `q_bucket_sums_blocked` and `q_bucket_reduce_blocked`
(`csrc/bn254_host.cpp`, built with g++) against the plain twins
`msm.bucket_sums(..., plain=True)` and `msm.bucket_reduce_plain`.

Kernel C (`csrc/msm.cu`) gives each thread k consecutive sorted entries
across bucket boundaries; the runs that cross into a neighbour's range are
joined by a segmented scan over the threads of a block, then over the
blocks, then in one block.  Kernel D reduces segments of s buckets by the
running sum and weighs the segments by suffix scans, in a block and then
in a window.  The emulations run those phases for blocks of `blk` emulated
threads in the kernels' order (the kernels' own block is M.BLOCK), so
each case checks the decomposition the card runs.  They add in another
order than the twins, so the (X : Y : Z) triples may differ while the
points are equal: outputs are compared with `ed.points_equal`, and none
may be the degenerate (0 : 0 : 0).

Scalars: uniform; in {0, 1, 2} (a bucket over many threads); all 1 (every
entry in one bucket); one nonzero (one entry); below 2^16 (empty windows);
uniform against a basis with points at infinity.  k in {1, 3, 16, 128,
1000} (128 and 1000 above most buckets' lengths); D at 4,096 buckets a window
for several (s, blk), and once at the full 2^15.  Inputs come from a numpy
seed.  Skips only without g++.
"""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

from quill_tpu.ec import curve

from quill_tpu_torch.ec import device as ed
from quill_tpu_torch.ec import msm as M
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.kernels import build

torch.set_num_threads(1)

N = 300                     # basis points
PATTERNS = ("uniform", "012", "ones", "one", "low16", "infinity")
SUM_CASES = ((1, 4), (3, 4), (16, 128), (128, 64), (1000, 4))  # (k, blk)
REDUCE_CASES = ((16, 64), (2, 128), (32, 128), (4, 32), (1, 64))  # (s, blk)
NB = 4096                   # buckets a window in the reduced D cases
NWIN = 2                    # windows the D emulation runs


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = ctypes.CDLL(str(build.build_host()))
    lib.q_bucket_sums_blocked.argtypes = ([ctypes.c_void_p] * 3
                                          + [ctypes.c_long] * 4
                                          + [ctypes.c_void_p])
    lib.q_bucket_sums_blocked.restype = None
    lib.q_bucket_reduce_blocked.argtypes = ([ctypes.c_void_p]
                                            + [ctypes.c_long] * 4
                                            + [ctypes.c_void_p])
    lib.q_bucket_reduce_blocked.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _multiples():
    """64 multiples of G (Jacobian)."""
    rng = np.random.default_rng(71)
    g = curve.g1_generator()
    return [g.scalar_mul(int(k)) for k in rng.integers(2, 1 << 40, size=64)]


@functools.lru_cache(maxsize=None)
def _pool():
    return [p.to_affine() for p in _multiples()]


@functools.lru_cache(maxsize=None)
def _entries(pattern):
    """-> (xy, keys, entries) of N basis points drawn from the pool."""
    rng = np.random.default_rng(300 + PATTERNS.index(pattern))
    pts = [_pool()[i] for i in rng.integers(0, 64, size=N)]
    if pattern == "infinity":
        for i in rng.choice(N, size=N // 10, replace=False):
            pts[i] = curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True)
    xy, inf = ed.affines_to_tensor(pts, "cpu")
    if pattern in ("uniform", "infinity"):
        ints = [int.from_bytes(rng.bytes(31), "little") for _ in range(N)]
    elif pattern == "012":
        ints = [int(v) for v in rng.integers(0, 3, size=N)]
    elif pattern == "ones":
        ints = [1] * N
    elif pattern == "one":
        ints = [0] * N
        ints[int(rng.integers(N))] = int(rng.integers(1, 1 << 15))
    else:
        ints = [int(v) for v in rng.integers(0, 1 << 16, size=N)]
    s = fd.from_ints(ints, fd.FR, "cpu")
    keys, entries = M.sorted_entries(M.signed_digits(fd.from_mont(s, fd.FR)),
                                     inf)
    return xy.contiguous(), keys, entries


@functools.lru_cache(maxsize=None)
def _plain_sums(pattern):
    return M.bucket_sums(*_entries(pattern), plain=True)


def _not_degenerate(t):
    return bool((t != 0).any(-1).any(-1).all())


@pytest.mark.parametrize("k,blk", SUM_CASES)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_blocked_bucket_sums_match_twin(lib, pattern, k, blk):
    xy, keys, entries = _entries(pattern)
    want = _plain_sums(pattern)
    got = torch.zeros_like(want)
    lib.q_bucket_sums_blocked(xy.data_ptr(), keys.data_ptr(),
                              entries.data_ptr(), keys.shape[0], k, blk,
                              got.shape[0], got.data_ptr())
    assert _not_degenerate(got)
    occ = torch.unique(keys.to(torch.int64))
    assert bool(ed.points_equal(got[occ], want[occ]).all())
    rest = torch.ones(got.shape[0], dtype=torch.bool)
    rest[occ] = False
    assert torch.equal(got[rest], want[rest])      # untouched: the identity


def test_patterns_reach_the_fixup(lib):
    """The {0, 1, 2} and all-1 scalars put one bucket over many threads
    of k = 3; the one-entry case has a single entry."""
    for pattern in ("012", "ones"):
        _, counts = _entries(pattern)[1].unique_consecutive(
            return_counts=True)
        assert int(counts.max()) > 3 * 4 * 4     # over 4 blocks of 4 threads
    assert _entries("one")[1].shape[0] == 1


def _reduce(lib, dense, nb, s, blk):
    """The D emulation over the first nb buckets of the first NWIN windows
    -> (NWIN, 3, 8)."""
    part = dense.view(M.NWIN, M.NBUCK, 3, fd.NLIMB)[:NWIN, :nb].contiguous()
    out = torch.zeros((NWIN, 3, fd.NLIMB), dtype=torch.int32)
    assert lib.q_bucket_reduce_blocked(part.data_ptr(), NWIN, nb, s, blk,
                                       out.data_ptr()) == 0
    return out


@functools.lru_cache(maxsize=None)
def _dense(pattern):
    """Dense buckets: a pattern's bucket sums, or with "full" every bucket
    of the first NWIN windows a pool point."""
    if pattern != "full":
        return _plain_sums(pattern)
    rng = np.random.default_rng(99)
    pool = ed.jacobians_to_proj(_multiples())
    dense = ed.identity(M.NWIN * M.NBUCK, "cpu")
    dense[:NWIN * M.NBUCK] = pool[torch.from_numpy(
        rng.integers(0, 64, size=NWIN * M.NBUCK))]
    return dense


@functools.lru_cache(maxsize=None)
def _plain_reduce(pattern, nb):
    dense = _dense(pattern).clone()
    cut = dense.view(M.NWIN, M.NBUCK, 3, fd.NLIMB)
    cut[:, nb:] = ed.identity(1, "cpu")
    return M.bucket_reduce_plain(dense)[:NWIN]


@pytest.mark.parametrize("s,blk", REDUCE_CASES)
@pytest.mark.parametrize("pattern", ("uniform", "012", "one", "low16",
                                     "full"))
def test_blocked_bucket_reduce_matches_twin(lib, pattern, s, blk):
    got = _reduce(lib, _dense(pattern), NB, s, blk)
    assert _not_degenerate(got)
    assert bool(ed.points_equal(got, _plain_reduce(pattern, NB)).all())


@pytest.mark.parametrize("pattern", ("uniform", "012"))
def test_blocked_bucket_reduce_full_window(lib, pattern):
    """The kernel's own shape: 2^15 buckets a window, M.SEG buckets a
    thread, blocks of M.BLOCK."""
    got = _reduce(lib, _dense(pattern), M.NBUCK, M.SEG, M.BLOCK)
    assert _not_degenerate(got)
    assert bool(ed.points_equal(got,
                                _plain_reduce(pattern, M.NBUCK)).all())


def test_reduce_refuses_untiled_shapes(lib):
    out = torch.zeros((1, 3, fd.NLIMB), dtype=torch.int32)
    dense = ed.identity(M.NBUCK, "cpu")
    # 2^15 / (4 x 64) = 128 block items a window, above a block of 64
    assert lib.q_bucket_reduce_blocked(dense.data_ptr(), 1, M.NBUCK, 4, 64,
                                       out.data_ptr()) == -1
