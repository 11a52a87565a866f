"""Kernel I's decomposition on the CPU: `csrc/seg_scan.cuh` run by its host
emulation `q_seg_scan_blocked` (`csrc/bn254_host.cpp`, built with g++)
against the serial plain twin `msm8.seg_scan_plain`.

Kernel I (`csrc/msm8.cu`) splits each lane of s steps over T threads: each
scans a run of ceil(s / T) steps, the run totals are scanned with the
segmented operator, and each run adds its carry-in to its steps before its
first flag.  The emulation runs those phases for T threads in the kernel's
order, so every T and flag pattern below checks the decomposition the card
runs.  It adds in another order than the twin, so the (X : Y : Z) triples
may differ while the points are equal: outputs are compared with
`ed.points_equal`, and none may be the degenerate (0 : 0 : 0).

m = 3 lanes; s in {1, 7, 32, 256}; T in {1, 2, 16, 256} (T above s too);
flags none, all, at every run boundary, only at the last step, and random
at densities 1/8 and 1/64; points drawn from a pool of multiples of G with
identities among them, from a numpy seed.  Skips only without g++.
"""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

from quill_tpu.ec import curve

from quill_tpu_torch.ec import device as ed
from quill_tpu_torch.ec import msm8
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.kernels import build

torch.set_num_threads(1)

M = 3
STEPS = (1, 7, 32, 256)
THREADS = (1, 2, 16, 256)
PATTERNS = ("none", "all", "boundary", "last", "random8", "random64")


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = ctypes.CDLL(str(build.build_host()))
    lib.q_seg_scan_blocked.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_long, ctypes.c_long,
                                       ctypes.c_long, ctypes.c_void_p]
    lib.q_seg_scan_blocked.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _pool():
    """64 multiples of G and the identity, as (65, 3, 8) projective."""
    rng = np.random.default_rng(51)
    g = curve.g1_generator()
    pts = [g.scalar_mul(int(k)) for k in rng.integers(2, 1 << 40, size=64)]
    return ed.jacobians_to_proj(pts + [curve.Jacobian.identity(curve.Fq(1))])


@functools.lru_cache(maxsize=None)
def _points(s):
    """(M, s, 3, 8) points, about one in ten the identity."""
    rng = np.random.default_rng(1000 + s)
    idx = rng.integers(0, 64, size=M * s)
    idx[rng.random(M * s) < 0.1] = 64
    return _pool()[torch.from_numpy(idx)].reshape(M, s, 3, fd.NLIMB)


def _flags(pattern, s, t):
    if pattern == "none":
        return None
    if pattern == "all":
        f = np.ones((M, s), bool)
    elif pattern == "boundary":
        r = -(-s // t)
        f = np.zeros((M, s), bool)
        f[:, ::r] = True
    elif pattern == "last":
        f = np.zeros((M, s), bool)
        f[:, -1] = True
    else:
        rng = np.random.default_rng(s * 7 + len(pattern))
        f = rng.random((M, s)) < 1 / int(pattern[len("random"):])
    return torch.from_numpy(f)


@functools.lru_cache(maxsize=None)
def _twin(pattern, s, t):
    # only the boundary pattern depends on T
    return msm8.seg_scan_plain(_points(s), _flags(pattern, s, t))


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("t", THREADS)
@pytest.mark.parametrize("s", STEPS)
def test_blocked_scan_matches_twin(lib, s, t, pattern):
    xs = _points(s).contiguous()
    flags = _flags(pattern, s, t)
    fb = None if flags is None else flags.to(torch.uint8).contiguous()
    ys = torch.zeros_like(xs)
    lib.q_seg_scan_blocked(xs.data_ptr(),
                           None if fb is None else fb.data_ptr(),
                           M, s, t, ys.data_ptr())
    want = _twin(pattern, s, t if pattern == "boundary" else 0)
    got = ys.reshape(-1, 3, fd.NLIMB)
    assert bool((got != 0).any(-1).any(-1).all())
    assert bool(ed.points_equal(got, want.reshape(-1, 3, fd.NLIMB)).all())
