"""Kernel B's tile passes on the CPU: `csrc/ntt.cuh` run by the host
emulations `q_ntt_pass_blocked` and `q_ntt_twiddles` (`csrc/bn254_host.cpp`,
built with g++) against the plain twins `ntt.pass_plain` and
`ntt.twiddle_table_plain`.

The kernel holds tiles of 2^11 elements; the emulation runs the same
schedule (`ntt.plan`) with tiles of 2^3 to 2^6, so short vectors still take
several strided passes (tiles of many columns) and one contiguous pass.
Every pass of a product -- a's forward passes, b's forward passes, the
fused product pass, the inverse passes -- is held to its twin exactly, and
the emulated product to the plain `ntt.poly_mul` (which plans with the
kernel's tile) and the schoolbook product.  Inputs come from a numpy seed.
Skips only without g++.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.fields.bn254 import FR_TWO_ADICITY, R
from quill_tpu_torch.kernels import build
from quill_tpu_torch.poly import ntt

torch.set_num_threads(1)

VP, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
# (tile_log, logn): lengths 2^4 to 2^14 over tiles of 2^3 to 2^6
CASES = [(3, 4), (3, 9), (3, 14), (4, 4), (4, 11), (5, 7), (5, 13),
         (6, 6), (6, 10), (6, 14)]


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = ctypes.CDLL(str(build.build_host()))
    lib.q_ntt_pass_blocked.argtypes = [VP, VP, I64, VP, VP] + [I32] * 6 + [VP]
    lib.q_ntt_pass_blocked.restype = None
    lib.q_ntt_twiddles.argtypes = [VP, I32, VP]
    lib.q_ntt_twiddles.restype = None
    return lib


@pytest.fixture(scope="module")
def table():
    return ntt.twiddle_table_plain(14, "cpu")


def _rand(seed, n):
    rng = np.random.default_rng(seed)
    return fd.from_ints([int.from_bytes(rng.bytes(32), "little") % R
                         for _ in range(n)])


def _emulate(lib, src, dst, valid, logn, b0, s, logc, tw, dif=False,
             dit=False, y=None, scale=None):
    words = None
    if scale is not None:
        words = (ctypes.c_uint32 * 8)(*fd.mont_words(scale))
    lib.q_ntt_pass_blocked(
        src.data_ptr(), dst.data_ptr(), valid,
        None if y is None else y.data_ptr(), tw.data_ptr(), logn, b0, s,
        logc, int(dif), int(dit),
        None if words is None else ctypes.addressof(words))


def _chain(lib, x, logn, steps, tw):
    """Each step emulated and by its twin, from the same input; -> the
    emulated result."""
    n = 1 << logn
    got = torch.empty((n, fd.NLIMB), dtype=torch.int32)
    want = torch.empty_like(got)
    src, valid = x.contiguous(), x.shape[0]
    for step in steps:
        _emulate(lib, src, got, valid, logn, tw=tw, **step)
        ntt.pass_plain(src, want, valid, logn, tw=tw, **step)
        assert torch.equal(got, want), step
        src, valid = got.clone(), n
    return got


@pytest.mark.parametrize("tile_log,logn", CASES)
def test_product_passes_match_twins(lib, table, tile_log, logn):
    n = 1 << logn
    la, lb = n // 2, n // 2 - 3 if n > 8 else n // 2
    a, b = _rand(logn, la), _rand(100 + logn, lb)
    passes = ntt.plan(logn, tile_log)
    assert len(passes) >= (2 if logn > tile_log else 1)
    for b0, s, logc in passes:
        assert s + logc <= tile_log and logc <= b0
    fa = _chain(lib, a, logn, ntt.forward_steps(passes), table)
    got = _chain(lib, b, logn, ntt.product_steps(passes, fa, logn), table)
    assert torch.equal(got, ntt.poly_mul(a, b))
    if logn <= 9:
        xs, ys = fd.to_ints(a), fd.to_ints(b)
        want = [0] * (la + lb - 1)
        for i, x in enumerate(xs):
            for j, y in enumerate(ys):
                want[i + j] = (want[i + j] + x * y) % R
        assert fd.to_ints(got) == want + [0] * (n - len(want))


@pytest.mark.parametrize("tile_log,logn", [(3, 5), (5, 12)])
def test_transform_roundtrip_and_order(lib, table, tile_log, logn):
    """Forward passes leave the bit-reversed DFT; the inverse passes, the
    first scaled by 1/n, return the input."""
    n = 1 << logn
    x = _rand(7 + logn, n)
    passes = ntt.plan(logn, tile_log)
    f = _chain(lib, x, logn, ntt.forward_steps(passes), table)
    if logn <= 5:
        w = ntt.root_of_unity(n)
        xs = fd.to_ints(x)
        dft = [sum(v * pow(w, i * k, R) for i, v in enumerate(xs)) % R
               for k in range(n)]
        rev = [int(format(p, f"0{logn}b")[::-1], 2) for p in range(n)]
        assert fd.to_ints(f) == [dft[rev[p]] for p in range(n)]
    steps = ntt.inverse_steps(passes)
    steps[0]["scale"] = pow(n, R - 2, R)
    assert torch.equal(_chain(lib, f, logn, steps, table), x)


def test_twiddle_table_matches_twin(lib):
    logn = 12
    roots = (ctypes.c_uint32 * (8 * 29))(
        *[w for m in range(FR_TWO_ADICITY + 1)
          for w in fd.mont_words(ntt.root_of_unity(1 << m))])
    got = torch.empty((ntt.tw_rows(logn), fd.NLIMB), dtype=torch.int32)
    lib.q_ntt_twiddles(got.data_ptr(), logn, ctypes.addressof(roots))
    want = ntt.twiddle_table_plain(logn, "cpu")
    assert torch.equal(got, want)
    # row b: w^j of order 2^(b+1), the last entry -1
    b = 5
    row = fd.to_ints(want[ntt.tw_rows(b):ntt.tw_rows(b + 1)])
    w = ntt.root_of_unity(2 << b)
    assert row == [pow(w, j, R) for j in range((1 << b) + 1)]
    assert row[-1] == R - 1
