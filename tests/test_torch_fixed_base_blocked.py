"""Kernel J's decomposition on the CPU: `csrc/fixed_base.cuh` run by its
host emulation (`csrc/bn254_host.cpp`: `q_fixed_base_blocked`, built with
g++) against kernel J's plain twin (`fixed_base.fixed_base_plain`, then
`msm5.to_affine`) and the host curve.

The kernel gives each block FB_SPAN points, a thread FB_PPT of them one
after another, and normalises the block with one inversion (a product
tree over the threads' running products); the emulation runs the same
phases for every thread in turn.  Affine rows are unique, so every
comparison is `torch.equal`.  Checked here: the signed digits (with and
without zero digits, carries through all-ones windows), blocks at widths
that are and are not a multiple of the span, the wide tables' entries at
sampled (w, d) against the host curve's scalar products, and a point at
infinity, which sets the flag and writes (0, 0).  Skips only without g++.
"""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

from quill_tpu_torch.ec import curve
from quill_tpu_torch.ec import fixed_base as fb
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.fields.bn254 import R
from quill_tpu_torch.kernels import build

torch.set_num_threads(1)

VP, LONG, INT = ctypes.c_void_p, ctypes.c_long, ctypes.c_int


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = ctypes.CDLL(str(build.build_host()))
    lib.q_fixed_base_blocked.argtypes = [VP, LONG, VP, INT, INT, VP, VP]
    lib.q_fixed_base_blocked.restype = None
    lib.q_fb_ppt.argtypes = [LONG, INT, INT]
    lib.q_fb_ppt.restype = INT
    lib.q_fb_digits.argtypes = [VP, INT, VP]
    lib.q_fb_digits.restype = None
    lib.q_fb_windows.argtypes = [INT]
    lib.q_fb_windows.restype = INT
    lib.q_fb_span.restype = INT
    return lib


def _emulate(lib, scalars, table, w, ppt=4):
    """-> ((n, 2, 8) affine rows, flag) by the emulated kernel, ppt points
    a thread."""
    n = scalars.shape[0]
    out = torch.full((n, 2, fd.NLIMB), -1, dtype=torch.int32)
    flag = ctypes.c_int(0)
    lib.q_fixed_base_blocked(scalars.contiguous().data_ptr(), n,
                             table.contiguous().data_ptr(), w, ppt,
                             out.data_ptr(), ctypes.byref(flag))
    return out, flag.value


@functools.lru_cache(maxsize=None)
def _table(w):
    """The w-bit table as the card makes it: the emulated kernel over the
    4-bit host table (the host table itself at w = 4)."""
    boot = fb.boot_table()
    if w == fb.BOOT_W:
        return boot
    lib = ctypes.CDLL(str(build.build_host()))
    lib.q_fixed_base_blocked.argtypes = [VP, LONG, VP, INT, INT, VP, VP]
    s = fb.table_scalars(w).reshape(-1, fd.NLIMB)
    out, flag = _emulate(lib, s, boot, fb.BOOT_W)
    assert flag == 0
    return out.reshape(fb.windows(w), 1 << (w - 1), 2, fd.NLIMB)


def _scalars(n, seed, w):
    """n canonical scalars below r: edges (1, r - 1, all-ones windows, zero
    windows, a single bit) first, then uniform ones."""
    rng = np.random.default_rng(seed)
    edges = [1, 2, R - 1, R - 2, (1 << 253) - 1, 1 << 200,
             ((1 << w) - 1) << w, (1 << (w - 1)) << (3 * w), 12345 << (5 * w)]
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [sum(int(x) << (32 * i) for i, x in enumerate(row)) % R
            for row in words]
    vals[:len(edges)] = edges[:n]
    return vals


def _host(vals):
    g = curve.g1_generator()
    return [g.scalar_mul(v).to_affine() for v in vals]


def test_constants_match_header(lib):
    """The span, the windows, and the points a thread: 4, halved while a
    launch would not give each SM 2 blocks (132 SMs)."""
    assert lib.q_fb_span() == 512
    assert [lib.q_fb_ppt(n, 132, 2) for n in (
        1, 1 << 16, (1 << 16) * 2, 135168, (1 << 18) + 1, (1 << 22) + 1)] == \
        [1, 1, 2, 4, 4, 4]
    for w in range(1, 17):
        assert lib.q_fb_windows(w) == fb.windows(w)
        assert fb.windows(w) * w >= 255 > (fb.windows(w) - 1) * w


@pytest.mark.parametrize("w", [1, 4, 5, 8, 13, 16])
def test_signed_digits(lib, w):
    """fb_digit and the twin's `signed_digits` agree, stay within
    2^(w-1) and sum back to the scalar; zero digits occur."""
    vals = _scalars(40, w, w) + [0]
    s = fd.ints_to_tensor(vals)
    digits = fb.signed_digits(s, w)
    half = 1 << (w - 1)
    assert int(digits.abs().max()) <= half
    out = np.zeros(fb.windows(w), np.int32)
    zeros = 0
    for i, v in enumerate(vals):
        lib.q_fb_digits(s[i].contiguous().data_ptr(), w, out.ctypes.data)
        assert out.tolist() == digits[i].tolist()
        assert sum(int(d) << (w * k) for k, d in enumerate(out)) == v
        zeros += int((out == 0).sum())
    assert zeros > 0


@pytest.mark.parametrize("w,n,ppt", [(4, 1, 4), (4, 512, 4), (4, 700, 4),
                                     (5, 513, 4), (8, 96, 4), (4, 300, 1),
                                     (5, 257, 2)])
def test_blocked_matches_twin(lib, w, n, ppt):
    """The emulated kernel against the twin (plain projective sums, then
    `to_affine`), exactly, at one point, one whole block and a block and
    a part, with 4, 2 and 1 points a thread; and against the host curve
    on the first four points."""
    vals = _scalars(n, 100 + n, w)
    s = fd.ints_to_tensor(vals)
    table = _table(w)
    got, flag = _emulate(lib, s, table, w, ppt)
    assert flag == 0
    assert torch.equal(got, fb.fixed_base_twin(s, table, w))
    want = _host(vals[:4])
    xy = fd.to_ints(got[:4].reshape(-1, fd.NLIMB), fd.FQ)
    assert xy == [c for p in want for c in (p.x.v, p.y.v)]


@pytest.mark.parametrize("w", [5, 8, 10])
def test_wide_table_entries(w):
    """Rows (k, |d| - 1) of the card's w-bit table equal |d| 2^(w k) G at
    sampled (k, d), the first and last rows of each end window among
    them; its scalars are |d| 2^(w k) mod r."""
    table = _table(w)
    half = 1 << (w - 1)
    rng = np.random.default_rng(w)
    picks = {(0, 1), (0, half), (fb.windows(w) - 1, 1),
             (fb.windows(w) - 1, half)}
    picks |= {(int(k), int(d)) for k, d in zip(
        rng.integers(0, fb.windows(w), 8), rng.integers(1, half + 1, 8))}
    picks = sorted(picks)
    scal = fd.tensor_to_ints(fb.table_scalars(w).reshape(-1, fd.NLIMB))
    vals = [(d << (w * k)) % R for k, d in picks]
    assert [scal[k * half + d - 1] for k, d in picks] == vals
    rows = torch.stack([table[k, d - 1] for k, d in picks])
    xy = fd.to_ints(rows.reshape(-1, fd.NLIMB), fd.FQ)
    assert xy == [c for p in _host(vals) for c in (p.x.v, p.y.v)]


def test_point_at_infinity_sets_flag(lib):
    """s = 0 and s = r: the flag, rows (0, 0), the other rows right; the
    twin raises."""
    vals = [5, 0, 7, R]
    s = fd.ints_to_tensor(vals)
    table = _table(fb.BOOT_W)
    got, flag = _emulate(lib, s, table, fb.BOOT_W)
    assert flag == 1
    assert not bool(got[1].any()) and not bool(got[3].any())
    ok = fd.ints_to_tensor([5, 7])
    assert torch.equal(got[[0, 2]], fb.fixed_base_twin(ok, table, fb.BOOT_W))
    with pytest.raises(ValueError):
        fb.fixed_base_twin(s, table, fb.BOOT_W)


def test_window_rule():
    """The rule keeps small CRSs on the 4-bit host table, widens with the
    CRS, and stays within the card's range."""
    ws = [fb.window_for(n) for n in (1, 65, 1 << 12, 1 << 16,
                                     (1 << 18) + 1, (1 << 22) + 1)]
    assert ws[0] == ws[1] == fb.BOOT_W
    assert ws == sorted(ws)
    assert all(w == fb.BOOT_W or w in fb.W_RANGE for w in ws)
    assert ws[-1] > ws[-2] > fb.BOOT_W
