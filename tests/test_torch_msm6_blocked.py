"""Kernel E's walk mode and its add, and the fused top as v6's prefix, on
the CPU: `csrc/query.cuh` and tree.cuh's staging maps run by their host
emulation (`csrc/bn254_host.cpp`: `q_query_walk`, `q_pt_add_blocked`,
`q_tree_top`, built with g++) against the plain chains they replace.

- the walk against `msm6.queries` (one flagged
  add a level, plain twins on the CPU) with `torch.equal`: the walk adds
  node + acc level by level as the chain does, so the triples are the
  chain's.  A small v6 tree (MIN_TOP cut to a few nodes, so that it keeps
  several levels) over affine multiples of G, and bucket counts 0, all
  ones, powers of two, the whole leaf count and random ones;
- the fused top in tree mode against `msm6.prefix` (Hillis-Steele): the
  same points (`ed.points_equal`; the triples differ), the total among
  them;
- kernel E's add, by threads and by lanes, with and without flags,
  against `msm5.pt_add_plain` with `torch.equal`, at widths around a
  block's span.

Skips only without g++.
"""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

from quill_tpu_torch.ec import curve
from quill_tpu_torch.ec import device as ed
from quill_tpu_torch.ec import msm5, msm6
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.kernels import build

torch.set_num_threads(1)

VP, LONG, INT = ctypes.c_void_p, ctypes.c_long, ctypes.c_int


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = ctypes.CDLL(str(build.build_host()))
    lib.q_query_walk.argtypes = [VP, LONG, VP, VP, INT, VP, VP, VP]
    lib.q_query_walk.restype = None
    lib.q_pt_add_blocked.argtypes = [VP, VP, VP, LONG, INT, VP]
    lib.q_pt_add_blocked.restype = None
    lib.q_tree_top.argtypes = [VP, INT, LONG, INT, VP]
    lib.q_tree_top.restype = INT
    return lib


@functools.lru_cache(maxsize=None)
def _pool():
    """48 affine multiples of G, (48, 2, 8), and their projective forms
    with Z != 1, (48, 3, 8)."""
    rng = np.random.default_rng(66)
    g = curve.g1_generator()
    pts = [g.scalar_mul(int(k)) for k in rng.integers(2, 1 << 40, size=48)]
    xy, _ = ed.affines_to_tensor([p.to_affine() for p in pts])
    return xy, msm5.pt_dbl_plain(ed.jacobians_to_proj(pts))


def _points(m, seed):
    """(m, 3, 8) projective points, about one in ten the identity."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 49, size=m)
    idx[rng.random(m) < 0.1] = 48
    proj = torch.cat((_pool()[1], ed.identity(1, "cpu")), 0)
    return proj[torch.from_numpy(idx)].contiguous()


@pytest.fixture(scope="module")
def v6_tree():
    """A v6 tree over 16 x 8 sorted leaves (rows of a 48-point pool in a
    random order) with its top at most 4 nodes wide: (sh, idx, levels,
    top, leaf count)."""
    sh = _pool()[0]
    rng = np.random.default_rng(67)
    fl = 16 * 8
    idx = torch.from_numpy(rng.integers(0, sh.shape[0], size=fl)).to(
        torch.int32)
    old = msm6.MIN_TOP
    msm6.MIN_TOP = 4
    try:
        levels = msm6.tree(sh, idx)
    finally:
        msm6.MIN_TOP = old
    assert len(levels) == 5 and levels[-1].shape[0] == 4
    return sh, idx, levels, msm6.prefix(levels[-1]), fl


def _walk(lib, cnt, tree):
    sh, idx, levels, top, _ = tree
    ptrs = (ctypes.c_uint64 * len(levels))(
        *[lv.data_ptr() for lv in levels[:-1]])
    out = torch.zeros((cnt.shape[0], 3, fd.NLIMB), dtype=torch.int32)
    lib.q_query_walk(cnt.data_ptr(), cnt.shape[0], top.data_ptr(), ptrs,
                     len(levels), sh.data_ptr(), idx.data_ptr(),
                     out.data_ptr())
    return out


def _counts(fl, seed):
    """Bucket counts: 0, all ones, powers of two, the whole leaf count,
    then random ones."""
    ones = [(1 << j) - 1 for j in range(1, fl.bit_length())]
    pows = [1 << j for j in range(fl.bit_length() - 1)]
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, fl + 1, size=40).tolist()
    return torch.tensor([0, 0, fl, fl - 1] + ones + pows + rand,
                        dtype=torch.int64)


def test_walk_matches_chain(lib, v6_tree):
    cnt = _counts(v6_tree[4], 68)
    sh, idx, levels, top, _ = v6_tree
    want = msm6.queries(cnt, sh, idx, levels, top)
    assert torch.equal(_walk(lib, cnt, v6_tree), want)
    assert torch.equal(msm6.query_walk(cnt, sh, idx, levels, top), want)


def test_walk_one_level(lib, v6_tree):
    """A tree whose top is its only level (kmin = 1): the walk is the top's
    prefix and one leaf."""
    sh, idx, levels, _, fl = v6_tree
    top = msm6.prefix(levels[0])
    tree = (sh, idx, levels[:1], top, fl)
    cnt = _counts(fl, 69)
    want = msm6.queries(cnt, sh, idx, levels[:1], top)
    assert torch.equal(_walk(lib, cnt, tree), want)


@pytest.mark.parametrize("w", [1, 2, 5, 64, 512])
def test_top_as_prefix(lib, w):
    """The fused top's prefixes are `msm6.prefix`'s points, the last one
    the level's total."""
    x = _points(w, 70 + w)
    out = torch.zeros_like(x)
    assert lib.q_tree_top(x.data_ptr(), w, 1, 1, out.data_ptr()) == 0
    want = msm6.prefix(x)
    assert bool(ed.points_equal(out, want).all())
    assert bool(ed.points_equal(msm5.tree_top(x), want).all())
    total = msm5.tree_reduce_plain(torch.cat(
        (x, ed.identity((1 << max(w - 1, 0).bit_length()) - w, "cpu"))),
        1 << max(w - 1, 0).bit_length())
    assert bool(ed.points_equal(out[-1:], total).all())


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("n", [1, 19, 20, 21, 128, 300])
def test_pt_add_blocked(lib, n, lanes):
    a, b = _points(n, 71 + n), _points(n, 72 + n)
    flags = torch.from_numpy(np.random.default_rng(n).random(n) < 0.3)
    for f in (None, flags):
        out = torch.zeros_like(a)
        fb = None if f is None else f.to(torch.uint8).contiguous()
        fp = None if fb is None else fb.data_ptr()
        lib.q_pt_add_blocked(a.data_ptr(), b.data_ptr(), fp, n, int(lanes),
                             out.data_ptr())
        assert torch.equal(out, msm5.pt_add_plain(a, b, f))
