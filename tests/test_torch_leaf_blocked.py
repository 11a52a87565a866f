"""Kernels F and K's one kernel, the affine leaf level, on the CPU:
`csrc/tree.cuh`'s gather map and thread body run by their host emulation
(`csrc/bn254_host.cpp: q_tree_leaf_blocked`, built with g++) against the
plain twins `msm5.tree_up0_plain` and `msm6.level0_plain` (gather, then
add) with `torch.equal`.

The kernel copies each block's pairs of leaves into shared memory through
the index (or rows 0 .. 2k - 1 without one), adds each pair in its slot
and writes the sums out.  The emulation runs the same
maps and bodies block by block, so widths of 1, 2 and odd numbers of
pairs, one block's span and more, the identity index, the sorts' real
indices and pairs of equal and opposite points (the v6 sort's clamped and
padded rows give P + P) are checked here before the card.  Points come
from a pool of multiples of G drawn with a numpy seed.  Skips only without
g++.
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
NT = 256                   # csrc/tree.cuh: LEAF_NT, pairs a block at L = 1
POOL = 48


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = ctypes.CDLL(str(build.build_host()))
    lib.q_tree_leaf_blocked.argtypes = [VP, VP, LONG, VP]
    lib.q_tree_leaf_blocked.restype = None
    lib.q_leaf_nt.restype = INT
    return lib


@functools.lru_cache(maxsize=None)
def _basis():
    """(2 POOL, 2, 8) affine rows: POOL multiples of G, then their
    negatives (row POOL + i is -row i)."""
    rng = np.random.default_rng(71)
    g = curve.g1_generator()
    aff = [g.scalar_mul(int(k)).to_affine()
           for k in rng.integers(2, 1 << 40, size=POOL)]
    neg = [curve.Affine(a.x, -a.y) for a in aff]
    xy, _ = ed.affines_to_tensor(aff + neg)
    return xy


def _leaf(lib, sh, idx, k):
    out = torch.zeros((k, 3, fd.NLIMB), dtype=torch.int32)
    lib.q_tree_leaf_blocked(sh.data_ptr(),
                            None if idx is None else idx.data_ptr(), k,
                            out.data_ptr())
    return out


def _index(k, seed):
    """2k random rows of the pool, with a pair P + P and a pair P + (-P)
    where k allows."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 2 * POOL, size=2 * k)
    if k >= 2:
        idx[2:4] = idx[2]                       # P + P
        idx[1] = (idx[0] + POOL) % (2 * POOL)   # P + (-P)
    return torch.from_numpy(idx.astype(np.int32))


def test_leaf_nt_is_tree_cuh(lib):
    assert lib.q_leaf_nt() == NT


@pytest.mark.parametrize("k", (1, 2, 3, 7, NT - 1, NT, NT + 1, 2 * NT,
                               2 * NT + 5, 4 * NT + 6))
def test_one_level_through_an_index(lib, k):
    sh = _basis()
    idx = _index(k, 10 + k)
    o1 = _leaf(lib, sh, idx, k)
    assert torch.equal(o1, msm5.tree_up0_plain(sh, idx))
    assert torch.equal(o1, msm6.level0_plain(sh, idx))


@pytest.mark.parametrize("k", (1, 2, 5, NT, NT + 3, 2 * NT + 1))
def test_one_level_identity_index(lib, k):
    """No index: the 2k leaves are rows 0 .. 2k - 1 (the contiguous form
    that `prefix_tree_chain` and the tests use)."""
    leaves = _basis()[_index(k, 20 + k).to(torch.int64)].contiguous()
    o1 = _leaf(lib, leaves, None, k)
    assert torch.equal(o1, msm5.tree_up0_plain(leaves))


def test_equal_and_opposite_pairs(lib):
    """P + P doubles, P + (-P) is the identity (0 : Y : 0), both in the
    plain twin's triples."""
    sh = _basis()
    idx = torch.tensor([3, 3, 5, 5 + POOL, POOL + 7, 7, 9, 9],
                       dtype=torch.int32)
    o1 = _leaf(lib, sh, idx, 4)
    assert torch.equal(o1, msm5.tree_up0_plain(sh, idx))
    pts = ed.proj_to_jacobians(o1)
    assert pts[1].is_identity() and pts[2].is_identity()
    p3 = ed.proj_to_jacobians(
        torch.cat((sh[3:4], fd.const(1, fd.FQ, "cpu").expand(1, 1, 8)), 1))
    assert pts[0] == p3[0].double()


def _rows(r):
    """r affine rows standing in for a shifted basis: the pool's, tiled."""
    return _basis()[torch.arange(r) % (2 * POOL)].contiguous()


def _scalars(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 1 << 29, size=shape)
                            .astype(np.int32))


def test_small_route_sort_index(lib):
    """The small route's own index: 2 MSMs of 9 points (one at infinity,
    its digits forced to 0), `sort_leaves`' rows of a 20 x 9-row basis."""
    inf = torch.zeros(9, dtype=torch.bool)
    inf[4] = True
    sh = _rows(msm5.NWIN * 9)
    keys, idx = msm5.sort_leaves(_scalars((2, 9, 8), 41), inf)
    assert idx.dtype == torch.int32 and idx.shape == (2 * msm5.NWIN * 9,)
    assert int(idx.max()) < sh.shape[0]
    k = idx.shape[0] // 2
    o1 = _leaf(lib, sh, idx, k)
    assert torch.equal(o1, msm5.tree_up0_plain(sh, idx))


def test_v6_sort_index(lib):
    """v6's index: a 20-point MSM pads its flat space to 16 x 32 elements,
    the padding clamped to the last real row, so pairs of equal points."""
    inf = torch.zeros(20, dtype=torch.bool)
    _, idx = msm6.sort_keys(_scalars((20, 8), 42), inf, 20)
    assert idx.shape == (msm6.NWIN * 32,)
    sh = _rows(msm6.NWIN * 20)
    k = idx.shape[0] // 2
    assert torch.equal(_leaf(lib, sh, idx, k), msm6.level0_plain(sh, idx))
