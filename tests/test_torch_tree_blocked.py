"""Kernels G and H's decomposition on the CPU: `csrc/tree.cuh` run by its
host emulation (`csrc/bn254_host.cpp`: `q_tree_up_blocked`,
`q_tree_down_blocked`, `q_tree_top`, built with g++) against the chains of
one-level plain twins (`msm5.tree_up_plain`, `msm5.tree_down_plain`) and
`msm5.prefix_tree_chain`.

The kernels stage each block's span through shared memory by the maps of
tree.cuh and add in slots; the emulation runs the same maps and thread
bodies block by block, so the two-level launches (G: two levels up; H: two
levels of prefixes down), the fused top in tree and reduce mode, odd
widths (identity padding), 1- and 2-point levels and levels wider than one
block are all checked here before the card.  Every output is the same
projective triple as the chain's (`torch.equal`), because the kernels keep
the chain's pairing order and its adds with the identity.  The prefixes of
the whole tree are also held, as points, against the prefix sums of the
same leaves by the JAX package's host curve (`quill_tpu.ec.curve`).

Points come from a pool of multiples of G (with the identity among the
projective ones), drawn with a numpy seed.  Skips only without g++.
"""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

from quill_tpu.ec import curve as ref_curve

from quill_tpu_torch.ec import curve
from quill_tpu_torch.ec import device as ed
from quill_tpu_torch.ec import msm5
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.kernels import build

torch.set_num_threads(1)

VP, LONG, INT = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
NT = 256                   # csrc/tree.cuh: TREE_NT
# level widths: 1- and 2-point levels, odd ones, one block's span of a
# two-level launch by threads (4 NT) and wider; by lanes a block spans 32
WIDTHS = (1, 2, 3, 5, 6, 7, 13, 64, 4 * NT, 4 * NT + 1, 2100)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = ctypes.CDLL(str(build.build_host()))
    lib.q_tree_up_blocked.argtypes = [INT, INT, VP, LONG, VP, VP]
    lib.q_tree_up_blocked.restype = None
    lib.q_tree_down_blocked.argtypes = [INT, INT, VP, VP, VP, LONG, VP]
    lib.q_tree_down_blocked.restype = None
    lib.q_tree_lanes.argtypes = [LONG]
    lib.q_tree_lanes.restype = INT
    lib.q_tree_top.argtypes = [VP, INT, LONG, INT, VP]
    lib.q_tree_top.restype = INT
    lib.q_tree_nt.restype = INT
    lib.q_tree_top_width.restype = INT
    lib.q_tree_lane_level.restype = LONG
    return lib


def test_constants_match_tree_cuh(lib):
    """NT here and `msm5.TOP` and `msm5.LANE_LEVEL` are tree.cuh's."""
    assert lib.q_tree_nt() == NT
    assert lib.q_tree_top_width() == msm5.TOP
    assert lib.q_tree_lane_level() == msm5.LANE_LEVEL
    assert lib.q_tree_lanes(msm5.LANE_LEVEL)
    assert not lib.q_tree_lanes(msm5.LANE_LEVEL + 1)


@functools.lru_cache(maxsize=None)
def _pool():
    """64 multiples of G: (64, 3, 8) projective with their Z's, the affine
    forms (64, 2, 8) and the JAX package's affine points."""
    rng = np.random.default_rng(61)
    g = curve.g1_generator()
    pts = [g.scalar_mul(int(k)) for k in rng.integers(2, 1 << 40, size=64)]
    aff = [p.to_affine() for p in pts]
    xy, _ = ed.affines_to_tensor(aff)
    ref = [ref_curve.Affine(ref_curve.Fq(a.x.v), ref_curve.Fq(a.y.v), False)
           for a in aff]
    return ed.jacobians_to_proj(pts), xy, ref


def _points(m, seed):
    """(m, 3, 8) projective points, about one in ten the identity."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 65, size=m)
    idx[rng.random(m) < 0.1] = 64
    proj = torch.cat((_pool()[0], ed.identity(1, "cpu")), 0)
    return proj[torch.from_numpy(idx)].contiguous()


def _half(m):
    return (m + 1) // 2


def _up(lib, level, x, lanes=None):
    """G emulated; lanes None: as the launch picks (`tree_lanes`)."""
    m = x.shape[0]
    if lanes is None:
        lanes = level == 2 and lib.q_tree_lanes(m)
    o1 = torch.zeros((_half(m), 3, fd.NLIMB), dtype=torch.int32)
    o2 = torch.zeros((_half(_half(m)), 3, fd.NLIMB), dtype=torch.int32)
    lib.q_tree_up_blocked(level, int(lanes), x.data_ptr(), m, o1.data_ptr(),
                          o2.data_ptr())
    return o1, o2


def _down2(lib, p, u1, u0, lanes=None):
    m = u0.shape[0]
    if lanes is None:
        lanes = lib.q_tree_lanes(m)
    out = torch.zeros_like(u0)
    lib.q_tree_down_blocked(2, int(lanes), p.data_ptr(), u1.data_ptr(),
                            u0.data_ptr(), m, out.data_ptr())
    return out


def _top(lib, x, w, blocks, tree):
    out = torch.zeros((w if tree else blocks, 3, fd.NLIMB),
                      dtype=torch.int32)
    assert lib.q_tree_top(x.data_ptr(), w, blocks, int(tree),
                          out.data_ptr()) == 0
    return out


@pytest.mark.parametrize("lanes", (False, True))
@pytest.mark.parametrize("m", WIDTHS)
def test_up_two_levels(lib, m, lanes):
    x = _points(m, 100 + m)
    o1, o2 = _up(lib, 2, x, lanes)
    a = msm5.tree_up_plain(msm5._pad(x))
    assert torch.equal(o1, a)
    assert torch.equal(o2, msm5.tree_up_plain(msm5._pad(a)))


@pytest.mark.parametrize("m", (2, 6, 2 * NT, 2 * NT + 2, 1300))
def test_up_one_level(lib, m):
    x = _points(m, 200 + m)
    o1, _ = _up(lib, 1, x)
    assert torch.equal(o1, msm5.tree_up_plain(x))


@pytest.mark.parametrize("lanes", (False, True))
@pytest.mark.parametrize("m", WIDTHS)
def test_down_two_levels(lib, m, lanes):
    u0 = _points(m, 300 + m)
    u1 = _points(_half(m), 400 + m)
    p = _points(_half(_half(m)), 500 + m)
    got = _down2(lib, p, u1, u0, lanes)
    # the chain: level l + 1's prefixes from p, then level l's
    p1 = msm5.tree_down_plain(p, msm5._pad(u1))[:u1.shape[0]]
    want = msm5.tree_down_plain(p1, msm5._pad(u0))[:m]
    assert torch.equal(got, want)
    assert torch.equal(got, msm5.tree_down2_plain(p, u1, u0))


@pytest.mark.parametrize("k", (1, 3, NT, NT + 1, 550))
def test_down_one_level(lib, k):
    i, u = _points(k, 600 + k), _points(2 * k, 700 + k)
    out = torch.zeros_like(u)
    lib.q_tree_down_blocked(1, 0, i.data_ptr(), None, u.data_ptr(), 2 * k,
                            out.data_ptr())
    assert torch.equal(out, msm5.tree_down_plain(i, u))


@pytest.mark.parametrize("w", (1, 2, 3, 5, 7, 160, 333, msm5.TOP))
def test_top_tree_mode(lib, w):
    x = _points(w, 800 + w)
    assert torch.equal(_top(lib, x, w, 1, True), msm5.tree_top_plain(x))


@pytest.mark.parametrize("w,blocks", [(1, 3), (2, 5), (32, 4), (msm5.TOP, 2)])
def test_top_reduce_mode(lib, w, blocks):
    x = _points(w * blocks, 900 + w)
    assert torch.equal(_top(lib, x, w, blocks, False),
                       msm5.tree_reduce_plain(x, w))


def test_top_refuses_outside_its_limits(lib):
    x = _points(2 * msm5.TOP, 1000)
    out = torch.zeros((2 * msm5.TOP, 3, fd.NLIMB), dtype=torch.int32)
    for w, blocks, tree in ((msm5.TOP + 1, 1, 1), (0, 1, 1), (3, 2, 0),
                            (4, 2, 1)):
        assert lib.q_tree_top(x.data_ptr(), w, blocks, tree,
                              out.data_ptr()) == -1


def _leaves(t, seed):
    """t affine leaves from the pool, and the JAX package's points."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 64, size=t)
    _, xy, ref = _pool()
    return xy[torch.from_numpy(idx)].contiguous(), [ref[i] for i in idx]


def _blocked_prefix_tree(lib, leaves, top, lanes):
    """`msm5.prefix_tree` on the emulated kernels, its top at `top` <=
    TREE_TOP points: F's plain twin, G two levels a launch, the top, H;
    lanes None as the launches pick, False every add a thread."""
    levels = [msm5.tree_up0_plain(leaves)]
    while levels[-1].shape[0] > top:
        levels += _up(lib, 2, levels[-1], lanes)
    p = _top(lib, levels[-1], levels[-1].shape[0], 1, True)
    for k in range(len(levels) - 3, -1, -2):
        p = _down2(lib, p, levels[k + 1], levels[k], lanes)
    return p


@pytest.mark.parametrize("lanes", (None, False))
@pytest.mark.parametrize("t,top", [(2, msm5.TOP), (6, 2), (14, 2),
                                   (202, 3), (1030, 4), (2200, msm5.TOP)])
def test_prefix_tree_blocked(lib, t, top, lanes):
    """The whole tree against the one-level chain of plain twins (exact
    triples) and, as points, against the running sums of the JAX package's
    host curve."""
    leaves, ref = _leaves(t, 1100 + t)
    got = _blocked_prefix_tree(lib, leaves, top, lanes)
    assert torch.equal(got, msm5.prefix_tree_chain(leaves))
    acc = ref_curve.Jacobian.identity(ref_curve.Fq(1))
    want = []
    for j, p in enumerate(ref):
        acc = acc.add_affine(p)
        if j % 2:
            a = acc.to_affine()
            want.append((a.x.v, a.y.v))
    have = [p.to_affine() for p in ed.proj_to_jacobians(got)]
    assert [(a.x.v, a.y.v) for a in have] == want


@pytest.mark.parametrize("top", (2, 3, 5))
@pytest.mark.parametrize("t", (2, 10, 34, 406))
def test_prefix_tree_matches_chain(t, top, monkeypatch):
    """`msm5.prefix_tree` on the CPU (the wrappers' plain twins), its top
    moved down so that it takes two-level steps, gives the chain's
    triples."""
    monkeypatch.setattr(msm5, "TOP", top)
    leaves, _ = _leaves(t, 1200 + t)
    assert torch.equal(msm5.prefix_tree(leaves),
                       msm5.prefix_tree_chain(leaves))
