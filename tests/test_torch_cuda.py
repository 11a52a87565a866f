"""Kernels A to L on the card against their plain twins, exactly.

These need an NVIDIA GPU with nvcc (they build the kernels from
`quill_tpu_torch/csrc`) and skip elsewhere; whether a card is present is
decided inside the fixture, never at import.  On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import random

import pytest
import torch

from quill_tpu.ec import curve
from quill_tpu.fields.bn254 import R

from quill_tpu_torch.ec import device as ed
from quill_tpu_torch.ec import msm as M
from quill_tpu_torch.engine import sumcheck
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.kernels import build
from quill_tpu_torch.piops.virtual_poly import Const, Input
from quill_tpu_torch.poly import ntt

pytestmark = pytest.mark.cuda
RNG = random.Random(99)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _rand(n, dev):
    return fd.from_ints([RNG.randrange(R) for _ in range(n)], fd.FR, dev)


def test_kernel_a_matches_plain(dev):
    expr = (Input(0) * Input(1) - Input(2)) * Input(3) + Const(R - 3)
    tables = [_rand(1 << 12, dev) for _ in range(4)]
    before = build.LAUNCHES["sumcheck_round"]
    for r in (None, 12345):
        got, gf = sumcheck.round_messages(tables, expr, 3, r)
        want, wf = sumcheck.round_messages(tables, expr, 3, r, plain=True)
        assert got == want
        if r is not None:
            assert all(torch.equal(a, b) for a, b in zip(gf, wf))
    assert build.LAUNCHES["sumcheck_round"] == before + 2


def test_kernel_b_matches_plain(dev):
    a, b = _rand(1000, dev), _rand(3000, dev)
    assert torch.equal(ntt.poly_mul(a, b), ntt.poly_mul(a, b, plain=True))


@pytest.mark.parametrize("skewed", [False, True])
def test_kernels_c_d_match_plain_and_host(dev, skewed):
    """Uniform scalars fill kernel C's affine level only; scalars in
    {0, 1, 2} put ~85 points in a bucket, which takes its projective
    levels as well."""
    g = curve.g1_generator()
    pts = [g.scalar_mul(k + 2).to_affine() for k in range(256)]
    pts[3] = curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True)
    basis = M.load_basis(pts, dev)
    if skewed:
        ints = [RNG.randrange(3) for _ in range(256)]
    else:
        ints = [RNG.randrange(R) for _ in range(256)]
        ints[:3] = [0, 1, R - 1]
    s = fd.from_ints(ints, fd.FR, dev)
    before = build.LAUNCHES["msm_bucket_sum"]
    dense_k = M.dense_buckets(basis, s)
    assert (build.LAUNCHES["msm_bucket_sum"] - before > 1) == skewed
    dense_p = M.dense_buckets(basis, s, plain=True)
    assert bool(ed.points_equal(dense_k, dense_p).all())
    wk, wp = M.bucket_reduce(dense_k), M.bucket_reduce_plain(dense_k)
    assert bool(ed.points_equal(wk, wp).all())
    assert M.msm(basis, s) == curve.msm_host(pts, ints)


def test_kernels_e_to_h_match_plain(dev):
    """E (both modes, and the doubling ladder), F, G and H on the card
    against their plain twins, on a small tau CRS's shifted basis; then the
    small-route MSM against kernels C and D."""
    from quill_tpu_torch.ec import msm5

    pts = [curve.g1_generator().scalar_mul(k + 2).to_affine()
           for k in range(256)]
    pts[7] = curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True)
    basis = M.load_basis(pts, dev)
    p, inf = msm5.chunk_points(basis, 0)
    q = msm5.pt_add(p, p)
    flags = torch.arange(p.shape[0], device=dev) % 3 == 0
    assert torch.equal(msm5.pt_add(p, q), msm5.pt_add_plain(p, q))
    assert torch.equal(msm5.pt_add(p, q, flags),
                       msm5.pt_add_plain(p, q, flags))
    ladder = msm5.shift_ladder(p)
    assert torch.equal(ladder, msm5.shift_ladder(p, plain=True))
    sh = msm5.to_affine(ladder.reshape(-1, 3, fd.NLIMB))
    ints = [[RNG.randrange(R) for _ in range(256)] for _ in range(3)]
    scalars = [fd.from_ints(v, fd.FR, dev) for v in ints]
    scs = torch.stack([fd.from_mont(s, fd.FR) for s in scalars])
    _, _, leaves = msm5.sort_leaves(scs, inf, sh)
    x1 = msm5.tree_up0(leaves)
    assert torch.equal(x1, msm5.tree_up0_plain(leaves))
    x2 = msm5.tree_up(x1)
    assert torch.equal(x2, msm5.tree_up_plain(x1))
    assert torch.equal(msm5.tree_down(x2, x1), msm5.tree_down_plain(x2, x1))
    before = build.LAUNCHES["msm5_tree_up0"]
    got = msm5.msm_batch(basis, scalars)
    assert build.LAUNCHES["msm5_tree_up0"] == before + 1
    for s, out in zip(scalars, got):
        assert out == M.msm(basis, s)


def test_kernel_i_matches_plain(dev, monkeypatch):
    """Kernel I with flags, without flags, and the whole v8 MSM (two
    chunks, the second short) against kernels C and D."""
    from quill_tpu_torch.ec import msm8

    g = curve.g1_generator()
    pts = [g.scalar_mul(k + 2).to_affine() for k in range(300)]
    pts[9] = curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True)
    basis = M.load_basis(pts, dev)
    p = torch.cat((basis.xy, fd.const(1, fd.FQ, dev).expand(300, 1, 8)), 1)
    xs = p[10:266].reshape(8, 32, 3, fd.NLIMB).contiguous()
    flags = torch.rand((8, 32), device=dev) < 0.3
    for f in (flags, None):
        assert _same_points(msm8.seg_scan(xs, f), msm8.seg_scan_plain(xs, f))
    ints = [RNG.randrange(R) for _ in range(300)]
    ints[:3] = [0, 1, R - 1]
    s = fd.from_ints(ints, fd.FR, dev)
    before = build.LAUNCHES["msm8_seg_scan"]
    monkeypatch.setattr(msm8, "CHUNK", 256)
    got = msm8.msm(basis, s)
    assert build.LAUNCHES["msm8_seg_scan"] > before
    assert got == M.msm(basis, s) == curve.msm_host(pts, ints)


def _same_points(a, b):
    """Equal points, none of them the degenerate (0 : 0 : 0).  Kernel I adds
    in another order than its serial twin, so its triples may differ."""
    a, b = a.reshape(-1, 3, fd.NLIMB), b.reshape(-1, 3, fd.NLIMB)
    return bool((a != 0).any(-1).any(-1).all()
                and ed.points_equal(a, b).all())


def _scan_flags(pattern, m, s, t, gen):
    """(m, s) flags on the card: none, all, at every run boundary of t runs
    a lane, only at the last step, or random at 1/8 or 1/64."""
    dev = gen.device
    if pattern == "none":
        return None
    f = torch.zeros((m, s), dtype=torch.bool, device=dev)
    if pattern == "all":
        f[:] = True
    elif pattern == "boundary":
        f[:, ::-(-s // t)] = True
    elif pattern == "last":
        f[:, -1] = True
    else:
        den = int(pattern[len("random"):])
        f = torch.rand((m, s), generator=gen, device=dev) < 1 / den
    return f


@pytest.mark.parametrize("pattern", ["none", "all", "boundary", "last",
                                     "random8", "random64"])
@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (20, 256), (5120, 256)])
def test_kernel_i_shapes(dev, shape, pattern):
    """Kernel I at the v8 route's block-scan (20 x 256) and chunk (5,120 x
    256) shapes and at two small ones, on adversarial flags, with
    identities among the points."""
    from quill_tpu_torch.ec import msm8

    m, s = shape
    g = curve.g1_generator()
    pool = ed.jacobians_to_proj(
        [g.scalar_mul(k + 2) for k in range(63)]
        + [curve.Jacobian.identity(curve.Fq(1))]).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(m * 1000 + s)
    idx = torch.randint(0, 64, (m * s,), generator=gen, device=dev)
    xs = pool[idx].reshape(m, s, 3, fd.NLIMB).contiguous()
    t = msm8.scan_threads(m, s)
    flags = _scan_flags(pattern, m, s, t, gen)
    before = build.LAUNCHES["msm8_seg_scan"]
    got = msm8.seg_scan(xs, flags)
    assert build.LAUNCHES["msm8_seg_scan"] == before + 1
    assert _same_points(got, msm8.seg_scan_plain(xs, flags))


def test_kernel_j_matches_plain(dev):
    from quill_tpu_torch.ec import fixed_base as fb

    table = fb.build_table(curve.g1_generator(), dev)
    ints = [RNG.randrange(R) for _ in range(1000)] + [0, 1, R - 1]
    s = fd.ints_to_tensor(ints, dev)
    before = build.LAUNCHES["fixed_base"]
    got = fb.fixed_base(s, table)
    assert build.LAUNCHES["fixed_base"] == before + 1
    assert torch.equal(got, fb.fixed_base_plain(s, table))
    g = curve.g1_generator()
    for k, p in zip(ints[-3:], ed.proj_to_jacobians(got[-3:])):
        assert p == g.scalar_mul(k)


def test_kernel_k_matches_plain(dev):
    """Kernel K on every level-1 pair of a v6 MSM (padded and clamped
    elements make pairs of equal points), then the whole v6 MSM against
    kernels C and D and the host."""
    from quill_tpu_torch.ec import msm6

    g = curve.g1_generator()
    pts = [g.scalar_mul(k + 2).to_affine() for k in range(300)]
    pts[11] = curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True)
    basis = M.load_basis(pts, dev)
    ints = [RNG.randrange(R) for _ in range(300)]
    ints[:3] = [0, 1, R - 1]
    s = fd.from_ints(ints, fd.FR, dev)
    sh = msm6.shifted(basis, 300).reshape(-1, 2, fd.NLIMB)
    _, idx = msm6.sort_keys(fd.from_mont(s, fd.FR), basis.inf, 300)
    before = build.LAUNCHES["msm6_level0"]
    assert torch.equal(msm6.level0(sh, idx), msm6.level0_plain(sh, idx))
    assert build.LAUNCHES["msm6_level0"] == before + 1
    assert msm6.msm(basis, s) == M.msm(basis, s) == curve.msm_host(pts, ints)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_kernel_l_matches_plain(dev, field):
    from quill_tpu_torch.fields import vec

    f = fd.FR if field == "fr" else fd.FQ
    mod = f.modulus
    xs = [RNG.randrange(mod) for _ in range(1000)] + [0, 1, mod - 1]
    ys = [RNG.randrange(mod) for _ in range(1000)] + [mod - 1] * 3
    a, b = fd.from_ints(xs, f, dev), fd.from_ints(ys, f, dev)
    before = build.LAUNCHES["field_mul"]
    got = vec.mont_mul_vec(a, b, f)
    assert build.LAUNCHES["field_mul"] == before + 1
    assert torch.equal(got, vec.mont_mul_vec_plain(a, b, f))
    assert fd.to_ints(got, f) == [x * y % mod for x, y in zip(xs, ys)]
