"""Kernels A to M, kernel E's v8 collect mode and v8's entries kernels on
the card against their plain twins, exactly.

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


def _uniform(n, dev, seed):
    """n Fr elements below 2^252 made on the card from a seed."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    words = torch.randint(0, 256, (n, 32), dtype=torch.uint8, device=dev,
                          generator=gen).view(torch.int32)
    words[:, 7] &= 0x0FFFFFFF
    return fd.to_mont(words, fd.FR)


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


@pytest.mark.parametrize("degree", range(1, 8))
def test_kernel_a_degrees_and_deepest(dev, degree):
    """Degrees 1-7 on an expression at the stack and table limits, and on
    tables whose pairs do not fill the last warp (n = 2^5 + 4 rows)."""
    x = [Input(i) for i in range(16)]
    deep = x[15]
    for i in reversed(range(15)):
        deep = x[i] + deep if i % 2 else x[i] * deep
    for n in (1 << 13, 36):
        tables = [_rand(n, dev) for _ in range(16)]
        for r in (None, 4242 + degree):
            got, gf = sumcheck.round_messages(tables, deep, degree, r)
            want, wf = sumcheck.round_messages(tables, deep, degree, r,
                                               plain=True)
            assert got == want
            assert all(torch.equal(a, b) for a, b in zip(gf or [], wf or []))


def test_kernel_b_matches_plain(dev):
    a, b = _rand(1000, dev), _rand(3000, dev)
    assert torch.equal(ntt.poly_mul(a, b), ntt.poly_mul(a, b, plain=True))


@pytest.mark.parametrize("la,lb", [(1, 1), (2, 1), (3, 2), (2047, 3),
                                   (2049, 2049), (1 << 14, (1 << 14) + 1)])
def test_kernel_b_odd_lengths(dev, la, lb):
    a, b = _rand(la, dev), _rand(lb, dev)
    got = ntt.poly_mul(a, b)
    assert torch.equal(got, ntt.poly_mul(a, b, plain=True))
    if la + lb <= 8:
        xs, ys = fd.to_ints(a), fd.to_ints(b)
        want = [sum(xs[i] * ys[k - i] for i in range(la) if 0 <= k - i < lb)
                % R for k in range(la + lb - 1)]
        assert fd.to_ints(got)[:la + lb - 1] == want


def test_kernel_b_passes_match_twins(dev):
    """Every launch of a 2^20-point product (three passes a transform)
    against its twin on the same input, the twiddle table against its
    twin, the S fold against its twin, and inverse o forward = identity."""
    logn = 20
    passes = ntt.plan(logn)
    assert len(passes) == 3
    tw = ntt.twiddle_table(logn, dev)
    assert torch.equal(tw[:ntt.tw_rows(logn)],
                       ntt.twiddle_table_plain(logn, dev))
    a, b = _rand(1 << 19, dev), _rand((1 << 19) - 5, dev)
    fa = ntt.chain(a, logn, ntt.forward_steps(passes), tw, False)
    steps = ntt.product_steps(passes, fa, logn)
    src, valid = b, b.shape[0]
    for step in steps:
        got = torch.empty((1 << logn, fd.NLIMB), dtype=torch.int32,
                          device=dev)
        want = torch.empty_like(got)
        kw = dict(step, y=fa if "y" in step else None)
        ntt.pass_cuda(src, got, valid, logn, tw=tw, **kw)
        ntt.pass_plain(src, want, valid, logn, tw=tw, **kw)
        assert torch.equal(got, want), step
        src, valid = got, 1 << logn
    h = ntt.poly_mul(a, b)
    assert torch.equal(ntt.s_fold(h, 1 << 19), ntt.s_fold_plain(h, 1 << 19))
    for lg in (0, 1, 5, 11, 12, 17, 21):
        x = _uniform(1 << lg, dev, lg)
        assert torch.equal(ntt.ntt(ntt.ntt(x), inverse=True), x)


def test_kernel_b_runs_no_plain_op(dev):
    """ntt.poly_mul on the card launches kernel B's passes and nothing
    else (the profiler's device kernels), 3 + 3 + 2 at 2^23 points."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ntt.TABLES.clear()
    a, b = _uniform(1 << 22, dev, 1), _uniform(1 << 22, dev, 2)
    ntt.poly_mul(a[:8], b[:8])
    torch.cuda.synchronize()
    build.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ntt.poly_mul(a, b)
        torch.cuda.synchronize()
    kernels = {e.key for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    assert kernels and all(k.startswith("ntt_") for k in kernels), kernels
    counts = {k: v for k, v in build.LAUNCHES.items() if v}
    assert counts == {"ntt_forward": 5, "ntt_product": 1,
                      "ntt_inverse": 2, "ntt_twiddles": 1}, counts
    assert torch.equal(ntt.poly_mul(a[:4096], b[:4096]),
                       ntt.poly_mul(a[:4096], b[:4096], plain=True))


def test_kernel_a_copies_nothing_to_the_card(dev):
    """A round's only memcpy is the messages' readback."""
    from torch.profiler import ProfilerActivity, profile

    expr = (Input(0) * Input(1) - Input(2)) * Input(3) + Const(R - 3)
    tables = [_rand(1 << 12, dev) for _ in range(4)]
    sumcheck.round_messages(tables, expr, 3, 777)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sumcheck.round_messages(tables, expr, 3, 778)
        sumcheck.round_messages(tables, expr, 3)
        torch.cuda.synchronize()
    copies = [e.key for e in prof.key_averages()
              if e.key.startswith("Memcpy")]      # the device's copies
    assert copies and all("DtoH" in k for k in copies), copies


@pytest.mark.parametrize("skewed", [False, True])
def test_kernels_c_d_match_plain_and_host(dev, skewed):
    """Uniform scalars put about one entry in a bucket; scalars in {0, 1, 2}
    put ~85 points in a bucket, which spans several kernel C threads of 16
    entries (the rule's K for so few entries) and takes its fix-up; K =
    128 puts whole buckets in one thread.  Either way kernel C is one call
    of the wrapper, a fixed set of launches."""
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
    keys, entries = M.sorted_entries(
        M.signed_digits(fd.from_mont(s, fd.FR)), basis.inf)
    _, counts = keys.unique_consecutive(return_counts=True)
    assert (int(counts.max()) > 4 * 16) == skewed
    before = build.LAUNCHES["msm_bucket_sum"]
    dense_k = M.dense_buckets(basis, s)
    assert build.LAUNCHES["msm_bucket_sum"] == before + 1
    dense_p = M.dense_buckets(basis, s, plain=True)
    assert bool(ed.points_equal(dense_k, dense_p).all())
    assert bool(ed.points_equal(
        M.bucket_sums(basis.xy, keys, entries, test_k=128), dense_p).all())
    wk, wp = M.bucket_reduce(dense_k), M.bucket_reduce_plain(dense_k)
    assert bool(ed.points_equal(wk, wp).all())
    assert M.msm(basis, s) == curve.msm_host(pts, ints)


def _pool_basis(n, dev, seed):
    """n basis points drawn on the card from 256 multiples of G."""
    g = curve.g1_generator()
    pool, _ = ed.affines_to_tensor(
        [g.scalar_mul(k + 2).to_affine() for k in range(256)], dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    xy = pool[torch.randint(0, 256, (n,), generator=gen, device=dev)]
    return M.TorchBasis(xy=xy.contiguous(),
                        inf=torch.zeros(n, dtype=torch.bool, device=dev),
                        length=n)


def test_kernel_c_one_bucket_of_2_16_entries(dev):
    """Every scalar 1: all 2^16 entries fall in one bucket, which spans
    2^16 / M.entries_a_thread(2^16) threads over many blocks and both
    fix-up levels."""
    n = 1 << 16
    basis = _pool_basis(n, dev, 17)
    s = fd.from_ints([1] * n, fd.FR, dev)
    keys, entries = M.sorted_entries(
        M.signed_digits(fd.from_mont(s, fd.FR)), basis.inf)
    assert keys.shape[0] == n and int(keys.max()) == 0
    dense_k = M.bucket_sums(basis.xy, keys, entries)
    dense_p = M.bucket_sums(basis.xy, keys, entries, plain=True)
    assert bool((dense_k != 0).any(-1).any(-1).all())
    assert bool(ed.points_equal(dense_k, dense_p).all())
    assert bool(ed.points_equal(M.bucket_reduce(dense_k),
                                M.bucket_reduce_plain(dense_p)).all())


def test_kernels_c_d_read_nothing_back(dev):
    """From the sorted entries to kernel D's window sums nothing
    synchronises with the host: under sync debug mode "error" any readback
    or blocking copy would raise."""
    basis = _pool_basis(1 << 14, dev, 18)
    s = fd.from_ints([RNG.randrange(R) for _ in range(1 << 14)], fd.FR, dev)
    keys, entries = M.sorted_entries(
        M.signed_digits(fd.from_mont(s, fd.FR)), basis.inf)
    want = M.bucket_reduce(M.bucket_sums(basis.xy, keys, entries))  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = M.bucket_reduce(M.bucket_sums(basis.xy, keys, entries))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    plain = M.bucket_reduce_plain(
        M.bucket_sums(basis.xy, keys, entries, plain=True))
    assert bool(ed.points_equal(got, plain).all())
    assert bool(ed.points_equal(want, plain).all())


def test_kernels_e_to_h_match_plain(dev):
    """E (both modes, the doubling and the shifted basis), F, G and H on
    the card against their plain twins, on a small tau CRS's shifted basis;
    then the small-route MSM against kernels C and D."""
    from quill_tpu_torch.ec import msm5

    pts = [curve.g1_generator().scalar_mul(k + 2).to_affine()
           for k in range(256)]
    pts[7] = curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True)
    basis = M.load_basis(pts, dev)
    inf = basis.inf
    p = msm5.base_points(basis.xy, inf)
    q = msm5.pt_add(p, p)
    flags = torch.arange(p.shape[0], device=dev) % 3 == 0
    assert torch.equal(msm5.pt_add(p, q), msm5.pt_add_plain(p, q))
    assert torch.equal(msm5.pt_add(p, q, flags),
                       msm5.pt_add_plain(p, q, flags))
    assert torch.equal(msm5.pt_dbl(q, 5), msm5.pt_dbl_plain(q, 5))
    sh = msm5.shifted_basis(basis.xy, inf)
    assert torch.equal(sh, msm5.shifted_basis_plain(basis.xy, inf))
    ints = [[RNG.randrange(R) for _ in range(256)] for _ in range(3)]
    scalars = [fd.from_ints(v, fd.FR, dev) for v in ints]
    scs = torch.stack([fd.from_mont(s, fd.FR) for s in scalars])
    _, idx = msm5.sort_leaves(scs, inf)
    x1 = msm5.tree_up0(sh, idx)
    assert torch.equal(x1, msm5.tree_up0_plain(sh, idx))
    leaves = sh[idx.long()].contiguous()
    assert torch.equal(msm5.tree_up0(leaves), x1)
    x2 = msm5.tree_up(x1)
    assert torch.equal(x2, msm5.tree_up_plain(x1))
    assert torch.equal(msm5.tree_down(x2, x1), msm5.tree_down_plain(x2, x1))
    before = build.LAUNCHES["msm5_tree_up0"]
    got = msm5.msm_batch(basis, scalars)
    assert build.LAUNCHES["msm5_tree_up0"] == before + 1
    for s, out in zip(scalars, got):
        assert out == M.msm(basis, s)


def _proj_points(n, dev, seed):
    """(n, 3, 8) projective points on the card from 64 multiples of G and
    the identity, about one in ten the identity."""
    g = curve.g1_generator()
    pool = ed.jacobians_to_proj(
        [g.scalar_mul(k + 3) for k in range(64)]
        + [curve.Jacobian.identity(curve.Fq(1))], dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    idx = torch.randint(0, 64, (n,), device=dev, generator=gen)
    idx[torch.rand(n, device=dev, generator=gen) < 0.1] = 64
    return pool[idx].contiguous()


@pytest.mark.parametrize("m", [1, 2, 3, 5, 513, 2049, 15361])
def test_kernels_g_h_two_levels_match_plain(dev, m):
    """Kernels G and H two levels a launch, at 1- and 2-point levels, odd
    widths and several blocks, against the chains of plain one-level twins
    (`torch.equal`); one launch each."""
    from quill_tpu_torch.ec import msm5

    x = _proj_points(m, dev, m)
    before = dict(build.LAUNCHES)
    o1, o2 = msm5.tree_up2(x)
    a, b = msm5.tree_up2_plain(x)
    assert torch.equal(o1, a) and torch.equal(o2, b)
    p = _proj_points(o2.shape[0], dev, m + 1)
    got = msm5.tree_down2(p, o1, x)
    assert torch.equal(got, msm5.tree_down2_plain(p, o1, x))
    assert build.LAUNCHES["msm5_tree_up"] == before["msm5_tree_up"] + 1
    assert build.LAUNCHES["msm5_tree_down"] == before["msm5_tree_down"] + 1
    if m % 2 == 0:
        assert torch.equal(msm5.tree_up(x), msm5.tree_up_plain(x))
        half = x[:m // 2].contiguous()
        assert torch.equal(msm5.tree_down(half, x),
                           msm5.tree_down_plain(half, x))


def test_fused_top_matches_plain(dev):
    """The fused top in tree mode at 1 to 512 points and in reduce mode at
    the collect's and v6's group sizes, against their plain twins; the
    collect's reduction in two launches."""
    from quill_tpu_torch.ec import msm5

    for w in (1, 2, 3, 160, 511, msm5.TOP):
        x = _proj_points(w, dev, 2 * w)
        assert torch.equal(msm5.tree_top(x), msm5.tree_top_plain(x))
    for rows, group in ((6, 1), (8, 2), (3 * 512, 512), (4 << 14, 1 << 14),
                        (1 << 16, 1 << 16)):
        x = _proj_points(rows, dev, rows + group)
        before = build.LAUNCHES["msm5_tree_reduce"]
        got = msm5.tree_reduce(x, group)
        assert torch.equal(got, msm5.tree_reduce_plain(x, group))
        assert build.LAUNCHES["msm5_tree_reduce"] - before <= 2


def test_prefix_tree_matches_one_level_chain(dev):
    """The whole prefix tree (two-level launches, the top) gives the same
    triples as the chain of one-level launches, and one small-route call
    launches G, H, the top and its reduce mode as the design says."""
    from quill_tpu_torch.ec import msm5

    pts = [curve.g1_generator().scalar_mul(k + 2).to_affine()
           for k in range(512)]
    basis = M.load_basis(pts, dev)
    ints = [[RNG.randrange(R) for _ in range(512)] for _ in range(4)]
    scalars = [fd.from_ints(v, fd.FR, dev) for v in ints]
    scs = torch.stack([fd.from_mont(s, fd.FR) for s in scalars])
    sh = msm5.shifted(basis, 0)
    _, idx = msm5.sort_leaves(scs, basis.inf)
    got = msm5.prefix_tree(sh, idx)
    assert torch.equal(got, msm5.prefix_tree_chain(
        sh[idx.long()].contiguous(), msm5.tree_up0, msm5.tree_up,
        msm5.tree_down))
    before = dict(build.LAUNCHES)
    out = msm5.msm_batch(basis, scalars)
    n = {k: v - before[k] for k, v in build.LAUNCHES.items()}
    # 20,480 pairs -> 5,120 -> 1,280 -> 320: 3 two-level launches each way
    assert (n["msm5_tree_up"], n["msm5_tree_down"]) == (3 + 1, 3)
    assert (n["msm5_tree_top"], n["msm5_tree_reduce"]) == (1, 2)
    for s, o in zip(scalars, out):
        assert o == M.msm(basis, s)


def _pool_points(n, dev, seed):
    """n affine points drawn from 256 multiples of G on the card, one in
    1000 at infinity ((0, 0) with its mask set)."""
    g = curve.g1_generator()
    pool, _ = ed.affines_to_tensor(
        [g.scalar_mul(k + 2).to_affine() for k in range(256)], dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    xy = pool[torch.randint(0, 256, (n,), generator=gen, device=dev)]
    inf = torch.arange(n, device=dev) % 1000 == 3
    xy[inf] = 0
    return M.TorchBasis(xy=xy.contiguous(), inf=inf, length=n)


@pytest.mark.parametrize("nwin,wbits", [(20, 13), (16, 16)])
def test_kernel_e_shifted_basis_matches_plain(dev, nwin, wbits):
    """The shifted-basis launch on 2^16 points, and on 2^16 + 300 points
    in chunks of 2^16 (the last one ragged), against its plain twin (the
    doubling ladder and one batch normalisation), exactly; one launch
    each."""
    from quill_tpu_torch.ec import msm5

    basis = _pool_points((1 << 16) + 300, dev, nwin)
    for n, chunk in ((1 << 16, None), ((1 << 16) + 300, 1 << 16)):
        xy, inf = basis.xy[:n], basis.inf[:n]
        before = build.LAUNCHES["msm5_shifted_basis"]
        got = msm5.shifted_basis(xy, inf, nwin, wbits, chunk)
        assert build.LAUNCHES["msm5_shifted_basis"] == before + 1
        assert got.shape == (nwin * n, 2, fd.NLIMB)
        assert torch.equal(got, msm5.shifted_basis_plain(xy, inf, nwin,
                                                         wbits, chunk))


def test_shifted_basis_reads_nothing_back(dev):
    """The small route's shifted basis of two chunks (one launch, cached
    per chunk) and v6's over 300 points build under sync debug mode
    "error": no readback, no blocking copy, no plain-torch product."""
    from quill_tpu_torch.ec import msm5, msm6

    basis = _pool_points((1 << 16) + 300, dev, 9)
    msm5.shifted_basis(basis.xy[:64], basis.inf[:64])  # builds the library
    msm6.shifted(_pool_points(64, dev, 1), 64)
    torch.cuda.synchronize()
    before = build.LAUNCHES["msm5_shifted_basis"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        sh0 = msm5.shifted(basis, 0)
        sh1 = msm5.shifted(basis, 1)
        v6 = msm6.shifted(basis, 300)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert build.LAUNCHES["msm5_shifted_basis"] == before + 2
    assert torch.equal(torch.cat((sh0, sh1)), msm5.shifted_basis_plain(
        basis.xy, basis.inf, chunk=1 << 16))
    assert torch.equal(v6.reshape(-1, 2, fd.NLIMB), msm5.shifted_basis_plain(
        basis.xy[:1 << 16], basis.inf[:1 << 16], msm6.NWIN, msm6.WBITS))


def test_triangle_doubling_matches_add_chains(dev, monkeypatch):
    """k doublings in one launch against k kernel E adds of a point to
    itself (as points: the formulas differ) and against the plain twin
    (the same triples), the identity included; v8's triangle makes 3
    adds and 1 doubling launch, and gives the points it gave with 8 adds
    in place of the doubling launch."""
    from quill_tpu_torch.ec import msm5, msm8

    def chain(x, k):
        for _ in range(k):
            x = msm5.pt_add(x, x)
        return x

    pool = _pool_points(500, dev, 3)
    p = msm5.base_points(pool.xy, pool.inf)
    p[0] = ed.identity(1, dev)[0]
    for k in (1, 8):
        got = msm5.pt_dbl(p, k)
        assert bool(ed.points_equal(got, chain(p, k)).all())
        assert torch.equal(got, msm5.pt_dbl_plain(p, k))
    n = msm8.NWIN * msm8.NBUCK
    pool = _pool_points(n, dev, 4)
    acc = msm5.base_points(pool.xy, pool.inf)
    before = dict(build.LAUNCHES)
    got = msm8.triangle(acc)
    assert build.LAUNCHES["msm5_pt_add"] == before["msm5_pt_add"] + 3
    assert build.LAUNCHES["msm5_pt_dbl"] == before["msm5_pt_dbl"] + 1
    monkeypatch.setattr(msm5, "pt_dbl", chain)
    assert bool(ed.points_equal(got, msm8.triangle(acc)).all())


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


@pytest.mark.parametrize("w", [4, 10, 13])
def test_kernel_j_matches_plain(dev, w):
    """Kernel J's table (one launch over the 4-bit host table, none at w =
    4) and kernel J over it against the twin (plain sums, then
    `to_affine`) with `torch.equal`, at 1,003 scalars (two blocks and a
    part); a zero scalar raises."""
    from quill_tpu_torch.ec import fixed_base as fb

    before = build.LAUNCHES["fixed_base"]
    table = fb.make_table(w, dev)
    assert build.LAUNCHES["fixed_base"] == before + (w != fb.BOOT_W)
    if w != fb.BOOT_W:
        twin = fb.fixed_base_twin(fb.table_scalars(w, dev).reshape(
            -1, fd.NLIMB), fb.boot_table(dev), fb.BOOT_W)
        assert torch.equal(table.reshape(-1, 2, fd.NLIMB), twin)
    ints = [RNG.randrange(1, R) for _ in range(1000)] + [1, R - 1, 1 << 200]
    s = fd.ints_to_tensor(ints, dev)
    before = build.LAUNCHES["fixed_base"]
    got = fb.fixed_base(s, table, w)
    assert build.LAUNCHES["fixed_base"] == before + 1
    assert torch.equal(got, fb.fixed_base_twin(s, table, w))
    g = curve.g1_generator()
    xy = fd.to_ints(got[-3:].reshape(-1, fd.NLIMB), fd.FQ)
    for i, k in enumerate(ints[-3:]):
        a = g.scalar_mul(k).to_affine()
        assert (xy[2 * i], xy[2 * i + 1]) == (a.x.v, a.y.v)
    with pytest.raises(ValueError):
        fb.fixed_base(fd.ints_to_tensor([5, 0], dev), table, w)


def test_crs_two_launches(dev):
    """A CRS of 2^16 + 1 points (w = 8): two kernel J launches, the same
    rows as the twin's and the host's."""
    from quill_tpu_torch.ec import fixed_base as fb
    from quill_tpu_torch.pcs.kzg import _tau_from_seed

    n, tau = (1 << 16) + 1, _tau_from_seed(0)
    assert fb.window_for(n) == 8
    before = build.LAUNCHES["fixed_base"]
    xy = fb.device_tau_powers(tau, n, dev)
    assert build.LAUNCHES["fixed_base"] == before + 2
    powers = fd.from_mont(fd.powers(tau, n, fd.FR, dev), fd.FR)
    assert torch.equal(xy, fb.fixed_base_twin(powers, fb.make_table(8, dev),
                                              8))
    g = curve.g1_generator()
    for i in (0, 1, n - 1):
        a = g.scalar_mul(pow(tau, i, R)).to_affine()
        assert fd.to_ints(xy[i], fd.FQ) == [a.x.v, a.y.v]


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


@pytest.mark.parametrize("k", [1, 2, 3, 255, 256, 257, 513, 5000])
def test_leaf_level_matches_plain(dev, k):
    """Kernels F and K's one kernel at 1 to 5,000 pairs: through a random
    index of a 600-row basis (P + P and P + (-P) among the pairs) and on
    contiguous leaves (no index), each launch counted once under its
    caller's name."""
    from quill_tpu_torch.ec import msm5, msm6

    g = curve.g1_generator()
    aff = [g.scalar_mul(j + 2).to_affine() for j in range(300)]
    aff += [curve.Affine(a.x, -a.y) for a in aff]
    sh, _ = ed.affines_to_tensor(aff, dev)
    idx = torch.tensor([RNG.randrange(600) for _ in range(2 * k)],
                       dtype=torch.int32, device=dev)
    if k >= 2:
        idx[1] = (idx[0] + 300) % 600
        idx[3] = idx[2]
    want = msm5.tree_up0_plain(sh, idx)
    before = dict(build.LAUNCHES)
    assert torch.equal(msm5.tree_up0(sh, idx), want)
    assert torch.equal(msm6.level0(sh, idx), want)
    leaves = sh[idx.long()].contiguous()
    assert torch.equal(msm5.tree_up0(leaves), want)
    n = {c: build.LAUNCHES[c] - before[c]
         for c in ("msm5_tree_up0", "msm6_level0")}
    assert n == {"msm5_tree_up0": 2, "msm6_level0": 1}


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("n", [1, 20, 21, 300, 5000])
def test_kernel_e_add_by_threads_and_lanes(dev, n, lanes):
    """Kernel E's add, by threads and by lanes, staged: the plain twin's
    triples, with and without flags."""
    from quill_tpu_torch.ec import msm5

    a, b = _proj_points(n, dev, n), _proj_points(n, dev, n + 1)
    flags = torch.rand(n, device=dev) < 0.3
    for f in (None, flags):
        assert torch.equal(msm5.pt_add(a, b, f, lanes=lanes),
                           msm5.pt_add_plain(a, b, f))


def test_v6_walk_and_top_match_chains(dev):
    """v6's query walk against the chain of flagged kernel E launches
    with `torch.equal`, the fused top against
    Hillis-Steele as points; a v6 MSM launches one walk and one top and
    no E add."""
    from quill_tpu_torch.ec import msm5, msm6

    g = curve.g1_generator()
    pts = [g.scalar_mul(k + 2).to_affine() for k in range(300)]
    basis = M.load_basis(pts, dev)
    ints = [RNG.randrange(R) for _ in range(300)]
    ints[:3] = [0, 1, R - 1]
    s = fd.from_ints(ints, fd.FR, dev)
    sh = msm6.shifted(basis, 300)
    keys, idx = msm6.sort_keys(fd.from_mont(s, fd.FR), basis.inf,
                               sh.shape[1])
    cnt = torch.searchsorted(keys, torch.arange(
        msm6.NQ, dtype=torch.int32, device=dev), right=True)
    flat = sh.reshape(-1, 2, fd.NLIMB)
    levels = msm6.tree(flat, idx)
    top = msm5.tree_top(levels[-1])
    assert bool(ed.points_equal(top, msm6.prefix(levels[-1])).all())
    assert torch.equal(msm6.query_walk(cnt, flat, idx, levels, top),
                       msm6.queries(cnt, flat, idx, levels, top))
    before = dict(build.LAUNCHES)
    assert msm6.msm(basis, s) == curve.msm_host(pts, ints)
    grew = {k: v - before[k] for k, v in build.LAUNCHES.items()}
    assert grew["msm5_query_walk"] == 1 and grew["msm5_tree_top"] == 1
    assert grew["msm5_pt_add"] == 0


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


@pytest.mark.parametrize("run", [1, 7, 32, 64, 128])
def test_kernel_m_matches_plain(dev, run):
    """Kernel M on one batch of jobs whose lengths cross its tiles (128
    runs of `run` coefficients) against the plain twin and the host; 17
    jobs through `quotient_many_device` take two launches."""
    from quill_tpu_torch.engine import quotient as Q
    from quill_tpu_torch.engine.device import TorchEngine
    from quill_tpu_torch.engine.host import HostEngine

    lengths = [1, 2, 33, 127 * run, 128 * run, 128 * run + 1, 9001]
    xs = [RNG.randrange(1, R) for _ in lengths[:-1]] + [R - 7]
    cs = [_rand(n, dev) for n in lengths]
    before = build.LAUNCHES["quotient"]
    ys, outs = Q.scan(cs, xs, run)
    assert build.LAUNCHES["quotient"] == before + 1
    want_ys, want_outs = Q.scan_plain(cs, xs)
    assert ys == want_ys
    assert all(torch.equal(a, b) for a, b in zip(outs, want_outs))
    host = HostEngine()
    for c, x, y, out in zip(cs[:4], xs, ys, outs):
        hy, hq = host.quotient_by_linear(fd.to_ints(c), x)
        assert y == hy and fd.to_ints(out) == [int(v) for v in hq] + [0]
    eng = TorchEngine("cuda", min_device_size=1)
    jobs = [(eng.vec_from_ints(fd.to_ints(cs[4])), x) for x in range(1, 18)]
    before = build.LAUNCHES["quotient"]
    got = Q.quotient_many_device(eng, jobs)
    assert build.LAUNCHES["quotient"] == before + 2
    for (y, q), (y2, q2) in zip(got, Q.quotient_many_plain(jobs)):
        assert y == y2 and torch.equal(q.rows(), q2.rows())


def test_kernel_m_mixed_batch_one_launch(dev):
    """One open_many batch of device jobs with 1, 2 and 3 chunks of 2^16
    coefficients and x = 0 among them: kernel M takes the x != 0 jobs in
    one launch (the JAX copy's grouping would take three), each equal to
    the plain twin and the host."""
    from quill_tpu_torch.engine import quotient as Q
    from quill_tpu_torch.engine.device import TorchEngine
    from quill_tpu_torch.engine.host import HostEngine

    eng = TorchEngine("cuda", min_device_size=1)
    lengths = [(1 << 16) + 5, 3000, (2 << 16) + 9, 7, 1 << 17]
    xs = [RNG.randrange(1, R) for _ in lengths]
    xs[3] = 0
    cs = [_rand(n, dev) for n in lengths]
    jobs = [(eng._wrap(c, n), x) for c, n, x in zip(cs, lengths, xs)]
    before = build.LAUNCHES["quotient"]
    got = eng.quotient_many(jobs)
    assert build.LAUNCHES["quotient"] == before + 1
    dev_jobs = [j for j in jobs if j[1] != 0]
    for (y, q), (y2, q2) in zip([g for g, j in zip(got, jobs) if j[1]],
                                Q.quotient_many_plain(dev_jobs)):
        assert y == y2 and torch.equal(q.rows(), q2.rows())
    host = HostEngine()
    for c, x, (y, q) in zip(cs, xs, got):
        hy, hq = host.quotient_by_linear(fd.to_ints(c), x)
        assert y == hy
        assert [int(v) for v in eng.vec_to_ints(q)] == [int(v) for v in hq]


@pytest.mark.parametrize("case", ["random", "equal", "runs"])
def test_v8_collect_matches_plain(dev, case):
    """Kernel E's v8 collect mode on one chunk of 600 points (3 blocks a
    window) against its plain twin and the earlier sparse collect, the same
    triples, added into buckets that already hold points: uniform scalars
    (most digits absent), all scalars equal (one digit a window, its run
    across blocks) and runs of 300 equal scalars."""
    from quill_tpu_torch.ec import msm8
    from quill_tpu_torch.probe_collect import collect_sparse

    g = curve.g1_generator()
    pts = [g.scalar_mul(k + 2).to_affine() for k in range(600)]
    pts[5] = curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True)
    basis = M.load_basis(pts, dev)
    ints = {"random": [RNG.randrange(R) for _ in range(600)],
            "equal": [R - 12345] * 600,
            "runs": [RNG.randrange(R)] * 300 + [RNG.randrange(R)] * 300}[case]
    sd, xs, fl = msm8.chunk_entries(fd.from_ints(ints, fd.FR, dev),
                                    basis.xy, basis.inf)
    ys, wf, offs = msm8.chunk_scan(xs, fl)
    acc0 = msm8.collect(sd, ys, wf, offs,
                        ed.identity(msm8.NWIN * msm8.NBUCK, dev))
    before = build.LAUNCHES["msm8_collect"]
    got = msm8.collect(sd, ys, wf, offs, acc0.clone())
    assert build.LAUNCHES["msm8_collect"] == before + 1
    assert torch.equal(got, msm8.collect_plain(sd, ys, wf, offs, acc0.clone()))
    assert torch.equal(got, collect_sparse(sd, ys, wf, offs, acc0.clone()))


ENTRY_CASES = ["n1", "n255", "n256", "n300", "n600", "n65536", "inf",
               "equal", "zero", "edges", "cross"]


def _entries_case(case, dev):
    """A chunk's basis and Montgomery scalars on the card: uniform scalars
    at widths of 1 to 2^16 (one in 1000 points at infinity), four more
    points at infinity, all scalars equal, all zero, r - 1 and 1 between
    uniform ones, one run of 80 equal scalars across a block boundary."""
    n = int(case[1:]) if case.startswith("n") else 300
    basis = _pool_points(n, dev, 31)
    s = _uniform(n, dev, 32)
    if case == "inf":
        at = torch.tensor([0, 7, 150, 299], device=dev)
        basis.inf[at] = True
        basis.xy[at] = 0
    elif case == "equal":
        s = fd.from_ints([R - 12345] * n, fd.FR, dev)
    elif case == "zero":
        s = torch.zeros_like(s)
    elif case == "edges":
        s[::3] = fd.from_ints([R - 1], fd.FR, dev)
        s[1::3] = fd.from_ints([1], fd.FR, dev)
    elif case == "cross":
        s[200:280] = s[200]
    return basis, s


@pytest.mark.parametrize("case", ENTRY_CASES)
def test_v8_entries_match_plain(dev, case):
    """v8's entries kernels (one wrapper call, four launches) against the
    plain twin: the same sorted digits, scan input and flags."""
    from quill_tpu_torch.ec import msm8

    basis, s = _entries_case(case, dev)
    before = build.LAUNCHES["msm8_entries"]
    got = msm8.chunk_entries(s, basis.xy, basis.inf)
    assert build.LAUNCHES["msm8_entries"] == before + 1
    want = msm8.chunk_entries_plain(s, basis.xy, basis.inf)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_v8_msm_one_entries_launch_a_chunk(dev, monkeypatch):
    """A v8 MSM of three chunks (CHUNK cut to 256: 256, 256 and 88 points)
    counts one entries call and one collect a chunk, and equals the same
    MSM on the CPU (the plain twins), kernels C + D and the host's."""
    from quill_tpu_torch.ec import msm8

    monkeypatch.setattr(msm8, "CHUNK", 256)
    g = curve.g1_generator()
    pts = [g.scalar_mul(k + 2).to_affine() for k in range(600)]
    pts[9] = curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True)
    basis = M.load_basis(pts, dev)
    ints = [RNG.randrange(R) for _ in range(600)]
    ints[:3] = [0, 1, R - 1]
    s = fd.from_ints(ints, fd.FR, dev)
    before = dict(build.LAUNCHES)
    got = msm8.msm(basis, s)
    assert build.LAUNCHES["msm8_entries"] == before["msm8_entries"] + 3
    assert build.LAUNCHES["msm8_collect"] == before["msm8_collect"] + 3
    plain = msm8.msm(M.TorchBasis(xy=basis.xy.cpu(), inf=basis.inf.cpu(),
                                  length=600), s.cpu())
    assert got == plain == M.msm(basis, s) == curve.msm_host(pts, ints)


def test_v8_msm_waits_on_the_host_only_in_the_combine(dev, monkeypatch):
    """From its head to the host combine a v8 MSM of three chunks makes no
    host synchronisation: under sync debug mode "error" a readback or a
    copy from host memory raises.  The combine (two readbacks) runs with
    the mode off."""
    from quill_tpu_torch.ec import msm8

    monkeypatch.setattr(msm8, "CHUNK", 256)
    basis = _pool_points(600, dev, 41)
    s = _uniform(600, dev, 42)
    want = msm8.msm(basis, s)        # builds, makes the per-device constants
    combine = msm8.combine_windows

    def combine_unchecked(wsums):
        torch.cuda.set_sync_debug_mode(0)
        return combine(wsums)

    monkeypatch.setattr(msm8, "combine_windows", combine_unchecked)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = msm8.msm(basis, s)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got == want
