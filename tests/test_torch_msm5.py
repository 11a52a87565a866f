"""The small-MSM route of quill_tpu_torch (`ec/msm5.py`, kernels E to H's
plain twins on the CPU) against the JAX package.

- digits equal `quill_tpu.ec.msm._extract_digits`;
- the engine's route equals `TpuEngine._msm_impl` for 1 to 70 chunks,
  under every ported `msm_impl` (5, 6, 7, 8; 1 and 3 raise) and the
  default and other `msm_shift_max` bounds, and `msm_many` batches
  small-route jobs in padded groups;
- shifted-basis rows equal 2^(13 w) G_i by `quill_tpu.ec.curve`;
- the prefix tree's wiring: with integers in place of points, read
  through an index, it gives running sums (as `tests/test_msm_tree.py`
  checks the TPU tree);
- kernel F's twin through an index against ONE interpret-mode call of the
  Pallas kernel it replaces, `quill_tpu.ec.msm5._up0_call(1, 128)`
  (`_up0_kernel`), on the same affine points;
- whole MSMs, single, batched and over two chunks, equal
  `quill_tpu.ec.curve.msm_host`;
- E to H's plain twins equal `quill_tpu.ec.curve` adds.

Exactness is `==` on canonical integers.  Sizes up to 2^8 points.
"""

import types

import numpy as np
import pytest
import torch

from quill_tpu.ec import curve
from quill_tpu.fields.bn254 import R
from quill_tpu.fields.limbs import ints_to_limbs

from quill_tpu_torch.ec import device as ed
from quill_tpu_torch.ec import msm as M
from quill_tpu_torch.ec import msm5
from quill_tpu_torch.engine.device import TorchEngine
from quill_tpu_torch.fields import device as fd

torch.set_num_threads(1)

G = curve.g1_generator()
INF = curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True)
# scalars at the edges: 0, 1, r - 1, and values across the 13-bit digit
# boundaries
EDGES = [0, 1, R - 1, (1 << 13) - 1, 1 << 13, (1 << 26) - 1, 1 << 26,
         (1 << 247) - 1, 1 << 247, R - (1 << 13)]


def _ints(rng, n):
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % R
            for row in words]


def _affine_ints(pt):
    a = pt.to_affine()
    return None if a.infinity else (a.x.v, a.y.v)


def _proj_ints(t):
    return [_affine_ints(p) for p in ed.proj_to_jacobians(t)]


@pytest.fixture(scope="module")
def points():
    """256 distinct points, the fourth at infinity."""
    rng = np.random.default_rng(5)
    pts = [G.scalar_mul(int(k)).to_affine()
           for k in rng.integers(2, 1 << 40, size=256)]
    pts[3] = INF
    return pts


@pytest.fixture(scope="module")
def basis(points):
    return M.load_basis(points, "cpu")


def test_digits_match_extract_digits():
    import jax.numpy as jnp

    from quill_tpu.ec import msm as jax_msm

    ints = EDGES + _ints(np.random.default_rng(1), 54)
    want = np.asarray(jax_msm._extract_digits(jnp.asarray(ints_to_limbs(ints))))
    got = msm5.window_digits(fd.ints_to_tensor(ints)).numpy()
    assert np.array_equal(got.T, want)


JAX_ROUTE = {"5": "small", "7": "cd", "8": "v8"}


@pytest.mark.parametrize("shift_max", [None, 0, 3 << 16, 1 << 22])
def test_route_matches_device_engine(shift_max, monkeypatch):
    """By default 1 and 2 chunks take the small route (JAX v5), 3 to 16
    kernels C and D (JAX v7), 17 to 70 (above 2^20 points) the v8 route
    (JAX v8); `msm_shift_max` moves the v8 bound as QUILL_MSM_SHIFT_MAX
    does, and at 0 v8 wins over the small route."""
    from quill_tpu.engine.device import TpuEngine

    monkeypatch.delenv("QUILL_MSM_IMPL", raising=False)
    monkeypatch.delenv("QUILL_MSM_SMALL_CHUNKS", raising=False)
    if shift_max is None:
        monkeypatch.delenv("QUILL_MSM_SHIFT_MAX", raising=False)
        eng = TorchEngine("cpu")
    else:
        monkeypatch.setenv("QUILL_MSM_SHIFT_MAX", str(shift_max))
        eng = TorchEngine("cpu", msm_shift_max=shift_max)
    limit = 1 << 20 if shift_max is None else shift_max
    for k in range(1, 71):
        want = TpuEngine._msm_impl(types.SimpleNamespace(x_chunks=[0] * k))
        assert want == ("8" if k * msm5.CHUNK > limit
                        else "5" if k <= 2 else "7")
        for length in (k * msm5.CHUNK - 5, k * msm5.CHUNK):
            got = eng.msm_route(types.SimpleNamespace(length=length))
            assert got == JAX_ROUTE[want], (k, length)


IMPL_ROUTE = {"5": "small", "6": "v6", "7": "cd", "8": "v8"}


@pytest.mark.parametrize("shift_max", [None, 0, 3 << 16])
@pytest.mark.parametrize("impl", ["5", "6", "7", "8"])
def test_impl_route_matches_device_engine(impl, shift_max, monkeypatch):
    """`TorchEngine(msm_impl=...)` routes as `TpuEngine._msm_impl` does
    under QUILL_MSM_IMPL: the default shift bound is 2^20 points under 6
    and 7 and 2^21 under 5 and 8, and impl 8 takes v8 whatever the bound."""
    from quill_tpu.engine.device import TpuEngine

    monkeypatch.setenv("QUILL_MSM_IMPL", impl)
    monkeypatch.delenv("QUILL_MSM_SMALL_CHUNKS", raising=False)
    if shift_max is None:
        monkeypatch.delenv("QUILL_MSM_SHIFT_MAX", raising=False)
    else:
        monkeypatch.setenv("QUILL_MSM_SHIFT_MAX", str(shift_max))
    eng = TorchEngine("cpu", msm_impl=impl, msm_shift_max=shift_max)
    for k in range(1, 71):
        want = TpuEngine._msm_impl(types.SimpleNamespace(x_chunks=[0] * k))
        for length in (k * msm5.CHUNK - 5, k * msm5.CHUNK):
            got = eng.msm_route(types.SimpleNamespace(length=length))
            assert got == IMPL_ROUTE[want], (k, length)
            assert got in eng.msm_counts


@pytest.mark.parametrize("impl", ["1", "3", "9"])
def test_unported_impl_raises(impl):
    with pytest.raises(ValueError, match="not ported"):
        TorchEngine("cpu", msm_impl=impl)


def test_msm_many_batches_in_padded_groups(basis, points, monkeypatch):
    widths = []
    real = msm5.msm_batch

    def spy(b, scalars):
        widths.append(len(scalars))
        return real(b, scalars)

    monkeypatch.setattr(msm5, "msm_batch", spy)
    eng = TorchEngine("cpu", min_device_size=1)
    rng = np.random.default_rng(2)
    lengths = (16, 16, 5, 0, 16, 9)
    jobs = [(eng.basis_slice(basis, n), eng.vec_from_ints(_ints(rng, n)))
            for n in lengths]
    got = eng.msm_many(jobs)
    assert widths == [4, 4]
    assert eng.msm_counts == {"small": 6, "small_batches": 2, "cd": 0,
                              "v8": 0}
    for (b, s), out in zip(jobs, got):
        ints = [int(x) for x in eng.vec_to_ints(s)]
        assert out == curve.msm_host(points[:len(ints)], ints)
    # bases of two roots, or every MSM on kernels C and D: job by job
    other = M.load_basis(points[:16], "cpu")
    eng = TorchEngine("cpu", min_device_size=1)
    assert eng.msm_many([jobs[0], (other, jobs[1][1])]) == got[:2]
    assert eng.msm_counts == {"small": 2, "small_batches": 2, "cd": 0,
                              "v8": 0}
    eng = TorchEngine("cpu", min_device_size=1, msm_small_chunks=0)
    assert eng.msm_many(jobs[:2]) == got[:2]
    assert eng.msm_counts == {"small": 0, "small_batches": 0, "cd": 2,
                              "v8": 0}


def test_shifted_basis_entries(points):
    pts = points[:8]
    root = M.load_basis(pts, "cpu")
    sh = msm5.shifted(root, 0)
    n = len(pts)
    assert sh.shape == (msm5.NWIN * n, 2, fd.NLIMB)
    vals = fd.to_ints(sh.reshape(-1, fd.NLIMB), fd.FQ)
    for w in (0, 1, 7, 19):
        for i, p in enumerate(pts):
            base = G if p.infinity else curve.Jacobian(p.x, p.y, curve.Fq(1))
            want = _affine_ints(base.scalar_mul(1 << (13 * w)))
            row = w * n + i
            assert (vals[2 * row], vals[2 * row + 1]) == want, (w, i)


def _wiring(t, monkeypatch):
    """Integers in coordinate 0 of limb 0, addition for the point add (the
    one-level twins that every CPU path of the tree reaches): the tree must
    give the running sums at the odd positions."""

    def val(x):
        return x[:, 0, 0]

    def pack(v):
        out = torch.zeros((v.shape[0], 3, fd.NLIMB), dtype=torch.int32)
        out[:, 0, 0] = v
        return out

    def up0(sh, idx=None):
        leaves = sh[idx.to(torch.int64)]
        assert leaves.shape[0] % 2 == 0
        return pack(val(leaves)[0::2] + val(leaves)[1::2])

    def up(x):
        assert x.shape[0] % 2 == 0
        return pack(val(x)[0::2] + val(x)[1::2])

    def down(i, u):
        assert u.shape[0] == 2 * i.shape[0]
        out = torch.empty((u.shape[0],), dtype=torch.int32)
        out[0::2] = val(i) - val(u)[1::2]
        out[1::2] = val(i)
        return pack(out)

    monkeypatch.setattr(msm5, "tree_up0", up0)
    monkeypatch.setattr(msm5, "tree_up_plain", up)
    monkeypatch.setattr(msm5, "tree_down_plain", down)
    rng = np.random.default_rng(t)
    v = torch.from_numpy(rng.integers(-1000, 1000, size=t).astype(np.int32))
    sh = torch.zeros((t, 2, fd.NLIMB), dtype=torch.int32)
    sh[:, 0, 0] = v
    # the leaves are read through the sort's rows: here a permutation
    idx = torch.from_numpy(rng.permutation(t).astype(np.int32))
    got = val(msm5.prefix_tree(sh, idx))
    want = torch.cumsum(v[idx.to(torch.int64)], 0)[1::2]
    assert torch.equal(got, want.to(torch.int32))


@pytest.mark.parametrize("t", [2, 6, 10, 20, 640, 1000])
def test_prefix_tree_wiring(t, monkeypatch):
    _wiring(t, monkeypatch)


@pytest.mark.parametrize("t", [2, 6, 10, 20, 640, 1000])
def test_prefix_tree_wiring_two_levels(t, monkeypatch):
    """The same with the fused top at 3 points: the wide levels' two-level
    launches carry most of the tree."""
    monkeypatch.setattr(msm5, "TOP", 3)
    _wiring(t, monkeypatch)


def test_single_and_batched_msm(basis, points):
    rng = np.random.default_rng(3)
    full = EDGES + _ints(rng, 256 - len(EDGES))
    got = msm5.msm_batch(basis, [fd.from_ints(full)])
    assert got[0] == curve.msm_host(points, full)
    batch = [full, _ints(rng, 100), [], [R - 1]]
    got = msm5.msm_batch(basis, [fd.from_ints(s) for s in batch])
    for s, out in zip(batch, got):
        assert out == curve.msm_host(points[:len(s)], s)
    assert got[2].is_identity()


def test_two_chunk_msm(points, monkeypatch):
    """Chunks of 128 points: a 200-point basis has two, the second short."""
    monkeypatch.setattr(msm5, "CHUNK", 128)
    pts = points[:200]
    rng = np.random.default_rng(4)
    batch = [EDGES + _ints(rng, 190), _ints(rng, 150)]
    got = msm5.msm_batch(M.load_basis(pts, "cpu"),
                         [fd.from_ints(s) for s in batch])
    for s, out in zip(batch, got):
        assert out == curve.msm_host(pts[:len(s)], s)


@pytest.fixture(scope="module")
def pairs():
    """Operand pairs with the identity, P + P and P + (-P)."""
    rng = np.random.default_rng(6)
    p = [G.scalar_mul(int(k)) for k in rng.integers(2, 1 << 40, size=6)]
    ident = curve.Jacobian.identity(curve.Fq(1))
    return ([p[0], p[1], p[2], ident, p[3], ident],
            [p[4], p[1], p[2].neg(), p[5], ident, ident])


def _proj(pts):
    return ed.jacobians_to_proj(pts)


def test_kernel_e_twin(pairs):
    lhs, rhs = pairs
    got = msm5.pt_add(_proj(lhs), _proj(rhs))
    assert _proj_ints(got) == [_affine_ints(a.add(b)) for a, b in zip(lhs, rhs)]
    flags = torch.tensor([True, False, True, False, True, False])
    got = msm5.pt_add(_proj(lhs), _proj(rhs), flags)
    want = [b if f else a.add(b) for a, b, f in zip(lhs, rhs, flags.tolist())]
    assert _proj_ints(got) == [_affine_ints(w) for w in want]


def test_kernel_f_twin(pairs):
    lhs, rhs = pairs
    lhs, rhs = lhs[:3], rhs[:3]          # affine operands are never O
    aff, _ = ed.affines_to_tensor([q.to_affine() for q in
                                   [x for ab in zip(lhs, rhs) for x in ab]])
    got = msm5.tree_up0(aff)
    assert _proj_ints(got) == [_affine_ints(a.add(b)) for a, b in zip(lhs, rhs)]


def test_kernel_f_through_index_matches_pallas():
    """Kernel F's twin, reading its leaves through an index, against the
    Pallas kernel it replaces in interpret mode at its smallest shape: 128
    lanes of one leaf pair, leaf (s, m) at x[s, :, m] in the JAX layout
    (8-bit limbs, R = 2^264, bf16).  The port is handed the same points as
    rows of a basis in another order, and idx pairs them as the JAX kernel
    does; P + P and P + (-P) are among the pairs."""
    import jax.numpy as jnp

    from quill_tpu.ec import msm5 as jax_msm5
    from quill_tpu.fields import device8 as f8
    from quill_tpu.fields.bn254 import P

    m = 128
    jax_r = 1 << f8.R_BITS
    rng = np.random.default_rng(15)
    pts = [G.scalar_mul(int(k)).to_affine()
           for k in rng.integers(2, 1 << 40, size=2 * m)]
    pts[m + 3] = pts[3]                                 # P + P
    pts[m + 5] = curve.Affine(pts[5].x, -pts[5].y)      # P + (-P)
    lim = f8.L
    x = np.zeros((2, 2 * lim, m), np.float32)
    for s in range(2):
        row = pts[s * m:(s + 1) * m]
        x[s, :lim] = f8.ints_to_limbs8([p.x.v * jax_r % P for p in row])
        x[s, lim:] = f8.ints_to_limbs8([p.y.v * jax_r % P for p in row])
    out = np.asarray(jax_msm5._up0_call(1, m)(
        jnp.asarray(x, jnp.bfloat16))).astype(np.float64)
    r_inv = pow(jax_r, -1, P)
    want = []
    for j in range(m):
        X, Y, Z = (sum(int(out[0, c * lim + i, j]) << (8 * i)
                       for i in range(lim)) % P * r_inv % P
                   for c in range(3))
        if Z == 0:
            want.append(None)
        else:
            zi = pow(Z, -1, P)
            want.append((X * zi % P, Y * zi % P))

    # the basis holds the points in reverse order; idx[2j], idx[2j + 1]
    # are the rows of lanes j of leaves 0 and 1
    sh, _ = ed.affines_to_tensor(pts[::-1])
    rows = 2 * m - 1 - torch.stack((torch.arange(m), torch.arange(m) + m), 1)
    got = msm5.tree_up0(sh, rows.reshape(-1).to(torch.int32))
    assert _proj_ints(got) == want
    assert want[5] is None and want[3] == _affine_ints(
        curve.Jacobian(pts[3].x, pts[3].y, curve.Fq(1)).double())


def test_kernel_g_twin(pairs):
    lhs, rhs = pairs
    got = msm5.tree_up(_proj([x for ab in zip(lhs, rhs) for x in ab]))
    assert _proj_ints(got) == [_affine_ints(a.add(b)) for a, b in zip(lhs, rhs)]


def test_kernel_h_twin(pairs):
    lhs, rhs = pairs
    u = [x for ab in zip(rhs, rhs[::-1]) for x in ab]
    got = msm5.tree_down(_proj(lhs), _proj(u))
    want = []
    for j, i in enumerate(lhs):
        want += [i.add(u[2 * j + 1].neg()), i]
    assert _proj_ints(got) == [_affine_ints(w) for w in want]
