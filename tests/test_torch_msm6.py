"""The v6 MSM route of quill_tpu_torch (`ec/msm6.py`: kernel K's, E's and
G's plain twins on the CPU) against the JAX package.

- kernel K's twin against ONE interpret-mode call of the Pallas kernel it
  replaces, `quill_tpu.ec.msm6k._lvl_call(128, True)` (`_lvl0_kernel`),
  fed the JAX bf16 leaf layout of the same affine points (~25 s, nearly
  all compile time; add no second call).  The JAX kernel pairs columns
  (c, c + h) of its bit-reversed leaf array, the port's the rows
  idx[2j], idx[2j + 1] of its sorted order, so the port is handed the
  JAX pairing as idx;
- the digits against `quill_tpu.ec.msm6._k_digits16`;
- the tree and the queries against their definition, with integers in
  place of points: level k node s is the sum of the sorted leaves
  [s 2^k, (s + 1) 2^k), and (2^16 - 1) T - S is sum_i d_i v_i, for sizes
  whose trees have one to four levels (the JAX package's own structure
  test, `tests/test_msm6_structure.py`, pins its bit-reversed layout,
  which the port does not have);
- whole MSMs of 200 points (not a power of two, two points at infinity,
  zero scalars) against `quill_tpu.ec.curve.msm_host` and the port's
  kernels C + D (their plain twins), and with every scalar zero;
- `TorchEngine(msm_impl="6")` runs `msm_many` one v6 MSM per job.

Exactness is `==` on canonical integers; points are compared as points.
"""

import numpy as np
import pytest
import torch

from quill_tpu.ec import curve
from quill_tpu.fields.bn254 import P, R
from quill_tpu.fields.limbs import ints_to_limbs

from quill_tpu_torch.ec import device as ed
from quill_tpu_torch.ec import msm as M
from quill_tpu_torch.ec import msm5, msm6
from quill_tpu_torch.engine.device import TorchEngine
from quill_tpu_torch.fields import device as fd

torch.set_num_threads(1)

G = curve.g1_generator()
INF = curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True)
JAX_R = 1 << 264
MASK32 = (1 << 32) - 1


def _ints(rng, n):
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % R
            for row in words]


def _affine_ints(pt):
    a = pt.to_affine()
    return None if a.infinity else (a.x.v, a.y.v)


def test_level0_twin_matches_pallas():
    import jax.numpy as jnp

    from quill_tpu.ec import msm6k
    from quill_tpu.fields import device8 as f8

    h = 128
    rng = np.random.default_rng(12)
    pts = [G.scalar_mul(int(k)).to_affine()
           for k in rng.integers(2, 1 << 40, size=2 * h)]
    pts[h + 3] = pts[3]                               # P + P
    pts[h + 5] = curve.Affine(pts[5].x, -pts[5].y)      # P + (-P)
    lim = f8.L
    leaves = np.zeros((2 * lim, 2 * h), np.float32)
    leaves[:lim] = f8.ints_to_limbs8([p.x.v * JAX_R % P for p in pts])
    leaves[lim:] = f8.ints_to_limbs8([p.y.v * JAX_R % P for p in pts])
    out = np.asarray(msm6k._lvl_call(h, True)(
        jnp.asarray(leaves, jnp.bfloat16))).astype(np.float64)
    r_inv = pow(JAX_R, -1, P)
    want = []
    for j in range(h):
        x, y, z = (sum(int(out[c * lim + i, j]) << (8 * i)
                       for i in range(lim)) % P * r_inv % P
                   for c in range(3))
        if z == 0:
            want.append(None)
        else:
            zi = pow(z, -1, P)
            want.append((x * zi % P, y * zi % P))

    sh, _ = ed.affines_to_tensor(pts)
    idx = torch.stack((torch.arange(h), torch.arange(h) + h), 1).reshape(-1)
    got = msm6.level0(sh, idx.to(torch.int32))
    assert [_affine_ints(p) for p in ed.proj_to_jacobians(got)] == want
    assert want[5] is None and want[3] == _affine_ints(
        curve.Jacobian(pts[3].x, pts[3].y, curve.Fq(1)).double())


def test_digits_match_k_digits16():
    import jax.numpy as jnp

    from quill_tpu.ec import msm6 as jax_msm6

    rng = np.random.default_rng(13)
    ints = [0, 1, R - 1, R - 2, (1 << 254) % R, 0xFFFF, 1 << 16] \
        + _ints(rng, 57)
    inf = np.zeros(len(ints), bool)
    inf[[1, 9]] = True
    want = np.asarray(jax_msm6._k_digits16(jnp.asarray(ints_to_limbs(ints)),
                                           jnp.asarray(inf)))
    got = msm6.digits16(fd.ints_to_tensor(ints))
    got = got.masked_fill(torch.from_numpy(inf)[:, None], 0)
    assert np.array_equal(got.numpy().T, want)


# -- the definition, with integers in place of points ------------------------


def _val(x):
    return x[:, 0, 0].to(torch.int64)


def _pack(v):
    out = torch.zeros((v.shape[0], 3, fd.NLIMB), dtype=torch.int32)
    out[:, 0, 0] = v.to(torch.int32)
    return out


@pytest.fixture()
def int_world(monkeypatch):
    """Point adds become integer adds of coordinate 0, limb 0 (the identity
    (0 : 1 : 0) is 0 there); every index path runs for real."""
    def level0(sh, idx):
        v = sh[idx.to(torch.int64), 0, 0].to(torch.int64)
        return _pack(v[0::2] + v[1::2])

    monkeypatch.setattr(msm6, "level0", level0)
    # the one-level twin that kernel G's one- and two-level wrappers and
    # the fused top's reduce mode reach on the CPU
    monkeypatch.setattr(msm5, "tree_up_plain",
                        lambda x: _pack(_val(x)[0::2] + _val(x)[1::2]))
    monkeypatch.setattr(msm5, "pt_add",
                        lambda a, b, flags=None: _pack(_val(a) + _val(b)))
    monkeypatch.setattr(msm6, "add_where", lambda node, acc, has: _pack(
        torch.where(has, _val(node) + _val(acc), _val(acc))))


@pytest.mark.parametrize("n", [1, 5, 200, 1000])
def test_tree_and_queries_match_definition(int_world, n):
    rng = np.random.default_rng(n)
    scalars = _ints(rng, n)
    scalars[0] = 0
    if n > 4:
        scalars[1:4] = [R - 1, 0xFFFF << 48, 1]
    inf = torch.zeros(n, dtype=torch.bool)
    inf[n // 2] = n > 1
    width = n + 3                        # a wider cached basis than needed
    vals = torch.from_numpy(rng.integers(1, 1 << 11, size=(msm6.NWIN, width)))
    sh = torch.zeros((msm6.NWIN * width, 2, fd.NLIMB), dtype=torch.int32)
    sh[:, 0, 0] = vals.reshape(-1).to(torch.int32)

    keys, idx = msm6.sort_keys(fd.ints_to_tensor(scalars), inf, width)
    fl = keys.shape[0]
    assert fl == msm6.NWIN << (n - 1).bit_length()
    assert torch.equal(keys, torch.sort(keys).values)
    leaves = _val(sh[idx.to(torch.int64)])
    levels = msm6.tree(sh, idx)
    for k, lvl in enumerate(levels, 1):
        assert torch.equal(_val(lvl), leaves.reshape(-1, 1 << k).sum(1))
    assert levels[-1].shape[0] <= msm6.MIN_TOP
    assert len(levels) == 1 or levels[-2].shape[0] > msm6.MIN_TOP
    top = msm6.prefix(levels[-1])
    assert torch.equal(_val(top), torch.cumsum(_val(levels[-1]), 0))
    cnt = torch.searchsorted(keys, torch.arange(msm6.NQ, dtype=torch.int32),
                             right=True)
    acc = msm6.queries(cnt, sh, idx, levels, top)
    pre = torch.cat((torch.zeros(1, dtype=torch.int64),
                     torch.cumsum(leaves, 0)))
    assert torch.equal(_val(acc), pre[cnt])
    s = int(_val(msm6.reduce_sum(torch.cat((acc, _pack(torch.zeros(1)))))))
    got = (msm6.NQ * int(_val(top[-1:])) - s) & MASK32
    want = 0
    for i, x in enumerate(scalars):
        for w in range(msm6.NWIN):
            if not inf[i]:
                want += ((x >> (16 * w)) & 0xFFFF) * int(vals[w, i])
    assert got == want & MASK32


# -- whole MSMs --------------------------------------------------------------


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(14)
    pts = [G.scalar_mul(int(k)).to_affine()
           for k in rng.integers(2, 1 << 40, size=200)]
    pts[3] = pts[150] = INF
    return pts


@pytest.fixture(scope="module")
def basis(points):
    """One basis for both MSMs, so its shifted basis is built once."""
    return M.load_basis(points, "cpu")


@pytest.mark.parametrize("case", ["mixed", "zero"])
def test_msm_matches_host_and_cd(basis, points, case):
    rng = np.random.default_rng(15)
    if case == "zero":
        scalars = [0] * len(points)
    else:
        scalars = _ints(rng, len(points))
        scalars[:4] = [0, 1, R - 1, 0xFFFF]
        scalars[20:30] = [0] * 10
    s = fd.from_ints(scalars)
    got = msm6.msm(basis, s)
    assert got == curve.msm_host(points, scalars)
    assert got == M.msm(basis, s, plain=True)
    assert got.is_identity() == (case == "zero")
    assert basis.shifted[msm6.CACHE_KEY].shape == (msm6.NWIN, 200, 2,
                                                   fd.NLIMB)


def test_msm_many_runs_one_v6_msm_per_job(monkeypatch):
    """Chunks of 16 points: bases of 33 to 48 points have three chunks and
    take v6 under msm_impl 6; msm_many runs them one at a time.  The v6
    MSM itself is the test above's: here C + D's plain twins stand in."""
    calls = []

    def spy(basis, scalars):
        calls.append(basis.length)
        return M.msm(basis, scalars, plain=True)

    monkeypatch.setattr(msm5, "CHUNK", 16)
    monkeypatch.setattr(msm6, "msm", spy)
    rng = np.random.default_rng(16)
    pts = [G.scalar_mul(int(k)).to_affine()
           for k in rng.integers(2, 1 << 40, size=48)]
    eng = TorchEngine("cpu", min_device_size=1, msm_impl="6")
    basis = eng.load_points(pts)
    scalars = _ints(rng, 48)
    jobs = [(eng.basis_slice(basis, n), eng.vec_from_ints(scalars[:n]))
            for n in (48, 40, 35)]
    got = eng.msm_many(jobs)
    assert calls == [48, 40, 35]
    assert eng.msm_counts == {"small": 0, "small_batches": 0, "v6": 3,
                              "v8": 0}
    for (b, _), out in zip(jobs, got):
        assert out == curve.msm_host(pts[:b.length], scalars[:b.length])
