"""The arithmetic every CUDA kernel shares, compiled for the CPU.

`quill_tpu_torch/csrc/bn254.cuh` is `__host__ __device__` code: here g++
builds it (through the C interface `csrc/bn254_host.cpp`) into a shared
library under `build/quill_tpu_torch/<hash>/`, once, under a file lock,
and its Fr/Fq products and three G1 adds are held against
`fields/scalar.py`-style Python ints and `ec/curve.py`.  Skips only when
g++ is missing.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from quill_tpu.ec import curve

from quill_tpu_torch.ec import device as ed
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.kernels import build

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = ctypes.CDLL(str(build.build_host()))
    for name in ("q_fq_mul", "q_fr_mul", "q_fr_add", "q_fr_sub", "q_fq_add",
                 "q_fq_sub", "q_g1_add", "q_g1_add_mixed", "q_g1_add_affine"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long]
        fn.restype = None
    return lib


def _call(fn, a, b, out_shape):
    a, b = a.contiguous(), b.contiguous()
    out = np.zeros(out_shape, dtype=np.int32)
    fn(a.numpy().ctypes.data, b.numpy().ctypes.data, out.ctypes.data,
       out_shape[0])
    import torch

    return torch.from_numpy(out)


def _vals(seed, n, m):
    rng = np.random.default_rng(seed)
    out = [0, 1, m - 1, m - 2]
    for row in rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64):
        out.append(sum(int(w) << (32 * i) for i, w in enumerate(row)) % m)
    return out


@pytest.mark.parametrize("name,field", [("fr", fd.FR), ("fq", fd.FQ)])
def test_field_ops(lib, name, field):
    m = field.modulus
    xs = _vals(1, 500, m)
    ys = list(reversed(_vals(2, 500, m)))
    a, b = fd.from_ints(xs, field), fd.from_ints(ys, field)
    n = len(xs)
    mul = _call(getattr(lib, f"q_{name}_mul"), a, b, (n, 8))
    add = _call(getattr(lib, f"q_{name}_add"), a, b, (n, 8))
    sub = _call(getattr(lib, f"q_{name}_sub"), a, b, (n, 8))
    assert fd.to_ints(mul, field) == [x * y % m for x, y in zip(xs, ys)]
    assert fd.to_ints(add, field) == [(x + y) % m for x, y in zip(xs, ys)]
    assert fd.to_ints(sub, field) == [(x - y) % m for x, y in zip(xs, ys)]
    # the header and the plain twin agree limb for limb
    assert bool((mul == fd.mul(a, b, field)).all())


def test_g1_adds(lib):
    g = curve.g1_generator()
    rng = np.random.default_rng(3)
    pts = [g.scalar_mul(int(k)) for k in rng.integers(2, 1 << 60, size=6)]
    ident = curve.Jacobian.identity(curve.Fq(1))
    lhs = [pts[0], pts[1], pts[2], ident, pts[3], ident]
    rhs = [pts[4], pts[1], pts[2].neg(), pts[5], ident, ident]
    n = len(lhs)
    got = _call(lib.q_g1_add, ed.jacobians_to_proj(lhs),
                ed.jacobians_to_proj(rhs), (n, 3, 8))
    for o, a, b in zip(ed.proj_to_jacobians(got), lhs, rhs):
        assert o == a.add(b)
    # mixed: affine operand never the identity
    lm, rm = lhs[:4], [pts[4], pts[1], pts[2].neg(), pts[5]]
    aff, _ = ed.affines_to_tensor([q.to_affine() for q in rm])
    got = _call(lib.q_g1_add_mixed, ed.jacobians_to_proj(lm), aff, (4, 3, 8))
    for o, a, b in zip(ed.proj_to_jacobians(got), lm, rm):
        assert o == a.add(b)
    assert bool((got == ed.madd(ed.jacobians_to_proj(lm), aff)).all())
    # affine + affine, including P + P and P + (-P)
    la = [pts[0], pts[1], pts[2]]
    ra = [pts[4], pts[1], pts[2].neg()]
    a, _ = ed.affines_to_tensor([q.to_affine() for q in la])
    b, _ = ed.affines_to_tensor([q.to_affine() for q in ra])
    got = _call(lib.q_g1_add_affine, a, b, (3, 3, 8))
    for o, x, y in zip(ed.proj_to_jacobians(got), la, ra):
        assert o == x.add(y)
    assert bool((got == ed.aadd(a, b)).all())


def test_g1_dbl(lib):
    """`g1_dbl` (algorithm 9) against `g1_add(p, p)` and the host curve's
    doubling as points, the identity included, and the plain twin
    `ed.pdbl` triple for triple."""
    lib.q_g1_dbl.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    lib.q_g1_dbl.restype = None
    g = curve.g1_generator()
    rng = np.random.default_rng(4)
    pts = [g.scalar_mul(int(k)) for k in rng.integers(2, 1 << 60, size=6)]
    pts += [g, curve.Jacobian.identity(curve.Fq(1))]
    p = ed.jacobians_to_proj(pts)
    n = len(pts)
    out = np.zeros((n, 3, 8), dtype=np.int32)
    lib.q_g1_dbl(p.numpy().ctypes.data, out.ctypes.data, n)
    got = torch.from_numpy(out)
    added = _call(lib.q_g1_add, p, p, (n, 3, 8))
    assert bool(ed.points_equal(got, added).all())
    for o, a in zip(ed.proj_to_jacobians(got), pts):
        assert o == a.double()
    assert bool((got[-1, 1] != 0).any()) and not bool(got[-1, 2].any())
    assert bool((got == ed.pdbl(p)).all())


@pytest.mark.parametrize("nwin,wbits", [(20, 13), (16, 16)])
@pytest.mark.parametrize("chunk", [16, None])
def test_shifted_basis_emulation(lib, nwin, wbits, chunk):
    """The shifted-basis thread body (`csrc/ladder.cuh`, run by
    `q_shifted_basis` for every point) on 40 points, three at infinity, in
    chunks of 16 (the last one ragged) or one: the same integers as the
    plain twin (the doubling ladder and one batch normalisation), and rows
    2^(wbits w) P_i by the host curve (the generator's where P_i is at
    infinity)."""
    from quill_tpu_torch.ec import msm5

    fn = lib.q_shifted_basis
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                   ctypes.c_long, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = None
    g = curve.g1_generator()
    rng = np.random.default_rng(nwin)
    pts = [g.scalar_mul(int(k)) for k in rng.integers(2, 1 << 60, size=40)]
    inf = [i in (0, 17, 39) for i in range(40)]
    aff, _ = ed.affines_to_tensor([p.to_affine() for p in pts])
    mask = torch.tensor(inf)
    aff[mask] = 0
    n = len(pts)
    step = n if chunk is None else chunk
    out = np.zeros((nwin * n, 2, 8), dtype=np.int32)
    inf8 = mask.to(torch.uint8)
    fn(aff.numpy().ctypes.data, inf8.numpy().ctypes.data, n, step, nwin,
       wbits, out.ctypes.data)
    got = torch.from_numpy(out)
    assert torch.equal(got, msm5.shifted_basis_plain(aff, mask, nwin, wbits,
                                                     chunk))
    vals = fd.to_ints(got.reshape(-1, 8), fd.FQ)
    for i in (0, 1, 17, 20, 39):
        c0 = i - i % step
        nc = min(step, n - c0)
        base = g if inf[i] else pts[i]
        for w in (0, 1, nwin - 1):
            row = c0 * nwin + w * nc + i - c0
            want = base.scalar_mul(1 << (wbits * w)).to_affine()
            assert (vals[2 * row], vals[2 * row + 1]) == (want.x.v,
                                                          want.y.v), (i, w)
