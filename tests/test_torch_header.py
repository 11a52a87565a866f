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
