"""The elementwise field and point functions of quill_tpu_torch
(`fields/vec.py`: kernel L's and kernel E's plain twins on the CPU)
against the JAX package's `quill_tpu/fields/pallas8.py`.

- `mont_mul_vec` against `pallas8.mont_mul_vec` in interpret mode, one
  block of 1024 elements, for Fr and for Fq;
- `pt_add_vec`, `pt_add_b16` and `seg_combine` against the plain reference
  of their Pallas kernels, `pallas8.emit_pt_add` under `jax.jit`: the
  kernels' bodies are that function, and three interpret-mode calls would
  cost ~40 s each on a CPU where the one jitted call costs ~30 s.  The
  operands hold the identity, P + P and P + (-P).  Both sides use the same
  complete formula (RCB15 algorithm 7), so every (X, Y, Z) triple is
  equal, not only the points;
- `bench_field.check_exact` on the CPU, at a small size.

The JAX layout is 33 8-bit limbs with the Montgomery radix 2^264, the
port's eight 32-bit limbs with 2^256, so both sides are compared as
canonical integers.  Inputs come from numpy seeds; tolerance 0.
"""

import numpy as np
import pytest
import torch

from quill_tpu.ec import curve
from quill_tpu.fields.bn254 import P, R

from quill_tpu_torch import bench_field
from quill_tpu_torch.ec import device as ed
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.fields import vec

torch.set_num_threads(1)

JAX_R = 1 << 264
M = 64                       # points per function


def _limbs8(vals, mod):
    from quill_tpu.fields import device8 as f8

    return f8.ints_to_limbs8([int(v) * JAX_R % mod for v in vals])


def _from_limbs8(a, mod):
    """(33, n) lazy limbs -> canonical ints (out of Montgomery form)."""
    a = np.asarray(a).astype(np.float64)
    r_inv = pow(JAX_R, -1, mod)
    return [sum(int(a[i, j]) << (8 * i) for i in range(a.shape[0]))
            % mod * r_inv % mod for j in range(a.shape[1])]


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_mont_mul_vec_matches_pallas(name):
    import jax.numpy as jnp

    from quill_tpu.fields import device8 as f8
    from quill_tpu.fields import pallas8

    mod = R if name == "fr" else P
    rng = np.random.default_rng(21)
    n = 1024
    words = rng.integers(0, 1 << 32, size=(2, n, 8), dtype=np.uint64)
    xs, ys = ([sum(int(w) << (32 * i) for i, w in enumerate(row)) % mod
               for row in part] for part in words)
    xs[:3], ys[:3] = [0, 1, mod - 1], [5, mod - 1, mod - 1]
    spec = f8.FR8 if name == "fr" else f8.FQ8
    out = pallas8.mont_mul_vec(jnp.asarray(_limbs8(xs, mod)),
                               jnp.asarray(_limbs8(ys, mod)), spec)
    want = _from_limbs8(out, mod)
    field = fd.FR if name == "fr" else fd.FQ
    got = vec.mont_mul_vec(fd.from_ints(xs, field), fd.from_ints(ys, field),
                           field)
    assert fd.to_ints(got, field) == want == [x * y % mod
                                              for x, y in zip(xs, ys)]


@pytest.fixture(scope="module")
def operands():
    """Three sets of M point pairs (one per function) with the identity,
    P + P and P + (-P), two flag rows, and the JAX reference: ONE jitted
    `emit_pt_add` over all 3 M lanes -> canonical (X, Y, Z) ints."""
    import jax
    import jax.numpy as jnp

    from quill_tpu.fields import device8 as f8
    from quill_tpu.fields import pallas8

    rng = np.random.default_rng(22)
    g = curve.g1_generator()
    pts = [g.scalar_mul(int(k)) for k in rng.integers(1, 1 << 40, 6 * M)]
    ident = curve.Jacobian.identity(curve.Fq(1))
    lhs, rhs = pts[:3 * M], pts[3 * M:]
    for base in (0, M, 2 * M):
        lhs[base], rhs[base + 1] = ident, ident
        rhs[base + 2] = lhs[base + 2]
        rhs[base + 3] = lhs[base + 3].neg()
    p, q = ed.jacobians_to_proj(lhs), ed.jacobians_to_proj(rhs)
    f1, f2 = rng.random((2, 3 * M)) < 0.5

    def coords(t):
        vals = np.array(fd.to_ints(t.reshape(-1, fd.NLIMB), fd.FQ),
                        dtype=object).reshape(-1, 3)
        return [jnp.asarray(_limbs8(vals[:, c], P)) for c in range(3)]

    fn = jax.jit(lambda a, b: pallas8.emit_pt_add(a, b, f8.FQ8))
    out = fn(tuple(coords(p)), tuple(coords(q)))
    want = np.array([_from_limbs8(c, P) for c in out], dtype=object).T
    return p, q, torch.from_numpy(f1), torch.from_numpy(f2), want


def _triples(t):
    return np.array(fd.to_ints(t.reshape(-1, fd.NLIMB), fd.FQ),
                    dtype=object).reshape(-1, 3)


@pytest.mark.parametrize("which", [0, 1, 2],
                         ids=["pt_add_vec", "pt_add_b16", "seg_combine"])
def test_point_functions_match_emit_pt_add(operands, which):
    p, q, f1, f2, want = operands
    sl = slice(which * M, (which + 1) * M)
    p, q, f1, f2, want = p[sl], q[sl], f1[sl], f2[sl], want[sl]
    if which == 0:
        got = vec.pt_add_vec(p, q)
    elif which == 1:
        got = vec.pt_add_b16(p, q)
    else:
        got, f = vec.seg_combine((p, f1), (q, f2))
        assert torch.equal(f, f1 | f2)
        want = np.where(f2.numpy()[:, None], _triples(q), want)
    assert (_triples(got) == want).all()


def test_bench_field_check_exact_on_cpu():
    assert bench_field.check_exact(torch.device("cpu"), twin_n=128) == dict(
        mont_mul_products=4096, pt_adds_vs_host=64, twin_points=128)
