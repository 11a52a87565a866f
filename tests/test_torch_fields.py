"""quill_tpu_torch field arithmetic and layout conversion against the JAX
package's exact references.

Every comparison is exact `==` on canonical integers: prime-field
arithmetic has no tolerance.  Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

from quill_tpu.fields import scalar
from quill_tpu.fields.bn254 import P, R
from quill_tpu.fields.limbs import ints_to_limbs

from quill_tpu_torch import convert
from quill_tpu_torch.ec import msm as port_msm
from quill_tpu_torch.fields import device as fd

torch.set_num_threads(1)

N = 1024


def _rand_ints(seed: int, n: int, modulus: int) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    out = []
    for row in words:
        v = 0
        for i, w in enumerate(row):
            v |= int(w) << (32 * i)
        out.append(v % modulus)
    return out


def _edge(modulus: int) -> list[int]:
    return [0, 1, modulus - 1, modulus - 2, (1 << 255) % modulus,
            (1 << 32) - 1, 1 << 128]


@pytest.fixture(params=["fr", "fq"])
def field(request):
    return fd.FR if request.param == "fr" else fd.FQ


def test_roundtrip_and_montgomery(field):
    m = field.modulus
    xs = _edge(m) + _rand_ints(1, N, m)
    t = fd.from_ints(xs, field)
    assert t.shape == (len(xs), 8) and t.dtype.is_signed
    assert fd.to_ints(t, field) == [x % m for x in xs]
    # the stored limbs are the Montgomery form x * 2^256 mod m
    assert fd.tensor_to_ints(t) == [x * (1 << 256) % m for x in xs]


def test_add_sub_neg_mul(field):
    m = field.modulus
    xs = _edge(m) + _rand_ints(2, N, m)
    ys = list(reversed(_edge(m))) + _rand_ints(3, N, m)
    a, b = fd.from_ints(xs, field), fd.from_ints(ys, field)
    assert fd.to_ints(fd.add(a, b, field), field) == [
        (x + y) % m for x, y in zip(xs, ys)]
    assert fd.to_ints(fd.sub(a, b, field), field) == [
        (x - y) % m for x, y in zip(xs, ys)]
    assert fd.to_ints(fd.sub(b, a, field), field) == [
        (y - x) % m for x, y in zip(xs, ys)]
    assert fd.to_ints(fd.neg(a, field), field) == [(-x) % m for x in xs]
    assert fd.to_ints(fd.mul(a, b, field), field) == [
        x * y % m for x, y in zip(xs, ys)]


def test_scalar_ops_and_sum(field):
    m = field.modulus
    xs = _edge(m) + _rand_ints(4, N, m)
    a = fd.from_ints(xs, field)
    for c in (0, 1, m - 1, 987654321987654321):
        assert fd.to_ints(fd.mul_scalar(a, c, field), field) == [
            x * c % m for x in xs]
        assert fd.to_ints(fd.add_scalar(a, c, field), field) == [
            (x + c) % m for x in xs]
    assert fd.vsum(a, field) == sum(xs) % m
    assert fd.vsum(a[:0], field) == 0


def test_inverse_matches_scalar_module():
    xs = [x or 1 for x in _rand_ints(5, 64, R)] + [1, R - 1]
    inv_t = fd.from_ints(scalar.batch_inverse(xs, R))
    prod = fd.mul(fd.from_ints(xs), inv_t)
    assert fd.to_ints(prod) == [1] * len(xs)


def test_powers():
    x = 123456789123456789
    got = fd.to_ints(fd.powers(x, 37))
    assert got == [pow(x, j, R) for j in range(37)]


# -- conversions from the JAX layouts -------------------------------------


def test_convert_limbs12_plain_and_montgomery():
    xs = _edge(R) + _rand_ints(6, 300, R)
    arr = ints_to_limbs(xs)                         # (22, N), JAX layout
    assert fd.to_ints(convert.from_limbs12(arr, montgomery=False)) == xs
    mont = [x * (1 << 264) % R for x in xs]          # JAX radix 2^264
    t = convert.from_limbs12(ints_to_limbs(mont), montgomery=True)
    assert fd.to_ints(t) == xs


def test_convert_limbs8():
    from quill_tpu.fields.device8 import ints_to_limbs8

    xs = _edge(P) + _rand_ints(7, 200, P)
    t = convert.from_limbs8(ints_to_limbs8(xs), montgomery=False,
                            field=fd.FQ)
    assert fd.to_ints(t, fd.FQ) == xs
    mont = [x * (1 << 264) % P for x in xs]
    t = convert.from_limbs8(ints_to_limbs8(mont), montgomery=True,
                            field=fd.FQ)
    assert fd.to_ints(t, fd.FQ) == xs


def test_convert_dvec_and_host_vec():
    from quill_tpu.engine.device import DVec
    from quill_tpu.engine.host import HostEngine

    xs = _rand_ints(8, 700, R)
    mont = [x * (1 << 264) % R for x in xs] + [0] * 324   # zero tail
    limbs = ints_to_limbs(mont)
    dv = DVec(chunks=[limbs[:, :512], limbs[:, 512:]], length=700)
    assert fd.to_ints(convert.from_dvec(dv)) == xs
    hv = HostEngine().vec_from_ints(xs)
    assert fd.to_ints(convert.from_host_vec(hv)) == xs


def test_convert_device_basis():
    from quill_tpu.ec import curve
    from quill_tpu.ec.msm import DeviceBasis

    g = curve.g1_generator()
    pts = [g.scalar_mul(k).to_affine() for k in (1, 2, 3, 99, 12345)]
    pts.insert(2, curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True))
    xm = [0 if p.infinity else p.x.v * (1 << 264) % P for p in pts]
    ym = [0 if p.infinity else p.y.v * (1 << 264) % P for p in pts]
    basis = DeviceBasis(affines=pts, x_chunks=[ints_to_limbs(xm + [0, 0])],
                        y_chunks=[ints_to_limbs(ym + [0, 0])],
                        inf_chunks=[np.array([p.infinity for p in pts]
                                             + [True, True])],
                        length=len(pts))
    got = convert.from_device_basis(basis)
    want = port_msm.load_basis(pts, "cpu")
    assert got.length == want.length == len(pts)
    assert bool((got.xy == want.xy).all())
    assert bool((got.inf == want.inf).all())
