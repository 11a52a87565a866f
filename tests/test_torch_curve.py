"""quill_tpu_torch plain G1 formulas against `quill_tpu/ec/curve.py`.

The three complete adds (projective, mixed, affine + affine) must give the
same points as the host curve code, including the identity, P + P and
P + (-P).
"""

import numpy as np
import pytest
import torch

from quill_tpu.ec import curve

from quill_tpu_torch.ec import device as ed

torch.set_num_threads(1)

IDENT = curve.Jacobian.identity(curve.Fq(1))


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(11)
    g = curve.g1_generator()
    return [g.scalar_mul(int(k)) for k in rng.integers(2, 1 << 62, size=8)]


def _check(got, a_list, b_list):
    outs = ed.proj_to_jacobians(got)
    for o, a, b in zip(outs, a_list, b_list):
        assert o == a.add(b)


def test_projective_add(points):
    p = points
    lhs = [p[0], p[1], p[2], IDENT, p[3], IDENT, p[4]]
    rhs = [p[5], p[1], p[2].neg(), p[6], IDENT, IDENT, p[4].double()]
    _check(ed.padd(ed.jacobians_to_proj(lhs), ed.jacobians_to_proj(rhs)),
           lhs, rhs)


def test_mixed_add(points):
    p = points
    lhs = [p[0], p[1], p[2], IDENT, p[3].double()]
    rhs = [p[5], p[1], p[2].neg(), p[6], p[7]]
    aff, inf = ed.affines_to_tensor([q.to_affine() for q in rhs])
    assert not bool(inf.any())
    _check(ed.madd(ed.jacobians_to_proj(lhs), aff), lhs, rhs)


def test_affine_add(points):
    p = points
    lhs = [p[0], p[1], p[2], p[3]]
    rhs = [p[5], p[1], p[2].neg(), p[3].neg().neg()]
    a, _ = ed.affines_to_tensor([q.to_affine() for q in lhs])
    b, _ = ed.affines_to_tensor([q.to_affine() for q in rhs])
    _check(ed.aadd(a, b), lhs, rhs)


def test_conversions_and_equality(points):
    t = ed.jacobians_to_proj(points + [IDENT])
    back = ed.proj_to_jacobians(t)
    assert all(x == y for x, y in zip(back, points + [IDENT]))
    # same points, other projective representatives
    doubled = ed.jacobians_to_proj([q.double() for q in points] + [IDENT])
    sums = ed.padd(t, t)
    assert bool(ed.points_equal(sums, doubled).all())
    assert not bool(ed.points_equal(sums[:1], t[:1]).any())
    _, inf = ed.affines_to_tensor(
        [curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True)])
    assert bool(inf.all())
