"""Plain-PyTorch BN254 G1 arithmetic, and conversions to `ec/curve.py`.

Counterpart of `quill_tpu/ec/device.py` and of the in-kernel bodies
`quill_tpu/fields/pallas8.py: emit_pt_add` and
`quill_tpu/ec/msm5.py: emit_pt_add_aff`.  The formulas are the complete
ones of Renes, Costello and Batina (eprint 2015/1060) for a = 0,
b3 = 3 * 3 = 9, exactly as `csrc/bn254.cuh` writes them:

- `padd`: projective + projective (algorithm 7), 12 multiplications;
- `madd`: projective + affine (algorithm 8), 11 multiplications;
- `aadd`: affine + affine (algorithm 8 with Z1 = 1), 9 multiplications;
- `pdbl`: doubling (algorithm 9), 8 multiplications.

Points are homogeneous projective (X : Y : Z), affine x = X/Z, y = Y/Z;
the identity is (0 : 1 : 0).  Storage is `(n, 3, 8)` int32 (projective)
or `(n, 2, 8)` int32 (affine), every coordinate in Fq Montgomery form.
Inside a formula the coordinates are w16 tensors `(n, k, 16)` int64, and
the independent products of each stage go through ONE batched `w_mul`.
"""

from __future__ import annotations

import torch

from ..fields import device as fd
from ..fields.device import FQ
from . import curve

B3 = 9


def _mul(a, b):
    return fd.w_mul(a, b, FQ)


def _add(a, b):
    return fd.w_add(a, b, FQ)


def _sub(a, b):
    return fd.w_sub(a, b, FQ)


def _minus(a):
    """p - a: a valid addend for `_add` (p itself where a = 0)."""
    p = fd._c(FQ, a)["p"]
    return fd._exact_sub(p.expand_as(a), a)


def _split(t, k):
    return [t[..., i, :] for i in range(k)]


def _smalls(device, *ks):
    """Montgomery constants ks as a (len(ks), 16) w16 tensor."""
    return torch.stack([fd.w_const(k, FQ, device) for k in ks], 0)


def _finish(t0, t1, t3, t4, y3, z3):
    """Shared tail of algorithms 7 and 8 (six products, one batch):
    X3 = t3 t1 - t4 y3, Y3 = t1 z3 + y3 t0, Z3 = z3 t4 + t0 t3."""
    m = _mul(torch.stack((t4, t3, y3, t1, t0, z3), -2),
             torch.stack((y3, t1, t0, z3, t3, t4), -2))
    a, b, c, d, e, f = _split(m, 6)
    return _add(torch.stack((b, d, f), -2),
                torch.stack((_minus(a), c, e), -2))


def _tail(t0, t1, t2, t3, t4, y3):
    """t0 *= 3, t2 *= b3, y3 *= b3, z3 = t1 + t2, t1 -= t2, then finish."""
    k = _mul(torch.stack((t0, t2, y3), -2), _smalls(t0.device, 3, B3, B3))
    t0, t2, y3 = _split(k, 3)
    zt = _add(torch.stack((t1, t1), -2), torch.stack((t2, _minus(t2)), -2))
    z3, t1 = _split(zt, 2)
    return _finish(t0, t1, t3, t4, y3, z3)


def padd_w(p, q):
    """Complete projective add on w16 tensors (..., 3, 16)."""
    X1, Y1, Z1 = _split(p, 3)
    X2, Y2, Z2 = _split(q, 3)
    s = _add(torch.stack((X1, Y1, X1, X2, Y2, X2), -2),
             torch.stack((Y1, Z1, Z1, Y2, Z2, Z2), -2))
    m = _mul(torch.cat((p, s[..., 0:3, :]), -2),
             torch.cat((q, s[..., 3:6, :]), -2))
    t0, t1, t2, m3, m4, m5 = _split(m, 6)
    # t3 = (X1+Y1)(X2+Y2) - (t0+t1); t4 = (Y1+Z1)(Y2+Z2) - (t1+t2);
    # y3 = (X1+Z1)(X2+Z2) - (t0+t2)
    sums = _add(torch.stack((t0, t1, t0), -2), torch.stack((t1, t2, t2), -2))
    t3, t4, y3 = _split(_sub(torch.stack((m3, m4, m5), -2), sums), 3)
    return _tail(t0, t1, t2, t3, t4, y3)


def madd_w(p, q):
    """Complete projective + affine add (q is (..., 2, 16), never the
    identity)."""
    X1, Y1, Z1 = _split(p, 3)
    X2, Y2 = _split(q, 2)
    s = _add(torch.stack((X1, X2), -2), torch.stack((Y1, Y2), -2))
    m = _mul(torch.stack((X1, Y1, s[..., 0, :], Y2, X2), -2),
             torch.stack((X2, Y2, s[..., 1, :], Z1, Z1), -2))
    t0, t1, m3, y2z1, x2z1 = _split(m, 5)
    u = _add(torch.stack((t0, y2z1, x2z1), -2),
             torch.stack((t1, Y1, X1), -2))
    t01, t4, y3 = _split(u, 3)
    t3 = _sub(m3, t01)
    return _tail(t0, t1, Z1, t3, t4, y3)


def aadd_w(p, q):
    """Complete affine + affine add (neither is the identity)."""
    X1, Y1 = _split(p, 2)
    X2, Y2 = _split(q, 2)
    s = _add(torch.stack((X1, X2, Y1, X1), -2),
             torch.stack((Y1, Y2, Y2, X2), -2))
    m = _mul(torch.stack((X1, Y1, s[..., 0, :]), -2),
             torch.stack((X2, Y2, s[..., 1, :]), -2))
    t0, t1, m3 = _split(m, 3)
    t3 = _sub(m3, _add(t0, t1))
    one = fd.w_const(1, FQ, p.device).expand_as(t1)
    return _tail(t0, t1, one, t3, s[..., 2, :], s[..., 3, :])


def pdbl_w(p):
    """Complete projective doubling on w16 tensors (..., 3, 16): algorithm
    9 (a = 0), in `csrc/bn254.cuh: g1_dbl`'s steps, so the same triples."""
    X, Y, Z = _split(p, 3)
    m = _mul(torch.stack((Y, Y, Z, X), -2), torch.stack((Y, Z, Z, Y), -2))
    t0, t1, zz, xy = _split(m, 4)
    t2 = _mul(zz, _smalls(p.device, B3)[0])
    z3 = _add(t0, t0)
    z3 = _add(z3, z3)
    z3 = _add(z3, z3)
    y3 = _add(t0, t2)
    u = _sub(t0, _add(_add(t2, t2), t2))
    m = _mul(torch.stack((t2, t1, u, u), -2), torch.stack((z3, z3, y3, xy),
                                                          -2))
    x3, zr, uy, ux = _split(m, 4)
    return torch.stack((_add(ux, ux), _add(x3, uy), zr), -2)


# -- storage-level wrappers ---------------------------------------------------


def padd(p, q):
    return fd.from_w16(padd_w(fd.to_w16(p), fd.to_w16(q)))


def madd(p, q):
    return fd.from_w16(madd_w(fd.to_w16(p), fd.to_w16(q)))


def aadd(p, q):
    return fd.from_w16(aadd_w(fd.to_w16(p), fd.to_w16(q)))


def pdbl(p):
    return fd.from_w16(pdbl_w(fd.to_w16(p)))


def identity_w(shape, device):
    """w16 identity points of leading shape `shape`: (0 : 1 : 0)."""
    out = torch.zeros(*shape, 3, fd.NW, dtype=torch.int64,
                      device=torch.device(device))
    out[..., 1, :] = fd.w_const(1, FQ, device)
    return out


def identity(n: int, device) -> torch.Tensor:
    """(n, 3, 8) int32 identity points."""
    out = torch.zeros((n, 3, fd.NLIMB), dtype=torch.int32,
                      device=torch.device(device))
    out[:, 1] = fd.const(1, FQ, device)
    return out


def affine_to_proj_w(q):
    """(..., 2, 16) affine -> (..., 3, 16) projective with Z = 1."""
    one = fd.w_const(1, FQ, q.device).expand_as(q[..., 0, :])
    return torch.cat((q, one.unsqueeze(-2)), -2)


def neg_y_w(q, flags):
    """Negate y where the boolean `flags` (leading shape) is set."""
    y = q[..., 1, :]
    ny = fd.w_neg(y, FQ)
    y = torch.where(flags.unsqueeze(-1), ny, y)
    return torch.cat((q[..., :1, :], y.unsqueeze(-2), q[..., 2:, :]), -2)


def points_equal(p, q) -> torch.Tensor:
    """Projective equality of two (n, 3, 8) tensors: X1 Z2 == X2 Z1 and
    Y1 Z2 == Y2 Z1 (also right when one or both are the identity)."""
    pw, qw = fd.to_w16(p), fd.to_w16(q)
    lhs = _mul(torch.stack((pw[..., 0, :], pw[..., 1, :]), -2),
               qw[..., 2:3, :])
    rhs = _mul(torch.stack((qw[..., 0, :], qw[..., 1, :]), -2),
               pw[..., 2:3, :])
    return (lhs == rhs).all(-1).all(-1)


# -- conversions to and from ec/curve.py ---------------------------------------


def affines_to_tensor(points: list, device="cpu"):
    """curve.Affine list -> ((n, 2, 8) Montgomery Fq tensor, (n,) bool
    infinity mask).  Points at infinity are stored as (0, 0)."""
    xs, ys, inf = [], [], []
    for pt in points:
        if pt.infinity:
            xs.append(0)
            ys.append(0)
            inf.append(True)
        else:
            xs.append(pt.x.v)
            ys.append(pt.y.v)
            inf.append(False)
    xy = fd.from_ints(xs + ys, FQ, device)
    n = len(points)
    t = torch.stack((xy[:n], xy[n:]), 1)
    mask = torch.tensor(inf, dtype=torch.bool, device=torch.device(device))
    return t, mask


def proj_to_jacobians(t: torch.Tensor) -> list:
    """(n, 3, 8) projective tensor -> curve.Jacobian list, without an
    inversion: (X : Y : Z) projective is (X Z, Y Z^2, Z) Jacobian."""
    n = t.shape[0]
    vals = fd.to_ints(t.reshape(n * 3, fd.NLIMB), FQ)
    out = []
    for i in range(n):
        X, Y, Z = (curve.Fq(v) for v in vals[3 * i:3 * i + 3])
        if Z.is_zero():
            out.append(curve.Jacobian.identity(curve.Fq(1)))
        else:
            out.append(curve.Jacobian(X * Z, Y * Z * Z, Z))
    return out


def jacobians_to_proj(points: list, device="cpu") -> torch.Tensor:
    """curve.Jacobian list -> (n, 3, 8) projective tensor:
    (X, Y, Z) Jacobian is (X Z : Y : Z^3) projective."""
    vals = []
    for pt in points:
        if pt.is_identity():
            vals += [0, 1, 0]
        else:
            vals += [(pt.X * pt.Z).v, pt.Y.v, (pt.Z * pt.Z * pt.Z).v]
    return fd.from_ints(vals, FQ, device).reshape(len(points), 3, fd.NLIMB)
