"""Host-side BN254 elliptic-curve arithmetic (G1 over Fq, G2 over Fq2).

Generic short-Weierstrass Jacobian formulas parameterized by the coefficient
field, used for: trusted setup, verifier-side point algebra, the small-size
tail of device MSMs, and as the exact oracle for device EC kernel tests.

Counterpart of `ark_ec::CurveGroup` usage in the reference
(`quill-zkvm/pcs/src/kzg.rs:1-8,61-73`).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.bn254 import B_COEFF, G1_X, G1_Y, G2_X, G2_Y, P
from ..fields.scalar import inv
from .tower import Fq2


class Fq:
    """Thin wrapper giving Python ints the field-element interface shared
    with Fq2, so curve formulas below are written once."""

    __slots__ = ("v",)

    def __init__(self, v: int):
        self.v = v % P

    @staticmethod
    def zero():
        return Fq(0)

    @staticmethod
    def one():
        return Fq(1)

    def is_zero(self):
        return self.v == 0

    def __eq__(self, o):
        return self.v == o.v

    def __add__(self, o):
        return Fq(self.v + o.v)

    def __sub__(self, o):
        return Fq(self.v - o.v)

    def __neg__(self):
        return Fq(-self.v)

    def __mul__(self, o):
        return Fq(self.v * o.v)

    def mul_scalar(self, k: int):
        return Fq(self.v * k)

    def square(self):
        return Fq(self.v * self.v)

    def inverse(self):
        return Fq(inv(self.v, P))

    def __repr__(self):
        return f"Fq({self.v})"


@dataclass(frozen=True)
class Affine:
    """Affine point; `infinity` true means the identity (x, y ignored)."""

    x: object
    y: object
    infinity: bool = False


class Jacobian:
    """Jacobian projective point (X, Y, Z): affine (X/Z^2, Y/Z^3); Z=0 = identity."""

    __slots__ = ("X", "Y", "Z")

    def __init__(self, X, Y, Z):
        self.X, self.Y, self.Z = X, Y, Z

    @staticmethod
    def identity(field_one):
        zero = field_one - field_one
        return Jacobian(field_one, field_one, zero)

    def is_identity(self):
        return self.Z.is_zero()

    def double(self) -> "Jacobian":
        if self.is_identity():
            return self
        X1, Y1, Z1 = self.X, self.Y, self.Z
        A = X1.square()
        B = Y1.square()
        C = B.square()
        D = ((X1 + B).square() - A - C).mul_scalar(2)
        E = A.mul_scalar(3)
        F = E.square()
        X3 = F - D.mul_scalar(2)
        Y3 = E * (D - X3) - C.mul_scalar(8)
        Z3 = (Y1 * Z1).mul_scalar(2)
        return Jacobian(X3, Y3, Z3)

    def add(self, other: "Jacobian") -> "Jacobian":
        if self.is_identity():
            return other
        if other.is_identity():
            return self
        X1, Y1, Z1 = self.X, self.Y, self.Z
        X2, Y2, Z2 = other.X, other.Y, other.Z
        Z1Z1 = Z1.square()
        Z2Z2 = Z2.square()
        U1 = X1 * Z2Z2
        U2 = X2 * Z1Z1
        S1 = Y1 * Z2 * Z2Z2
        S2 = Y2 * Z1 * Z1Z1
        if U1 == U2:
            if S1 == S2:
                return self.double()
            return Jacobian.identity(_one_like(X1))
        H = U2 - U1
        I = H.mul_scalar(2).square()
        J = H * I
        r = (S2 - S1).mul_scalar(2)
        V = U1 * I
        X3 = r.square() - J - V.mul_scalar(2)
        Y3 = r * (V - X3) - (S1 * J).mul_scalar(2)
        Z3 = ((Z1 + Z2).square() - Z1Z1 - Z2Z2) * H
        return Jacobian(X3, Y3, Z3)

    def add_affine(self, other: Affine) -> "Jacobian":
        """Mixed addition (other.Z == 1)."""
        if other.infinity:
            return self
        if self.is_identity():
            one = _one_like(other.x)
            return Jacobian(other.x, other.y, one)
        X1, Y1, Z1 = self.X, self.Y, self.Z
        Z1Z1 = Z1.square()
        U2 = other.x * Z1Z1
        S2 = other.y * Z1 * Z1Z1
        if X1 == U2:
            if Y1 == S2:
                return self.double()
            return Jacobian.identity(_one_like(X1))
        H = U2 - X1
        HH = H.square()
        I = HH.mul_scalar(4)
        J = H * I
        r = (S2 - Y1).mul_scalar(2)
        V = X1 * I
        X3 = r.square() - J - V.mul_scalar(2)
        Y3 = r * (V - X3) - (Y1 * J).mul_scalar(2)
        Z3 = (Z1 + H).square() - Z1Z1 - HH
        return Jacobian(X3, Y3, Z3)

    def neg(self) -> "Jacobian":
        return Jacobian(self.X, -self.Y, self.Z)

    def scalar_mul(self, k: int) -> "Jacobian":
        k = int(k)
        if k < 0:
            return self.neg().scalar_mul(-k)
        result = Jacobian.identity(_one_like(self.X))
        base = self
        while k > 0:
            if k & 1:
                result = result.add(base)
            base = base.double()
            k >>= 1
        return result

    def to_affine(self) -> Affine:
        if self.is_identity():
            one = _one_like(self.X)
            zero = one - one
            return Affine(zero, zero, infinity=True)
        z_inv = self.Z.inverse()
        z_inv2 = z_inv.square()
        return Affine(self.X * z_inv2, self.Y * z_inv2 * z_inv)

    def __eq__(self, other) -> bool:
        if self.is_identity() or other.is_identity():
            return self.is_identity() and other.is_identity()
        # X1 Z2^2 == X2 Z1^2  and  Y1 Z2^3 == Y2 Z1^3
        Z1Z1 = self.Z.square()
        Z2Z2 = other.Z.square()
        return (self.X * Z2Z2 == other.X * Z1Z1) and (
            self.Y * Z2Z2 * other.Z == other.Y * Z1Z1 * self.Z
        )


def _one_like(x):
    return x.one() if not isinstance(x, Fq2) else Fq2.one()


# -- G1 convenience ---------------------------------------------------------


def g1_generator() -> Jacobian:
    return Jacobian(Fq(G1_X), Fq(G1_Y), Fq(1))


def g1_affine_generator() -> Affine:
    return Affine(Fq(G1_X), Fq(G1_Y))


def g1_is_on_curve(p: Affine) -> bool:
    if p.infinity:
        return True
    return p.y.square() == p.x.square() * p.x + Fq(B_COEFF)


def batch_to_affine(points: list[Jacobian]) -> list[Affine]:
    """Batch Jacobian->affine with one field inversion (Montgomery's trick).

    Fixes the reference's per-commit per-point `into_affine` loop
    (`quill-zkvm/pcs/src/kzg.rs:67-71`) at the host level too.
    G1 batches route to the native C backend (`native/ec_g1.c`) when built.
    """
    n = len(points)
    if n and isinstance(points[0].X, Fq):
        from . import native_ec

        if native_ec.available():
            return native_ec.batch_to_affine(points)
    zs = [p.Z for p in points]
    out: list[Affine | None] = [None] * n
    prefix = [None] * n
    acc = None
    for i, z in enumerate(zs):
        if z.is_zero():
            continue
        acc = z if acc is None else acc * z
        prefix[i] = acc
    if acc is None:
        one = _one_like(points[0].X) if points else Fq(1)
        zero = one - one
        return [Affine(zero, zero, infinity=True)] * n
    acc_inv = acc.inverse()
    for i in range(n - 1, -1, -1):
        p = points[i]
        if p.Z.is_zero():
            one = _one_like(p.X)
            zero = one - one
            out[i] = Affine(zero, zero, infinity=True)
            continue
        prev = None
        for j in range(i - 1, -1, -1):
            if prefix[j] is not None:
                prev = prefix[j]
                break
        z_inv = acc_inv * prev if prev is not None else acc_inv
        acc_inv = acc_inv * p.Z
        z_inv2 = z_inv.square()
        out[i] = Affine(p.X * z_inv2, p.Y * z_inv2 * z_inv)
    return out


def g1_tau_powers(tau: int, count: int) -> list[Affine]:
    """[G, tau G, ..., tau^(count - 1) G] as affine points: the powers of
    tau as scalars, then one scalar product a point (native C backend when
    built)."""
    from ..fields.bn254 import R
    from . import native_ec

    powers = [1] * count
    for i in range(1, count):
        powers[i] = powers[i - 1] * tau % R
    g1 = g1_generator()
    if native_ec.available():
        jac = native_ec.scalar_mul_many(g1.to_affine(), powers)
    else:
        jac = [g1.scalar_mul(p) for p in powers]
    return batch_to_affine(jac)


# -- G2 convenience ---------------------------------------------------------


def g2_generator() -> Jacobian:
    return Jacobian(Fq2(*G2_X), Fq2(*G2_Y), Fq2.one())


def g2_affine_generator() -> Affine:
    return Affine(Fq2(*G2_X), Fq2(*G2_Y))


TWIST_B = Fq2(B_COEFF, 0) * Fq2(9, 1).inverse()  # b' = 3/(9+u)


def g2_is_on_curve(p: Affine) -> bool:
    if p.infinity:
        return True
    return p.y.square() == p.x.square() * p.x + TWIST_B


# -- host MSM (small sizes / oracle) ---------------------------------------


def msm_host(points: list[Affine], scalars: list[int], window_bits: int = 8) -> Jacobian:
    """Windowed Pippenger over affine bases; exact oracle for the device MSM.

    Counterpart of `VariableBaseMSM::msm_unchecked`
    (`quill-zkvm/pcs/src/kzg.rs:72`).  Scalars are canonical ints mod r;
    zero-padding / length mismatch follows arkworks: iterate over the shorter
    of the two sequences.
    """
    n = min(len(points), len(scalars))
    if n == 0:
        return Jacobian.identity(Fq(1))
    if isinstance(points[0].x, Fq):
        from . import native_ec

        if native_ec.available():
            return native_ec.msm(points[:n], scalars[:n])
    c = window_bits
    num_windows = (254 + c - 1) // c
    window_sums = []
    for w in range(num_windows):
        shift = w * c
        buckets: dict[int, Jacobian] = {}
        for i in range(n):
            digit = (int(scalars[i]) >> shift) & ((1 << c) - 1)
            if digit == 0 or points[i].infinity:
                continue
            if digit in buckets:
                buckets[digit] = buckets[digit].add_affine(points[i])
            else:
                buckets[digit] = Jacobian(points[i].x, points[i].y, _one_like(points[i].x))
        # triangle sum: sum_b b * bucket[b]
        running = Jacobian.identity(Fq(1))
        total = Jacobian.identity(Fq(1))
        for b in range(1 << c, 0, -1):
            if b in buckets:
                running = running.add(buckets[b])
            total = total.add(running)
        window_sums.append(total)
    # combine: sum_w 2^(cw) * window_sums[w]
    result = Jacobian.identity(Fq(1))
    for w in range(num_windows - 1, -1, -1):
        for _ in range(c):
            result = result.double()
        result = result.add(window_sums[w])
    return result
