"""Host-side BN254 extension-field tower: Fq2 -> Fq6 -> Fq12.

Used only on the verifier / setup path (pairings, G2 arithmetic), which is
O(#openings) work per proof -- the arkworks counterpart is `ark_bn254`'s
tower consumed through `E::pairing` at `quill-zkvm/pcs/src/kzg.rs:104-105`.

Representation: plain Python ints / tuples, immutable value classes.
  Fq2  = Fq[u]  / (u^2 + 1)
  Fq6  = Fq2[v] / (v^3 - xi),  xi = 9 + u
  Fq12 = Fq6[w] / (w^2 - v)
"""

from __future__ import annotations

from ..fields.bn254 import P
from ..fields.scalar import inv


class Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    @staticmethod
    def zero() -> "Fq2":
        return Fq2(0, 0)

    @staticmethod
    def one() -> "Fq2":
        return Fq2(1, 0)

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, other) -> bool:
        return self.c0 == other.c0 and self.c1 == other.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o: "Fq2") -> "Fq2":
        # (a0 + a1 u)(b0 + b1 u), u^2 = -1  (Karatsuba)
        v0 = self.c0 * o.c0
        v1 = self.c1 * o.c1
        c0 = v0 - v1
        c1 = (self.c0 + self.c1) * (o.c0 + o.c1) - v0 - v1
        return Fq2(c0, c1)

    def mul_scalar(self, k: int) -> "Fq2":
        return Fq2(self.c0 * k, self.c1 * k)

    def square(self) -> "Fq2":
        # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        t = self.c0 * self.c1
        return Fq2((self.c0 + self.c1) * (self.c0 - self.c1), t + t)

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def inverse(self) -> "Fq2":
        # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % P
        n_inv = inv(norm, P)
        return Fq2(self.c0 * n_inv, -self.c1 * n_inv)

    def frobenius(self) -> "Fq2":
        """x -> x^p (conjugation in Fq2)."""
        return self.conjugate()

    def pow(self, e: int) -> "Fq2":
        result = Fq2.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def __repr__(self):
        return f"Fq2({self.c0}, {self.c1})"


XI = Fq2(9, 1)  # Fq6 non-residue


def _mul_by_xi(a: Fq2) -> Fq2:
    # (9 + u) * (c0 + c1 u) = (9 c0 - c1) + (9 c1 + c0) u
    return Fq2(9 * a.c0 - a.c1, 9 * a.c1 + a.c0)


class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero() -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one() -> "Fq6":
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o) -> bool:
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fq6") -> "Fq6":
        # Toom-Cook-ish schoolbook with xi reductions (v^3 = xi)
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        v0 = a0 * b0
        v1 = a1 * b1
        v2 = a2 * b2
        c0 = v0 + _mul_by_xi((a1 + a2) * (b1 + b2) - v1 - v2)
        c1 = (a0 + a1) * (b0 + b1) - v0 - v1 + _mul_by_xi(v2)
        c2 = (a0 + a2) * (b0 + b2) - v0 - v2 + v1
        return Fq6(c0, c1, c2)

    def square(self) -> "Fq6":
        return self * self

    def mul_by_v(self) -> "Fq6":
        """Multiply by v (the cubic generator): (c0,c1,c2) -> (xi*c2, c0, c1)."""
        return Fq6(_mul_by_xi(self.c2), self.c0, self.c1)

    def mul_fq2(self, k: Fq2) -> "Fq6":
        return Fq6(self.c0 * k, self.c1 * k, self.c2 * k)

    def inverse(self) -> "Fq6":
        a, b, c = self.c0, self.c1, self.c2
        t0 = a.square() - _mul_by_xi(b * c)
        t1 = _mul_by_xi(c.square()) - a * b
        t2 = b.square() - a * c
        denom = a * t0 + _mul_by_xi(c * t1 + b * t2)
        d_inv = denom.inverse()
        return Fq6(t0 * d_inv, t1 * d_inv, t2 * d_inv)


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one() -> "Fq12":
        return Fq12(Fq6.one(), Fq6.zero())

    def __eq__(self, o) -> bool:
        return self.c0 == o.c0 and self.c1 == o.c1

    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq12":
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o: "Fq12") -> "Fq12":
        # (a0 + a1 w)(b0 + b1 w), w^2 = v
        v0 = self.c0 * o.c0
        v1 = self.c1 * o.c1
        c0 = v0 + v1.mul_by_v()
        c1 = (self.c0 + self.c1) * (o.c0 + o.c1) - v0 - v1
        return Fq12(c0, c1)

    def square(self) -> "Fq12":
        # (a0 + a1 w)^2 = (a0^2 + v a1^2) + 2 a0 a1 w, via Karatsuba-like trick
        v0 = self.c0 * self.c1
        t = (self.c0 + self.c1) * (self.c0 + self.c1.mul_by_v())
        c0 = t - v0 - v0.mul_by_v()
        c1 = v0 + v0
        return Fq12(c0, c1)

    def conjugate(self) -> "Fq12":
        """w -> -w; equals x^(p^6), the inverse for unitary (cyclotomic) elements."""
        return Fq12(self.c0, -self.c1)

    def inverse(self) -> "Fq12":
        t = (self.c0.square() - self.c1.square().mul_by_v()).inverse()
        return Fq12(self.c0 * t, -(self.c1 * t))

    def pow(self, e: int) -> "Fq12":
        result = Fq12.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def frobenius(self, power: int = 1) -> "Fq12":
        out = self
        for _ in range(power):
            out = _frobenius_once(out)
        return out


# Frobenius coefficients: gamma_1[i] = xi^(i*(p-1)/6) in Fq2, i = 1..5
def _compute_frob_coeffs():
    e = (P - 1) // 6
    return [XI.pow(e * i) for i in range(6)]


_FROB_GAMMA1 = _compute_frob_coeffs()


def _frobenius_once(x: Fq12) -> Fq12:
    """x -> x^p on Fq12 via coefficient-wise Fq2 Frobenius + gamma twists.

    With Fq12 = Fq2[w]/(w^6 - xi) flattened (c0 = a0 + a2 v + a4 v^2,
    c1 = a1 + a3 v + a5 v^2 in w-degree order), phi(sum a_i w^i) =
    sum conj(a_i) gamma_1^i w^i.
    """
    g = _FROB_GAMMA1
    a0 = x.c0.c0.conjugate()
    a1 = x.c1.c0.conjugate() * g[1]
    a2 = x.c0.c1.conjugate() * g[2]
    a3 = x.c1.c1.conjugate() * g[3]
    a4 = x.c0.c2.conjugate() * g[4]
    a5 = x.c1.c2.conjugate() * g[5]
    return Fq12(Fq6(a0, a2, a4), Fq6(a1, a3, a5))
