"""BN254 optimal ate pairing (host-side, verifier/setup only).

Counterpart of `E::pairing` in the reference KZG verifier
(`quill-zkvm/pcs/src/kzg.rs:98-108`).  The verifier does O(#openings)
pairings per proof, so a clear host implementation is the right cost model;
the Miller loop works on points embedded into E(Fq12) (simple, correct), and
`multi_pairing` shares one final exponentiation across all pairs.
"""

from __future__ import annotations

from ..fields.bn254 import ATE_LOOP_COUNT, P, R
from .curve import Affine, Fq
from .tower import Fq2, Fq6, Fq12

# Tower: Fq12 = Fq6[w]/(w^2 - v), Fq6 = Fq2[v]/(v^3 - xi), so w^6 = xi.
# The twist is D-type with b' = b/xi, hence untwisting is
#   psi(x', y') = (x' * w^2, y' * w^3) = (x' * v,  y' * v * w)
# (check: y'^2 = x'^3 + b/xi  =>  (y' w^3)^2 = (x' w^2)^3 + b).


def _fq2_to_fq12(a: Fq2) -> Fq12:
    return Fq12(Fq6(a, Fq2.zero(), Fq2.zero()), Fq6.zero())


def _fq_to_fq12(a: int) -> Fq12:
    return _fq2_to_fq12(Fq2(a, 0))


def embed_g2(q: Affine) -> tuple[Fq12, Fq12]:
    """Untwist a G2 point (coords in Fq2) into E(Fq12) coordinates."""
    x12 = Fq12(Fq6(Fq2.zero(), q.x, Fq2.zero()), Fq6.zero())       # x' * v
    y12 = Fq12(Fq6.zero(), Fq6(Fq2.zero(), q.y, Fq2.zero()))       # y' * v * w
    return x12, y12


def _is_on_e_fq12(x: Fq12, y: Fq12) -> bool:
    three = _fq_to_fq12(3)
    return y.square() == x.square() * x + three


def _line_and_step(tx: Fq12, ty: Fq12, qx: Fq12, qy: Fq12, px: Fq12, py: Fq12,
                   doubling: bool):
    """Evaluate the line through T and Q (or tangent at T when doubling) at P
    and return (line_value, new_T)."""
    if doubling:
        # tangent slope: 3 x^2 / 2 y
        num = tx.square() * _fq_to_fq12(3)
        den = ty * _fq_to_fq12(2)
    else:
        num = qy - ty
        den = qx - tx
        if den == _ZERO12:
            if num == _ZERO12:
                # same point: fall back to doubling
                return _line_and_step(tx, ty, tx, ty, px, py, doubling=True)
            # vertical line: l(P) = px - tx, new T = identity; with the ate
            # loop counts used here this never occurs for valid inputs.
            return (px - tx), None
    lam = num * den.inverse()
    line = lam * (px - tx) - (py - ty)
    x3 = lam.square() - tx - qx
    y3 = lam * (tx - x3) - ty
    return line, (x3, y3)


_ZERO12 = Fq12(Fq6.zero(), Fq6.zero())


def _frob_g2_fq12(x: Fq12, y: Fq12, power: int) -> tuple[Fq12, Fq12]:
    return x.frobenius(power), y.frobenius(power)


def miller_loop(p: Affine, q: Affine) -> Fq12:
    """Optimal ate Miller loop f_{6x+2, Q}(P) including the two Frobenius
    correction lines."""
    if p.infinity or q.infinity:
        return Fq12.one()
    px = _fq_to_fq12(p.x.v if isinstance(p.x, Fq) else p.x)
    py = _fq_to_fq12(p.y.v if isinstance(p.y, Fq) else p.y)
    qx, qy = embed_g2(q)
    assert _is_on_e_fq12(qx, qy), "G2 point failed to untwist onto E(Fq12)"

    f = Fq12.one()
    tx, ty = qx, qy
    bits = bin(ATE_LOOP_COUNT)[2:]
    for bit in bits[1:]:
        line, t = _line_and_step(tx, ty, tx, ty, px, py, doubling=True)
        f = f.square() * line
        tx, ty = t
        if bit == "1":
            line, t = _line_and_step(tx, ty, qx, qy, px, py, doubling=False)
            f = f * line
            tx, ty = t

    # Frobenius correction steps: Q1 = pi_p(Q), Q2 = -pi_{p^2}(Q)
    q1x, q1y = _frob_g2_fq12(qx, qy, 1)
    q2x, q2y = _frob_g2_fq12(qx, qy, 2)
    line, t = _line_and_step(tx, ty, q1x, q1y, px, py, doubling=False)
    f = f * line
    tx, ty = t
    line, _ = _line_and_step(tx, ty, q2x, _ZERO12 - q2y, px, py, doubling=False)
    f = f * line
    return f


_HARD_EXP = (P**4 - P**2 + 1) // R


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((p^12 - 1)/r): easy part (p^6-1)(p^2+1), then hard part
    (p^4 - p^2 + 1)/r by generic square-and-multiply (exact; an x-chain
    optimized variant can replace it behind the same interface)."""
    # easy part
    f1 = f.conjugate() * f.inverse()          # f^(p^6 - 1)
    f2 = f1.frobenius(2) * f1                 # ^(p^2 + 1)
    # hard part
    return f2.pow(_HARD_EXP)


def pairing(p: Affine, q: Affine) -> Fq12:
    return final_exponentiation(miller_loop(p, q))


def multi_pairing(pairs: list[tuple[Affine, Affine]]) -> Fq12:
    """prod_i e(P_i, Q_i) with one shared final exponentiation."""
    f = Fq12.one()
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f)


def pairing_check(pairs: list[tuple[Affine, Affine]]) -> bool:
    """True iff prod_i e(P_i, Q_i) == 1."""
    return multi_pairing(pairs) == Fq12.one()
