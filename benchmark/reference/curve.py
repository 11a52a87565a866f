"""BN254 G1 over plain Python integers: the group arithmetic the reference
verifier needs.

The curve is y^2 = x^3 + 3 over the base field of modulus P, with generator
(1, 2); the proof system works over the scalar field of modulus R.  These are
the public BN254 (alt_bn128) parameters.  Points are Jacobian triples
(X, Y, Z) of integers mod P, with Z = 0 for the point at infinity.
"""

from __future__ import annotations

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
B = 3

INFINITY = (1, 1, 0)
G = (1, 2, 1)


def is_infinity(p) -> bool:
    return p[2] % P == 0


def double(p):
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return INFINITY
    a = X * X % P
    b = Y * Y % P
    c = b * b % P
    d = 2 * ((X + b) * (X + b) - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * Y * Z % P
    return (x3, y3, z3)


def add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    z1z1 = Z1 * Z1 % P
    z2z2 = Z2 * Z2 % P
    u1 = X1 * z2z2 % P
    u2 = X2 * z1z1 % P
    s1 = Y1 * Z2 * z2z2 % P
    s2 = Y2 * Z1 * z1z1 % P
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    if h == 0:
        return double(p) if r == 0 else INFINITY
    hh = h * h % P
    hhh = h * hh % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    y3 = (r * (v - x3) - s1 * hhh) % P
    z3 = Z1 * Z2 * h % P
    return (x3, y3, z3)


def neg(p):
    return (p[0], (-p[1]) % P, p[2])


def mul(p, k: int):
    """k p by double-and-add over the bits of k mod R."""
    k %= R
    acc = INFINITY
    for bit in bin(k)[2:] if k else "":
        acc = double(acc)
        if bit == "1":
            acc = add(acc, p)
    return acc


def to_affine(p):
    """(x, y), or None for the point at infinity."""
    if p[2] % P == 0:
        return None
    zi = pow(p[2], P - 2, P)
    zi2 = zi * zi % P
    return (p[0] * zi2 % P, p[1] * zi2 * zi % P)


def equal(p, q) -> bool:
    return to_affine(p) == to_affine(q)


def on_curve(x: int, y: int) -> bool:
    return (y * y - x * x * x - B) % P == 0
