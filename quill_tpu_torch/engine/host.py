"""Host (CPU, exact big-int) execution engine.

Implements the engine contract (`engine/contract.py`) on numpy object
arrays of Python ints.  It is
(1) the exact oracle every TPU kernel is differentially tested against,
(2) the execution tail for sizes below the device threshold, and
(3) the verifier's compute backend.

Arithmetic is plain modular arithmetic mod r; results are bit-identical to the
TPU engine by construction (prime-field arithmetic is exact).
"""

from __future__ import annotations

import numpy as np

from ..ec import curve
from ..fields.bn254 import R
from ..fields.scalar import batch_inverse as _batch_inverse_list


class HostEngine:
    name = "host"

    # ---- vectors ----------------------------------------------------------

    def is_vec(self, v) -> bool:
        return isinstance(v, np.ndarray) and v.dtype == object

    def vec_from_ints(self, xs):
        arr = np.empty(len(xs), dtype=object)
        for i, x in enumerate(xs):
            arr[i] = int(x) % R
        return arr

    def vec_to_ints(self, v) -> np.ndarray:
        return v

    def vec_len(self, v) -> int:
        return len(v)

    def pad(self, v, n: int):
        if len(v) >= n:
            return v
        out = np.empty(n, dtype=object)
        out[:len(v)] = v
        out[len(v):] = 0
        return out

    def view(self, v, start: int, stop: int):
        """None: host vectors share no storage."""
        return None

    def reverse(self, v):
        return v[::-1].copy()

    def slice(self, v, start: int, stop: int):
        return v[start:stop].copy()

    def concat(self, vs):
        return np.concatenate(vs)

    # ---- elementwise field ops -------------------------------------------

    def add(self, a, b):
        return (a + b) % R

    def sub(self, a, b):
        return (a - b) % R

    def mul(self, a, b):
        return (a * b) % R

    def add_scalar(self, v, c: int):
        return (v + (c % R)) % R

    def mul_scalar(self, v, c: int):
        return (v * (c % R)) % R

    def vsum(self, v) -> int:
        return int(v.sum() % R)

    def inner(self, a, b) -> int:
        n = min(len(a), len(b))
        if n == 0:
            return 0
        return int((a[:n] * b[:n]).sum() % R)

    def batch_inverse(self, v):
        out = _batch_inverse_list([int(x) for x in v], R)
        return self.vec_from_ints(out)

    def first_nonzero(self, vecs: list, pairs: list) -> list:
        """The first non-zero index of each vector, then for each pair
        (a, b) the first i with a[i] != b[i + 1]; None where there is
        none."""
        out = [next((i for i, x in enumerate(v) if x != 0), None)
               for v in vecs]
        out += [next((i for i in range(len(a) - 1) if a[i] != b[i + 1]),
                     None) for a, b in pairs]
        return out

    # ---- multilinear ops --------------------------------------------------

    def eq_table(self, point: list[int]):
        """eq(x, point) over {0,1}^n; LSB of the index <-> point[0]
        (`quill-zkvm/hyperplonk/src/utils/eq_eval.rs:6-31`)."""
        n = len(point)
        evals = [1]
        for i in range(n - 1, -1, -1):
            r_i = point[i] % R
            one_minus = (1 - r_i) % R
            nxt = [0] * (len(evals) * 2)
            for j, e in enumerate(evals):
                nxt[2 * j] = e * one_minus % R
                nxt[2 * j + 1] = e * r_i % R
            evals = nxt
        return self.vec_from_ints(evals)

    def eval_expr(self, tables, expr, size: int):
        """Pointwise h(g_1(x),...,g_k(x)) over the hypercube."""
        return self._eval(expr, tables, size)

    def _eval(self, expr, tables, size):
        from ..piops import virtual_poly as vp

        if isinstance(expr, vp.Input):
            return tables[expr.index]
        if isinstance(expr, vp.Const):
            arr = np.empty(size, dtype=object)
            arr[:] = expr.value % R
            return arr
        if isinstance(expr, vp.Add):
            return (self._eval(expr.left, tables, size)
                    + self._eval(expr.right, tables, size)) % R
        if isinstance(expr, vp.Mul):
            return (self._eval(expr.left, tables, size)
                    * self._eval(expr.right, tables, size)) % R
        raise TypeError(f"unknown expr node {expr!r}")

    def fold(self, v, r: int):
        """Bind the LSB variable: v'[p] = v[2p] + r*(v[2p+1] - v[2p])
        (`quill-zkvm/hyperplonk/src/piops/sumcheck.rs:54-63,81-92`)."""
        lo = v[0::2]
        hi = v[1::2]
        return (lo + (r % R) * (hi - lo)) % R

    def sumcheck_messages(self, tables, expr, degree: int) -> list[int]:
        """Round-message evaluations: for t = 0..degree return
        sum_p h(g_1, ..., g_k)(t) where each g_j is the degree-1 univariate
        lo + t*(hi - lo) built from adjacent pairs (LSB binding)."""
        los = [None if t is None else t[0::2] for t in tables]
        his = [None if t is None else t[1::2] for t in tables]
        size = next((len(lo) for lo in los if lo is not None), 1)
        out = []
        for t in range(degree + 1):
            vals = [None if lo is None else (lo + t * (hi - lo)) % R
                    for lo, hi in zip(los, his)]
            h = self._eval(expr, vals, size)
            out.append(int(h.sum() % R))
        return out

    def sumcheck_begin(self, tables, expr, degree: int):
        """Round 0: the tables stay as they are."""
        return tables, self.sumcheck_messages(tables, expr, degree)

    def sumcheck_round_fused(self, tables, expr, degree: int, r_prev: int):
        """Fold + next-round messages (reference semantics, unfused)."""
        used = sorted(expr.used_inputs())
        new_tables = list(tables)
        for i in used:
            new_tables[i] = self.fold(tables[i], r_prev)
        return new_tables, self.sumcheck_messages(new_tables, expr, degree)

    # ---- univariate polynomial ops ---------------------------------------

    def poly_eval(self, coeffs, x: int) -> int:
        acc = 0
        x = x % R
        for c in reversed(list(coeffs)):
            acc = (acc * x + int(c)) % R
        return acc

    def poly_mul(self, a, b):
        """Coefficient-space product (replaces the reference's O(d^2) naive
        product, `quill-zkvm/pcs/src/ipa.rs:147-148`, on the host path):
        Kronecker substitution on big ints for small sizes, exact NTT above."""
        la, lb = len(a), len(b)
        if la == 0 or lb == 0:
            return self.vec_from_ints([])
        out_len = la + lb - 1
        if out_len > 4096:
            out = _ntt_mul_host([int(x) for x in a], [int(x) for x in b])
            return self.vec_from_ints(out[:out_len])
        nbits = 2 * 254 + (max(la, lb)).bit_length() + 1
        pa = _pack(a, nbits)
        pb = _pack(b, nbits)
        prod = pa * pb
        out = _unpack(prod, nbits, out_len)
        return self.vec_from_ints(out)

    def s_polynomial(self, p1, p2):
        """IPA S coefficients: the top half of f * rev(g) + rev(f) * g
        (`quill-zkvm/pcs/src/ipa.rs:122-157`), both zero-padded to a
        common length."""
        n = max(self.vec_len(p1), self.vec_len(p2))
        f, g = self.pad(p1, n), self.pad(p2, n)
        h = self.add(self.poly_mul(f, self.reverse(g)),
                     self.poly_mul(self.reverse(f), g))
        # h has 2n - 1 coefficients; S = h[n:]
        return self.slice(h, n, 2 * n - 1)

    def quotient_by_linear(self, coeffs, x: int):
        """Return (y, q) with y = p(x) and q = (p - y)/(X - x) by synthetic
        division (`quill-zkvm/pcs/src/kzg.rs:75-96` semantics)."""
        n = len(coeffs)
        if n == 0:
            return 0, self.vec_from_ints([])
        x = x % R
        q = [0] * (n - 1)
        acc = 0
        for i in range(n - 1, 0, -1):
            acc = (acc * x + int(coeffs[i])) % R
            q[i - 1] = acc
        y = (acc * x + int(coeffs[0])) % R
        return y, self.vec_from_ints(q)

    def quotient_many(self, jobs: list) -> list:
        return [self.quotient_by_linear(p, x) for p, x in jobs]

    # ---- curve ops --------------------------------------------------------

    def load_points(self, affines: list):
        """CRS basis handle: on host just the affine list."""
        return list(affines)

    def tau_basis(self, tau: int, count: int):
        return self.load_points(curve.g1_tau_powers(tau, count))

    def basis_slice(self, basis, n: int):
        return basis[:n]

    def msm(self, basis, scalars) -> curve.Jacobian:
        return curve.msm_host(basis, [int(s) for s in scalars])

    def msm_many(self, jobs: list) -> list:
        return [self.msm(b, s) for b, s in jobs]


def _ntt_host(vals: list[int], invert: bool) -> list[int]:
    """Iterative radix-2 NTT over Fr on Python ints (exact)."""
    from ..fields.bn254 import FR_ROOT_OF_UNITY, FR_TWO_ADICITY

    n = len(vals)
    logn = n.bit_length() - 1
    a = list(vals)
    # bit-reversal permutation
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    root = pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - logn), R)
    if invert:
        root = pow(root, R - 2, R)
    length = 2
    while length <= n:
        w_len = pow(root, n // length, R)
        for start in range(0, n, length):
            w = 1
            half = length // 2
            for k in range(start, start + half):
                u = a[k]
                v = a[k + half] * w % R
                a[k] = (u + v) % R
                a[k + half] = (u - v) % R
                w = w * w_len % R
        length <<= 1
    if invert:
        n_inv = pow(n, R - 2, R)
        a = [x * n_inv % R for x in a]
    return a


def _ntt_mul_host(a: list[int], b: list[int]) -> list[int]:
    out_len = len(a) + len(b) - 1
    n = 1
    while n < out_len:
        n <<= 1
    fa = _ntt_host(a + [0] * (n - len(a)), False)
    fb = _ntt_host(b + [0] * (n - len(b)), False)
    fc = [x * y % R for x, y in zip(fa, fb)]
    return _ntt_host(fc, True)


def _pack(coeffs, nbits: int) -> int:
    acc = 0
    for c in reversed(list(coeffs)):
        acc = (acc << nbits) | int(c)
    return acc


def _unpack(value: int, nbits: int, count: int) -> list[int]:
    mask = (1 << nbits) - 1
    out = [0] * count
    for i in range(count):
        out[i] = (value & mask) % R
        value >>= nbits
    return out
