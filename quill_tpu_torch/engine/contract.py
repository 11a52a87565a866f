"""The engine contract: every method the protocol layers call on an engine.

`piops/`, `pcs/`, `proof/`, `frontend/` and `transcript/` know of the
device only what this class lists.  `engine/host.py: HostEngine` (exact
big-int vectors on the CPU) and `engine/device.py: TorchEngine` (device
vectors on the card, host vectors below its device size) both define every
method, with these parameter names.  A vector is whatever the engine's
`vec_from_ints` returns; a basis whatever its `load_points` or
`tau_basis` returns.
"""

from __future__ import annotations

from typing import Protocol


class Engine(Protocol):
    # -- vectors --------------------------------------------------------------

    def is_vec(self, v) -> bool:
        """Whether `v` is one of this engine's vectors."""

    def vec_from_ints(self, xs):
        """A vector of the field elements `xs` (reduced mod r)."""

    def vec_to_ints(self, v):
        """The elements of `v` as canonical integers, indexable."""

    def vec_len(self, v) -> int:
        """The number of elements of `v`."""

    def pad(self, v, n: int):
        """`v` zero-padded to `n` elements (unchanged where it is longer)."""

    def view(self, v, start: int, stop: int):
        """Elements [start, stop) of `v` sharing its storage, or None."""

    def reverse(self, v):
        """`v` in reverse order."""

    def slice(self, v, start: int, stop: int):
        """Elements [start, stop) of `v` as a new vector."""

    def concat(self, vs):
        """The vectors `vs` one after another."""

    # -- elementwise and reductions ---------------------------------------------

    def add(self, a, b):
        """a + b elementwise."""

    def sub(self, a, b):
        """a - b elementwise."""

    def mul(self, a, b):
        """a * b elementwise."""

    def add_scalar(self, v, c: int):
        """v + c elementwise."""

    def mul_scalar(self, v, c: int):
        """v * c elementwise."""

    def vsum(self, v) -> int:
        """The sum of the elements of `v`."""

    def inner(self, a, b) -> int:
        """sum a[i] b[i] over the shorter length."""

    def batch_inverse(self, v):
        """1 / v elementwise."""

    def first_nonzero(self, vecs: list, pairs: list) -> list:
        """The first non-zero index of each vector of `vecs`, then for each
        pair (a, b) of `pairs` the first i with a[i] != b[i + 1]; None
        where there is none."""

    # -- multilinear ------------------------------------------------------------

    def eq_table(self, point: list):
        """eq(x, point) over the hypercube, the LSB of x bound to point[0]."""

    def eval_expr(self, tables, expr, size: int):
        """The expression `expr` of the tables, pointwise over `size` rows."""

    def fold(self, v, r: int):
        """`v` with its LSB variable bound to r."""

    def sumcheck_messages(self, tables, expr, degree: int) -> list:
        """A sumcheck round's sums of `expr` at t = 0..degree."""

    def sumcheck_begin(self, tables, expr, degree: int):
        """Round 0: (the tables the rounds go on with, its messages)."""

    def sumcheck_round_fused(self, tables, expr, degree: int, r_prev: int):
        """(the tables folded at r_prev, the next round's messages)."""

    # -- univariate -------------------------------------------------------------

    def poly_eval(self, coeffs, x: int) -> int:
        """The polynomial of coefficients `coeffs` at x."""

    def poly_mul(self, a, b):
        """The product of two coefficient vectors."""

    def s_polynomial(self, p1, p2):
        """The IPA's S: the top half of p1 * rev(p2) + rev(p1) * p2."""

    def quotient_by_linear(self, coeffs, x: int):
        """(p(x), (p - p(x)) / (X - x)) for the coefficients of p."""

    def quotient_many(self, jobs: list) -> list:
        """`quotient_by_linear` of each (coeffs, x) of `jobs`, in order."""

    # -- curve ------------------------------------------------------------------

    def load_points(self, affines: list):
        """A basis of the affine G1 points `affines`."""

    def tau_basis(self, tau: int, count: int):
        """The basis [G, tau G, ..., tau^(count - 1) G] of G1's generator."""

    def basis_slice(self, basis, n: int):
        """The first `n` points of `basis`."""

    def msm(self, basis, scalars):
        """sum scalars[i] basis[i] as a Jacobian point."""

    def msm_many(self, jobs: list) -> list:
        """`msm` of each (basis, scalars) of `jobs`, in order."""
