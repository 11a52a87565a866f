"""Virtual-polynomial expressions and the polynomial store.

Counterpart of `quill-zkvm/hyperplonk/src/utils/virtual_polynomial.rs`:
an arena of multilinear polynomials (dense 2^n evaluation tables, engine
resident) plus arithmetic-circuit expression trees over them.

TPU-first design difference: the reference *interprets* expression trees per
point with symbolic univariate arithmetic inside the sumcheck inner loop
(`virtual_polynomial.rs:286-331`); here an expression is compiled once per
(structure, size) into a fused XLA program by the engine, and round messages
are produced in evaluation form (values at t = 0..deg) and interpolated on the
host -- mathematically identical, serialization identical (trailing zeros of
the coefficient form are stripped).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.bn254 import R


class Expr:
    """Base class for virtual polynomial expressions (`VirtualPolyExpr`,
    `virtual_polynomial.rs:9-18`)."""

    def __add__(self, other: "Expr") -> "Expr":
        return Add(self, _coerce(other))

    def __mul__(self, other: "Expr") -> "Expr":
        return Mul(self, _coerce(other))

    def __sub__(self, other: "Expr") -> "Expr":
        # matches reference Sub: self + (-1) * rhs (`virtual_polynomial.rs:67-77`)
        return Add(self, Mul(Const(R - 1), _coerce(other)))

    # -- analysis ----------------------------------------------------------

    def evaluate(self, g_evals) -> int:
        """Evaluate at a point given input-poly values (host ints mod r);
        `virtual_polynomial.rs:22-37`."""
        raise NotImplementedError

    def degree(self) -> int:
        """Structural degree bound when every input is degree-1."""
        raise NotImplementedError

    def used_inputs(self) -> set[int]:
        raise NotImplementedError

    def key(self):
        """Hashable structural key with constants slotted out; returns
        (structure, consts) where structure is hashable and consts is the
        list of constant values in traversal order."""
        consts: list[int] = []
        structure = self._key(consts)
        return structure, consts

    def _key(self, consts: list[int]):
        raise NotImplementedError


def _coerce(x) -> Expr:
    if isinstance(x, Expr):
        return x
    return Const(int(x) % R)


@dataclass(frozen=True)
class Input(Expr):
    index: int

    def evaluate(self, g_evals):
        return g_evals[self.index] % R

    def degree(self):
        return 1

    def used_inputs(self):
        return {self.index}

    def _key(self, consts):
        return ("in", self.index)

    def __str__(self):
        return f"g{self.index}"


@dataclass(frozen=True)
class Const(Expr):
    value: int

    def evaluate(self, g_evals):
        return self.value % R

    def degree(self):
        return 0

    def used_inputs(self):
        return set()

    def _key(self, consts):
        consts.append(self.value % R)
        return ("c",)

    def __str__(self):
        return str(self.value)


@dataclass(frozen=True)
class Add(Expr):
    left: Expr
    right: Expr

    def evaluate(self, g_evals):
        return (self.left.evaluate(g_evals) + self.right.evaluate(g_evals)) % R

    def degree(self):
        return max(self.left.degree(), self.right.degree())

    def used_inputs(self):
        return self.left.used_inputs() | self.right.used_inputs()

    def _key(self, consts):
        return ("+", self.left._key(consts), self.right._key(consts))

    def __str__(self):
        return f"({self.left} + {self.right})"


@dataclass(frozen=True)
class Mul(Expr):
    left: Expr
    right: Expr

    def evaluate(self, g_evals):
        return (self.left.evaluate(g_evals) * self.right.evaluate(g_evals)) % R

    def degree(self):
        return self.left.degree() + self.right.degree()

    def used_inputs(self):
        return self.left.used_inputs() | self.right.used_inputs()

    def _key(self, consts):
        return ("*", self.left._key(consts), self.right._key(consts))

    def __str__(self):
        return f"({self.left} * {self.right})"


@dataclass(frozen=True)
class InputRef:
    """`VirtualPolynomialInputRef` (`virtual_polynomial.rs:105-120`)."""

    index: int

    def to_expr(self) -> Expr:
        return Input(self.index)


@dataclass(frozen=True)
class VirtualRef:
    """`VirtualPolynomialRef` (`virtual_polynomial.rs:122-125`)."""

    index: int


class Store:
    """`VirtualPolynomialStore` (`virtual_polynomial.rs:142-343`).

    Polynomials are engine vectors (device arrays for the TPU engine); the
    expression arena is host-side metadata.
    """

    def __init__(self, engine, num_vars: int):
        self.engine = engine
        self.num_vars = num_vars
        self.polynomials: list = []   # engine Vecs of length 2^num_vars
        self.virtual_polys: list[Expr] = []

    def allocate_polynomial(self, poly) -> InputRef:
        """poly: engine Vec, or a sequence of ints to be loaded."""
        vec = poly if self.engine.is_vec(poly) else self.engine.vec_from_ints(poly)
        if self.engine.vec_len(vec) != 1 << self.num_vars:
            raise ValueError("polynomial length does not match number of variables")
        idx = len(self.polynomials)
        self.polynomials.append(vec)
        return InputRef(idx)

    def new_virtual_from_input(self, g: InputRef) -> VirtualRef:
        return self.new_virtual_from_expr(Input(g.index))

    def new_virtual_from_virtual(self, v: VirtualRef) -> VirtualRef:
        return self.new_virtual_from_expr(self.virtual_polys[v.index])

    def new_virtual_from_expr(self, expr: Expr) -> VirtualRef:
        idx = len(self.virtual_polys)
        self.virtual_polys.append(expr)
        return VirtualRef(idx)

    def new_virtual_zero(self) -> VirtualRef:
        return self.new_virtual_from_expr(Const(0))

    def new_virtual_one(self) -> VirtualRef:
        return self.new_virtual_from_expr(Const(1))

    def add_in_place(self, f: VirtualRef, g: InputRef) -> None:
        self.virtual_polys[f.index] = Add(self.virtual_polys[f.index], Input(g.index))

    def add_const_in_place(self, f: VirtualRef, c: int) -> None:
        self.virtual_polys[f.index] = Add(self.virtual_polys[f.index], Const(c % R))

    def sub_in_place(self, f: VirtualRef, g: InputRef) -> None:
        self.virtual_polys[f.index] = Add(
            self.virtual_polys[f.index], Mul(Const(R - 1), Input(g.index))
        )

    def mul_in_place(self, f: VirtualRef, g: InputRef) -> None:
        self.virtual_polys[f.index] = Mul(self.virtual_polys[f.index], Input(g.index))

    def mul_const_in_place(self, f: VirtualRef, c: int) -> None:
        self.virtual_polys[f.index] = Mul(self.virtual_polys[f.index], Const(c % R))

    def evaluate_point(self, g_evals, v: VirtualRef) -> int:
        return self.virtual_polys[v.index].evaluate(list(g_evals))

    def get_expr(self, v: VirtualRef) -> Expr:
        return self.virtual_polys[v.index]

    def eval_expr_table(self, v_or_expr) -> object:
        """Engine Vec of h(g_1(x),...,g_k(x)) over the whole hypercube."""
        expr = v_or_expr if isinstance(v_or_expr, Expr) else self.get_expr(v_or_expr)
        return self.engine.eval_expr(self.polynomials, expr, 1 << self.num_vars)
