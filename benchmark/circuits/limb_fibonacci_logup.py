"""A statement of two traces joined by cross-table lookups: Fibonacci over
unsigned integers of two k-bit limbs, each new limb range-checked by Logup
(eprint 2022/1530) into a 2^k-row range table, as SP1's byte chip checks
its 16-bit limbs (`U16Range`).

Trace 0 (2^log2_rows rows) holds four state cells, the low and high limbs
of a and b, each a (current, next) column pair: columns a_lo, a_lo', a_hi,
a_hi', b_lo, b_lo', b_hi, b_hi'.  Every row steps (a, b) -> (b, a + b mod
2^2k): a' = b limb by limb, and the new limbs b_lo', b_hi' satisfy
d0 (d0 - 2^k) = 0 with d0 = a_lo + b_lo - b_lo', and d1 (d1 - 2^k) = 0
with d1 = a_hi + b_hi + d0 / 2^k - b_hi'.  With every limb in [0, 2^k)
those are the sum's limbs and carries.  Row 0 holds the boundary limbs.
Trace 1 (2^k rows) is the table: one state cell v with v' = v + 1 and
v = 0 at row 0, so v runs over [0, 2^k).  Two lookups, one a new limb's
column, put b_lo' and b_hi' among v's values; the permutation carries
them into the next row's b, so every limb is in range.

Everything but `program_circuit` and `program_lookups` is plain Python
that the reference reads; those two build the same with the program.
"""

from __future__ import annotations

import hashlib

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

A_LO, A_LO_N, A_HI, A_HI_N, B_LO, B_LO_N, B_HI, B_HI_N = range(8)
V, V_N = 0, 1


def copy_permutation(rows: int, columns: int, cells) -> tuple[list, list]:
    """Copy constraints next[row] = current[row + 1] of each state cell
    (current, next) as swaps of cell indices (column x rows + row), shifted
    by 1 so that no index is 0: the program's transition frontend's."""
    n = rows * columns
    perm = list(range(n))
    for cur, nxt in cells:
        for row in range(rows - 1):
            frm, to = nxt * rows + row, cur * rows + row + 1
            perm[frm], perm[to] = to, frm
    return list(range(1, n + 1)), [x + 1 for x in perm]


class LimbTrace:
    """Fibonacci in two k-bit limbs from (a0, b0)."""

    columns = 8
    constraint_degree = 2      # a carry's product; a selector times a limb

    def __init__(self, log2_rows: int, limb_bits: int, a0: int, b0: int):
        self.rows = 1 << log2_rows
        self.base = 1 << limb_bits
        self.a0, self.b0 = a0, b0

    def witness(self) -> list[list[int]]:
        base, top = self.base, self.base * self.base
        cols = [[0] * self.rows for _ in range(self.columns)]
        a, b = self.a0, self.b0
        for row in range(self.rows):
            c = (a + b) % top
            for col, value in ((A_LO, a % base), (A_HI, a // base),
                               (A_LO_N, b % base), (A_HI_N, b // base),
                               (B_LO, b % base), (B_HI, b // base),
                               (B_LO_N, c % base), (B_HI_N, c // base)):
                cols[col][row] = value
            a, b = b, c
        return cols

    def boundary(self) -> list[tuple[int, int]]:
        """(column, value at row 0) of each boundary constraint."""
        base = self.base
        return [(A_LO, self.a0 % base), (A_HI, self.a0 // base),
                (B_LO, self.b0 % base), (B_HI, self.b0 // base)]

    def public_columns(self) -> list[list[int]]:
        sel = [0] * self.rows
        sel[0] = 1
        return [list(sel) for _ in self.boundary()]

    def constraints(self, e: list[int]) -> list[int]:
        inv_base = pow(self.base, R - 2, R)
        d0 = (e[A_LO] + e[B_LO] - e[B_LO_N]) % R
        d1 = (e[A_HI] + e[B_HI] + d0 * inv_base - e[B_HI_N]) % R
        out = [(e[A_LO_N] - e[B_LO]) % R, (e[A_HI_N] - e[B_HI]) % R,
               d0 * (d0 - self.base) % R, d1 * (d1 - self.base) % R]
        for i, (col, value) in enumerate(self.boundary()):
            out.append(e[self.columns + i] * (e[col] - value) % R)
        return out

    def permutation(self) -> tuple[list[int], list[int]]:
        return copy_permutation(self.rows, self.columns,
                                ((A_LO, A_LO_N), (A_HI, A_HI_N),
                                 (B_LO, B_LO_N), (B_HI, B_HI_N)))

    def program_circuit(self):
        from quill_tpu_torch.frontend.transition_circuit import \
            TransitionCircuit
        from quill_tpu_torch.piops.virtual_poly import Const

        circuit = TransitionCircuit.new(self.rows)
        a_lo, a_hi = (circuit.allocate_state_cell() for _ in range(2))
        b_lo, b_hi = (circuit.allocate_state_cell() for _ in range(2))
        inv_base = pow(self.base, R - 2, R)
        d0 = (a_lo.current.to_expr() + b_lo.current.to_expr()
              - b_lo.next.to_expr())
        d1 = (a_hi.current.to_expr() + b_hi.current.to_expr()
              + Const(inv_base) * d0 - b_hi.next.to_expr())
        circuit.enforce_constraint(a_lo.next.to_expr() - b_lo.current.to_expr())
        circuit.enforce_constraint(a_hi.next.to_expr() - b_hi.current.to_expr())
        circuit.enforce_constraint(d0 * (d0 - Const(self.base)))
        circuit.enforce_constraint(d1 * (d1 - Const(self.base)))
        cells = {A_LO: a_lo, A_HI: a_hi, B_LO: b_lo, B_HI: b_hi}
        for col, value in self.boundary():
            circuit.enforce_boundary_constraint(
                0, cells[col].current.to_expr() - Const(value))
        return circuit


class RangeTrace:
    """The table: v = 0, 1, ..., 2^k - 1."""

    columns = 2
    constraint_degree = 2

    def __init__(self, limb_bits: int):
        self.rows = 1 << limb_bits

    def witness(self) -> list[list[int]]:
        return [list(range(self.rows)), list(range(1, self.rows + 1))]

    def public_columns(self) -> list[list[int]]:
        return [[1] + [0] * (self.rows - 1)]

    def constraints(self, e: list[int]) -> list[int]:
        return [(e[V_N] - e[V] - 1) % R, e[2] * e[V] % R]

    def permutation(self) -> tuple[list[int], list[int]]:
        return copy_permutation(self.rows, self.columns, ((V, V_N),))

    def program_circuit(self):
        from quill_tpu_torch.frontend.transition_circuit import \
            TransitionCircuit
        from quill_tpu_torch.piops.virtual_poly import Const

        circuit = TransitionCircuit.new(self.rows)
        v = circuit.allocate_state_cell()
        circuit.enforce_constraint(
            v.next.to_expr() - v.current.to_expr() - Const(1))
        circuit.enforce_boundary_constraint(0, v.current.to_expr())
        return circuit


class Statement:
    """2^log2_rows Fibonacci steps over 2 x limb_bits bits, and the range
    table of limb_bits."""

    def __init__(self, log2_rows: int, limb_bits: int, a0: int, b0: int):
        top = 1 << (2 * limb_bits)
        self._traces = [LimbTrace(log2_rows, limb_bits, a0 % top, b0 % top),
                        RangeTrace(limb_bits)]

    @classmethod
    def from_seed(cls, log2_rows: int, seed: int,
                  limb_bits: int = 16) -> "Statement":
        h = hashlib.sha256(f"limb fibonacci boundary {seed}".encode()).digest()
        return cls(log2_rows, limb_bits, int.from_bytes(h[:16], "little"),
                   int.from_bytes(h[16:], "little"))

    def traces(self) -> list:
        return self._traces

    def lookups(self) -> list[tuple]:
        """Each new limb's column among the table's v."""
        return [(0, [B_LO_N], 1, [V]), (0, [B_HI_N], 1, [V])]

    def program_lookups(self) -> list:
        from quill_tpu_torch.proof.hyperplonk import CrossTableLookup

        return [CrossTableLookup(src_trace=s, src_cols=sc, dst_trace=d,
                                 dst_cols=dc)
                for s, sc, d, dc in self.lookups()]
