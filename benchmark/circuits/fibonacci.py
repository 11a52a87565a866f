"""The Fibonacci transition circuit of quill-zkvm
(`hyperplonk/tests/test_basic_proof.rs:17-52`): two state cells (a, b),
each a (current, next) column pair, so four columns; every row steps
(a, b) -> (b, a + b), and row 0 holds the boundary values (a0, b0).

The seed sets (a0, b0).  Everything but `program_circuit` is plain Python
that the reference reads: the witness, the constraints in the order the
program batches them, the public columns and the copy permutation.
`program_circuit` builds the same circuit with the program's frontend; it is
the only function here that imports the program.
"""

from __future__ import annotations

import hashlib

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# columns: a.current, a.next, b.current, b.next
A_CUR, A_NEXT, B_CUR, B_NEXT = 0, 1, 2, 3


class Statement:
    """One Fibonacci statement: 2^log2_rows rows from (a0, b0)."""

    columns = 4
    constraint_degree = 2      # a boundary selector times a linear term

    def __init__(self, log2_rows: int, a0: int, b0: int):
        self.rows = 1 << log2_rows
        self.a0, self.b0 = a0 % R, b0 % R

    @classmethod
    def from_seed(cls, log2_rows: int, seed: int) -> "Statement":
        h = hashlib.sha256(f"fibonacci boundary {seed}".encode()).digest()
        return cls(log2_rows, int.from_bytes(h[:16], "little"),
                   int.from_bytes(h[16:], "little"))

    def witness(self) -> list[list[int]]:
        rows = self.rows
        a_cur, a_next = [0] * rows, [0] * rows
        b_cur, b_next = [0] * rows, [0] * rows
        a, b = self.a0, self.b0
        for row in range(rows):
            c = (a + b) % R
            a_cur[row], a_next[row], b_cur[row], b_next[row] = a, b, b, c
            a, b = b, c
        return [a_cur, a_next, b_cur, b_next]

    def public_columns(self) -> list[list[int]]:
        """One boundary selector a boundary constraint: 1 at row 0."""
        sel = [0] * self.rows
        sel[0] = 1
        return [sel, list(sel)]

    def constraints(self, e: list[int]) -> list[int]:
        """The zero-check expressions at column values e (the four witness
        columns, then the two selectors): the transition constraints, then
        each boundary constraint times its selector."""
        return [(e[B_NEXT] - e[A_CUR] - e[B_CUR]) % R,
                (e[A_NEXT] - e[B_CUR]) % R,
                e[4] * (e[A_CUR] - self.a0) % R,
                e[5] * (e[B_CUR] - self.b0) % R]

    def permutation(self) -> tuple[list[int], list[int]]:
        """Copy constraints next[row] = current[row + 1] of each state cell
        as swaps of cell indices (cell = column x rows + row), shifted by 1
        so that no index is 0."""
        rows = self.rows
        n = rows * self.columns
        perm = list(range(n))
        for cur, nxt in ((A_CUR, A_NEXT), (B_CUR, B_NEXT)):
            for row in range(rows - 1):
                frm, to = nxt * rows + row, cur * rows + row + 1
                perm[frm], perm[to] = to, frm
        return list(range(1, n + 1)), [x + 1 for x in perm]

    def program_circuit(self):
        """The same circuit built by the program's transition-circuit
        frontend, for `HyperPlonk.preprocess`."""
        from quill_tpu_torch.frontend.transition_circuit import \
            TransitionCircuit
        from quill_tpu_torch.piops.virtual_poly import Const

        circuit = TransitionCircuit.new(self.rows)
        a = circuit.allocate_state_cell()
        b = circuit.allocate_state_cell()
        circuit.enforce_boundary_constraint(
            0, a.current.to_expr() - Const(self.a0))
        circuit.enforce_boundary_constraint(
            0, b.current.to_expr() - Const(self.b0))
        circuit.enforce_constraint(
            b.next.to_expr() - (a.current.to_expr() + b.current.to_expr()))
        circuit.enforce_constraint(a.next.to_expr() - b.current.to_expr())
        return circuit
