"""Transition-circuit frontend: row-transition circuits with state cells.

Counterpart of `quill-zkvm/hyperplonk/src/frontend/transition_circuit.rs`:
witness cells are columns; a state cell is a (current, next) column pair whose
continuity next[i] = current[i+1] is enforced through the permutation
(cell-swap pairs, with a +1 index shift so the id/perm mappings never contain
zero); boundary constraints become one-hot selector public columns multiplied
into the constraint.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fields.bn254 import R
from ..piops.virtual_poly import Expr, Input, Mul


@dataclass(frozen=True)
class Target:
    """`TransitionCircuitTarget` (`transition_circuit.rs:5-15`)."""

    col: int

    def to_expr(self) -> Expr:
        return Input(self.col)


@dataclass(frozen=True)
class StateCell:
    """`StateCell { current, next }` (`transition_circuit.rs:17-21`)."""

    current: Target
    next: Target


@dataclass
class TransitionCircuit:
    """`TransitionCircuit` (`transition_circuit.rs:26-76`)."""

    _num_rows: int
    num_columns: int = 0
    state_cells: list[StateCell] = field(default_factory=list)
    recurring_constraints: list[Expr] = field(default_factory=list)
    boundary_constraints: list[tuple[int, Expr]] = field(default_factory=list)

    @staticmethod
    def new(num_rows: int) -> "TransitionCircuit":
        return TransitionCircuit(_num_rows=num_rows)

    def allocate_witness_cell(self) -> Target:
        t = Target(self.num_columns)
        self.num_columns += 1
        return t

    def allocate_state_cell(self) -> StateCell:
        current = self.allocate_witness_cell()
        nxt = self.allocate_witness_cell()
        cell = StateCell(current=current, next=nxt)
        self.state_cells.append(cell)
        return cell

    def enforce_constraint(self, constraint: Expr) -> None:
        self.recurring_constraints.append(constraint)

    def enforce_boundary_constraint(self, row: int, constraint: Expr) -> None:
        self.boundary_constraints.append((row, constraint))

    # -- Circuit protocol (`transition_circuit.rs:78-205`) -------------------

    def num_rows(self) -> int:
        return self._num_rows

    def num_cols(self) -> int:
        n = max(self.num_columns, 1)
        # next power of two
        return 1 << (n - 1).bit_length()

    def num_public_columns(self) -> int:
        return len(self.boundary_constraints)

    def public_values(self) -> list[list[int]]:
        public = [[0] * self.num_rows() for _ in range(self.num_public_columns())]
        for i, (row, _) in enumerate(self.boundary_constraints):
            public[i][row] = 1
        return public

    def zero_check_expressions(self) -> list[Expr]:
        constraints = list(self.recurring_constraints)
        padded_num_cols = self.num_cols()
        for i, (_row, constraint) in enumerate(self.boundary_constraints):
            constraints.append(Mul(Input(i + padded_num_cols), constraint))
        return constraints

    def permutation(self) -> tuple[list[int], list[int]]:
        """Cell-swap permutation pairs per state cell, +1 shifted
        (`transition_circuit.rs:120-151`)."""
        num_cells = self.num_rows() * self.num_cols()
        assert num_cells & (num_cells - 1) == 0
        id_mapping = list(range(num_cells))
        permutation_mapping = list(id_mapping)
        for cell in self.state_cells:
            cur, nxt = cell.current.col, cell.next.col
            for row in range(self.num_rows() - 1):
                frm = nxt * self.num_rows() + row
                to = cur * self.num_rows() + (row + 1)
                permutation_mapping[frm] = to
                permutation_mapping[to] = frm
        id_mapping = [(x + 1) % R for x in id_mapping]
        permutation_mapping = [(x + 1) % R for x in permutation_mapping]
        return id_mapping, permutation_mapping

    def check_constraints(self, witness: list[list[int]]) -> None:
        """Row-wise sanity re-evaluation (`transition_circuit.rs:153-204`).
        Raises ValueError on violation."""
        for row in range(self.num_rows()):
            row_values = [col[row] for col in witness]
            for constraint in self.recurring_constraints:
                if constraint.evaluate(row_values) % R != 0:
                    raise _recurring_error(constraint, row, row_values)
        self._check_boundary(witness)
        for cell in self.state_cells:
            for row in range(self.num_rows() - 1):
                if witness[cell.next.col][row] % R != witness[cell.current.col][row + 1] % R:
                    raise _state_error(row)

    def _check_boundary(self, witness: list[list[int]]) -> None:
        for row, constraint in self.boundary_constraints:
            row_values = [col[row] for col in witness]
            if constraint.evaluate(row_values) % R != 0:
                raise ValueError(
                    f"Boundary constraint {constraint} not satisfied at row "
                    f"{row}; row values: {row_values}")

    def check_constraints_device(self, engine, columns: list,
                                 witness: list[list[int]]) -> None:
        """`check_constraints` over the witness columns as device vectors
        (`columns`, of `engine`): each recurring constraint through
        `engine.eval_expr`, and each state cell as a compare of next[:-1]
        with current[1:], in one `engine.first_nonzero` for the whole
        trace.  The boundary constraints are checked on the host.  A
        failure raises the host check's ValueError for the same first
        failure, in its order (recurring constraints by row, then
        boundary, then state cells), with the row values read from
        `witness`."""
        rows = self.num_rows()
        firsts = engine.first_nonzero(
            [engine.eval_expr(columns, c, rows)
             for c in self.recurring_constraints],
            [(columns[cell.next.col], columns[cell.current.col])
             for cell in self.state_cells])
        recurring = firsts[:len(self.recurring_constraints)]
        bad = [r for r in recurring if r is not None]
        if bad:
            row = min(bad)
            raise _recurring_error(
                self.recurring_constraints[recurring.index(row)], row,
                [col[row] for col in witness])
        self._check_boundary(witness)
        state = next((r for r in firsts[len(recurring):] if r is not None),
                     None)
        if state is not None:
            raise _state_error(state)


def _recurring_error(constraint: Expr, row: int, row_values) -> ValueError:
    return ValueError(f"Recurring constraint {constraint} not satisfied at "
                      f"row {row}; row values: {row_values}")


def _state_error(row: int) -> ValueError:
    return ValueError(f"Permutation constraint not satisfied for state cell "
                      f"at row {row}")
