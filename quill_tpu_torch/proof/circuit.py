"""Circuit protocol: the proving-system-facing circuit interface.

Counterpart of `quill-zkvm/hyperplonk/src/proof/circuit.rs:6-59`.
`num_rows`/`num_cols` must be powers of two; zero-check expression input
indices 0..num_cols refer to witness columns and
num_cols..num_cols+num_public_columns to public columns; id/permutation
mappings MUST NOT contain zero (zero-padding soundness trap explained at
`circuit.rs:35-52`, hence the frontend's +1 shift).  A circuit may also
offer `check_constraints_device(engine, columns, witness)`, the same check
over the witness columns as device vectors (the transition frontend does);
the prover calls it where it has such columns.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class Circuit(Protocol):
    def num_rows(self) -> int: ...

    def num_cols(self) -> int: ...

    def num_public_columns(self) -> int: ...

    def public_values(self) -> list[list[int]]: ...

    def zero_check_expressions(self) -> list: ...

    def permutation(self) -> tuple[list[int], list[int]]: ...

    def check_constraints(self, witness: list[list[int]]) -> None: ...
