"""Polynomial commitment schemes.

Counterpart of `quill-zkvm/pcs/src/lib.rs`: the `EvaluationClaim` record
and the multilinear-PCS interface the upper stack is generic over.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class EvaluationClaim:
    """`EvaluationClaim { point, evaluation }` (`pcs/src/lib.rs:10-13`)."""

    point: list
    evaluation: int
