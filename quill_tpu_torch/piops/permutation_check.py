"""Permutation-check PIOP (Plonk-style copy constraints via multiset equality).

Counterpart of `quill-zkvm/hyperplonk/src/piops/permutation_check.rs`:
fold (index, value) pairs with a challenge alpha --
left̂ = id(x) + alpha h_left(x), right̂ = perm(x) + alpha h_right(x) --
and prove multiset equality of the folded columns.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..pcs import EvaluationClaim
from ..transcript.transcript import Transcript
from . import multiset_check
from .multiset_check import LookupMode
from .virtual_poly import Store, VirtualRef


@dataclass
class PermutationCheckProof:
    """`PermutationCheckProof` (`permutation_check.rs:8-10`)."""

    multiset_equality_proof: multiset_check.MultisetEqualityProof


def prove(store: Store, h_left: VirtualRef, h_right: VirtualRef,
          id_indices, permutation_indices, transcript: Transcript, pcs
          ) -> tuple[PermutationCheckProof, list[int]]:
    """`PermutationCheckProof::prove` (`permutation_check.rs:13-58`)."""
    num_vars = store.num_vars

    id_ref = store.allocate_polynomial(id_indices)
    perm_ref = store.allocate_polynomial(permutation_indices)

    alpha = transcript.draw_field_element()

    h_left_hat = store.new_virtual_from_virtual(h_left)
    store.mul_const_in_place(h_left_hat, alpha)
    store.add_in_place(h_left_hat, id_ref)

    h_right_hat = store.new_virtual_from_virtual(h_right)
    store.mul_const_in_place(h_right_hat, alpha)
    store.add_in_place(h_right_hat, perm_ref)

    msp, evaluation_point = multiset_check.prove(
        store, h_left_hat, h_right_hat, transcript, pcs,
        LookupMode.EQUALITY, None)

    return PermutationCheckProof(multiset_equality_proof=msp), evaluation_point


def verify(proof: PermutationCheckProof, transcript: Transcript, pcs,
           left_h_eval: EvaluationClaim, right_h_eval: EvaluationClaim,
           id_eval: EvaluationClaim, perm_eval: EvaluationClaim,
           strict: bool = False) -> None:
    """`PermutationCheckProof::verify` (`permutation_check.rs:61-93`).
    Assumes the four evaluation claims are verified separately."""
    from ..fields.bn254 import R

    alpha = transcript.draw_field_element()

    left_hat = EvaluationClaim(
        point=list(left_h_eval.point),
        evaluation=(id_eval.evaluation + alpha * left_h_eval.evaluation) % R,
    )
    right_hat = EvaluationClaim(
        point=list(right_h_eval.point),
        evaluation=(perm_eval.evaluation + alpha * right_h_eval.evaluation) % R,
    )

    multiset_check.verify(proof.multiset_equality_proof, transcript, pcs,
                          left_hat, right_hat, LookupMode.EQUALITY, None,
                          strict=strict)
