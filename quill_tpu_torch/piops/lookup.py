"""Multi-column tuple lookup PIOP.

Counterpart of `quill-zkvm/hyperplonk/src/piops/lookup.rs`: k source and
k destination columns are batched into single virtual columns via powers of a
challenge alpha, then delegated to the set-inclusion PIOP.

Note: the reference verifier's point-consistency loop checks
`source_claims[i]` twice and never `dests_claims[i]` (`lookup.rs:106-111`, a
flagged reference bug).  We check both; this is transcript-invisible and only
stricter (honest proofs still verify both ways).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.bn254 import R
from ..pcs import EvaluationClaim
from ..transcript.transcript import Transcript
from . import set_inclusion
from .set_inclusion import (SetInclusionEvaluationClaims,
                            SetInclusionEvaluationPoints, SetInclusionProof)
from .virtual_poly import Const, Store, VirtualRef


@dataclass
class LookupProof:
    """`LookupProof` (`lookup.rs:14-16`)."""

    set_inclusion_proof: SetInclusionProof


LookupEvaluationPoints = SetInclusionEvaluationPoints


@dataclass
class LookupEvaluationClaims:
    """`LookupEvaluationClaims` (`lookup.rs:19-23`)."""

    source_claims: list[EvaluationClaim]
    dests_claims: list[EvaluationClaim]
    multiplicities_claim: EvaluationClaim


def prove(source_store: Store, source_cols: list[VirtualRef],
          dest_store: Store, dest_cols: list[VirtualRef],
          multiplicities: VirtualRef, transcript: Transcript, pcs
          ) -> tuple[LookupProof, SetInclusionEvaluationPoints]:
    """`LookupProof::prove` (`lookup.rs:28-83`)."""
    assert len(source_cols) == len(dest_cols), \
        "The number of source and destination columns must be equal"
    n = len(source_cols)
    transcript.append_usize(n)
    assert n > 0, "Lookup must be applied to at least one column"

    alpha = transcript.draw_field_element()
    alpha_powers = [pow(alpha, i, R) for i in range(n)]

    batched_left = source_store.get_expr(source_cols[0])
    batched_right = dest_store.get_expr(dest_cols[0])
    for i in range(1, n):
        batched_left = batched_left + (
            Const(alpha_powers[i]) * source_store.get_expr(source_cols[i]))
        batched_right = batched_right + (
            Const(alpha_powers[i]) * dest_store.get_expr(dest_cols[i]))

    batched_virtual_left = source_store.new_virtual_from_expr(batched_left)
    batched_virtual_right = dest_store.new_virtual_from_expr(batched_right)

    proof, eval_points = set_inclusion.prove(
        source_store, batched_virtual_left,
        dest_store, batched_virtual_right,
        multiplicities, transcript, pcs)

    return LookupProof(set_inclusion_proof=proof), eval_points


def verify(proof: LookupProof, transcript: Transcript, pcs,
           evals: LookupEvaluationClaims) -> None:
    """`LookupProof::verify` (`lookup.rs:87-142`).  Assumes the individual
    claims are verified separately.  Raises ValueError on failure."""
    n = len(evals.source_claims)
    if len(evals.dests_claims) != n:
        raise ValueError("Mismatched lookup evaluation vector lengths")
    transcript.append_usize(n)
    alpha = transcript.draw_field_element()
    alpha_powers = [pow(alpha, i, R) for i in range(n)]

    source_point = list(evals.source_claims[0].point)
    dest_point = list(evals.dests_claims[0].point)
    for i in range(n):
        if (evals.source_claims[i].point != source_point
                or evals.dests_claims[i].point != dest_point):
            raise ValueError("Lookup evaluation points for columns are inconsistent")

    source_batched = sum(evals.source_claims[i].evaluation * alpha_powers[i]
                         for i in range(n)) % R
    dest_batched = sum(evals.dests_claims[i].evaluation * alpha_powers[i]
                       for i in range(n)) % R

    set_inclusion.verify(
        proof.set_inclusion_proof, transcript, pcs,
        SetInclusionEvaluationClaims(
            h_left_sumcheck_claim=EvaluationClaim(point=source_point,
                                                  evaluation=source_batched),
            h_right_sumcheck_claim=EvaluationClaim(point=dest_point,
                                                   evaluation=dest_batched),
            multiplicities_claim=evals.multiplicities_claim,
        ))
