"""Set-inclusion PIOP supporting different table sizes (Logup over two
hypercubes).

Counterpart of `quill-zkvm/hyperplonk/src/piops/set_inclusion.rs`:
source and table live on hypercubes of possibly different sizes (two separate
stores, n_left vs n_right variables); log-derivative tables
  denom_left(x) = 1/(gamma + h_left(x)),  denom_right(x) = m(x)/(gamma + h_right(x))
are committed, and two independent sumchecks -- each batching its denominator
zero-check (via eq(x, z)) with its denominator-sum claim using challenges
alpha (left) and beta (right) -- prove sum(denom_left) == sum(denom_right).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.bn254 import R
from ..fields.scalar import inv
from ..pcs import EvaluationClaim
from ..transcript.transcript import Transcript
from ..utils.profiling import phase
from . import sumcheck
from .virtual_poly import Const, Store, VirtualRef
from .zerocheck import eq_eval


@dataclass
class SetInclusionProof:
    """`SetInclusionProof` (`set_inclusion.rs:52-61`)."""

    denom_left_commitment: object
    denom_right_commitment: object
    sumcheck_proof_left: sumcheck.SumcheckProof
    sumcheck_proof_right: sumcheck.SumcheckProof
    opening_proof_denom_left: object
    opening_proof_denom_right: object


@dataclass
class SetInclusionEvaluationPoints:
    """`SetInclusionEvaluationPoints` (`set_inclusion.rs:63-66`)."""

    left: list[int]
    right: list[int]


@dataclass
class SetInclusionEvaluationClaims:
    """`SetInclusionEvaluationClaims` (`set_inclusion.rs:68-72`)."""

    h_left_sumcheck_claim: EvaluationClaim
    h_right_sumcheck_claim: EvaluationClaim
    multiplicities_claim: EvaluationClaim


def prove(store_left: Store, h_left: VirtualRef,
          store_right: Store, h_right: VirtualRef,
          multiplicities: VirtualRef, transcript: Transcript, pcs
          ) -> tuple[SetInclusionProof, SetInclusionEvaluationPoints]:
    """`SetInclusionProof::prove` (`set_inclusion.rs:77-235`).
    `multiplicities` lives in `store_right`."""
    engine = store_left.engine
    num_vars_left = store_left.num_vars
    num_vars_right = store_right.num_vars

    logup_eval_point = transcript.draw_field_element()

    with phase("set_inclusion/log_derivative_tables"):
        h_left_evals = store_left.eval_expr_table(h_left)
        h_right_evals = store_right.eval_expr_table(h_right)
        u_left = engine.add_scalar(h_left_evals, logup_eval_point)
        u_right = engine.add_scalar(h_right_evals, logup_eval_point)
        denom_left = engine.batch_inverse(u_left)
        denom_right = engine.batch_inverse(u_right)
        mult_evals = store_right.eval_expr_table(multiplicities)
        denom_right = engine.mul(denom_right, mult_evals)

    with phase("set_inclusion/commits"):
        commitment_left, commitment_right = pcs.commit_many(
            [denom_left, denom_right])
    transcript.append_g1(commitment_left)
    transcript.append_g1(commitment_right)

    # left sumcheck challenges
    z1 = [transcript.draw_field_element() for _ in range(num_vars_left)]
    alpha = transcript.draw_field_element()

    denom_left_ref = store_left.allocate_polynomial(denom_left)
    denom_right_ref = store_right.allocate_polynomial(denom_right)

    m_expr = store_right.get_expr(multiplicities)
    h_left_expr = store_left.get_expr(h_left)
    h_right_expr = store_right.get_expr(h_right)

    with phase("set_inclusion/eq_table"):
        eq_left = store_left.allocate_polynomial(engine.eq_table(z1))
    left_expr = (denom_left_ref.to_expr()
                 * (Const(logup_eval_point) + h_left_expr)
                 - Const(1))
    left_expr = left_expr * eq_left.to_expr() \
        + denom_left_ref.to_expr() * Const(alpha)
    sumcheck_virtual_left = store_left.new_virtual_from_expr(left_expr)

    with phase("set_inclusion/sumcheck"):
        claimed_sum_left = engine.vsum(denom_left) * alpha % R
        sumcheck_proof_left, claim_left = sumcheck.prove(
            num_vars_left, store_left, sumcheck_virtual_left,
            claimed_sum_left, transcript)

    # right sumcheck challenges
    z2 = [transcript.draw_field_element() for _ in range(num_vars_right)]
    beta = transcript.draw_field_element()

    with phase("set_inclusion/eq_table"):
        eq_right = store_right.allocate_polynomial(engine.eq_table(z2))
    right_expr = (denom_right_ref.to_expr()
                  * (Const(logup_eval_point) + h_right_expr)
                  - m_expr)
    right_expr = right_expr * eq_right.to_expr() \
        + denom_right_ref.to_expr() * Const(beta)
    sumcheck_virtual_right = store_right.new_virtual_from_expr(right_expr)

    with phase("set_inclusion/sumcheck"):
        claimed_sum_right = engine.vsum(denom_right) * beta % R
        sumcheck_proof_right, claim_right = sumcheck.prove(
            num_vars_right, store_right, sumcheck_virtual_right,
            claimed_sum_right, transcript)

    with phase("set_inclusion/opens"):
        opening_left, opening_right = pcs.open_many(
            [(denom_left, claim_left.point),
             (denom_right, claim_right.point)], transcript)

    proof = SetInclusionProof(
        denom_left_commitment=commitment_left,
        denom_right_commitment=commitment_right,
        sumcheck_proof_left=sumcheck_proof_left,
        sumcheck_proof_right=sumcheck_proof_right,
        opening_proof_denom_left=opening_left,
        opening_proof_denom_right=opening_right,
    )
    points = SetInclusionEvaluationPoints(left=claim_left.point,
                                          right=claim_right.point)
    return proof, points


def verify(proof: SetInclusionProof, transcript: Transcript, pcs,
           evals: SetInclusionEvaluationClaims,
           strict: bool = False) -> None:
    """`SetInclusionProof::verify` (`set_inclusion.rs:238-347`).  Assumes all
    evaluation claims in `evals` have been checked separately.  Raises
    ValueError on failure.  strict: bound both sumchecks' round-poly degree
    at 3 (eq * denom * (gamma+h), all degree-1 inputs)."""
    num_vars_left = len(evals.h_left_sumcheck_claim.point)
    num_vars_right = len(evals.h_right_sumcheck_claim.point)

    logup_eval_point = transcript.draw_field_element()

    transcript.append_g1(proof.denom_left_commitment)
    transcript.append_g1(proof.denom_right_commitment)

    z1 = [transcript.draw_field_element() for _ in range(num_vars_left)]
    alpha = transcript.draw_field_element()

    denom_left_claim = sumcheck.verify(proof.sumcheck_proof_left, transcript,
                                       max_degree=3 if strict else None)

    z2 = [transcript.draw_field_element() for _ in range(num_vars_right)]
    beta = transcript.draw_field_element()

    denom_right_claim = sumcheck.verify(proof.sumcheck_proof_right,
                                        transcript,
                                        max_degree=3 if strict else None)

    if not pcs.verify(proof.denom_left_commitment,
                      proof.opening_proof_denom_left, transcript):
        raise ValueError("Left denominator opening proof failed")
    if not pcs.verify(proof.denom_right_commitment,
                      proof.opening_proof_denom_right, transcript):
        raise ValueError("Right denominator opening proof failed")

    denom_left_eval = proof.opening_proof_denom_left.evaluation
    denom_right_eval = proof.opening_proof_denom_right.evaluation

    if denom_left_claim.point != proof.opening_proof_denom_left.point():
        raise ValueError("Left sumcheck point does not match PCS opening point")

    if (evals.h_left_sumcheck_claim.point != denom_left_claim.point
            or evals.h_right_sumcheck_claim.point != denom_right_claim.point
            or evals.multiplicities_claim.point != denom_right_claim.point):
        raise ValueError("Mismatched evaluation points for set inclusion")

    if denom_right_claim.point != proof.opening_proof_denom_right.point():
        raise ValueError("Right sumcheck point does not match PCS opening point")

    # Reconstruct the left sumcheck evaluation
    eq_z1 = eq_eval(denom_left_claim.point, z1)
    left_zc = (denom_left_eval
               * (logup_eval_point + evals.h_left_sumcheck_claim.evaluation)
               - 1) % R
    left_eval = (left_zc * eq_z1 + alpha * denom_left_eval) % R
    if left_eval != denom_left_claim.evaluation % R:
        raise ValueError("Left sumcheck evaluation mismatch")

    # Reconstruct the right sumcheck evaluation
    eq_z2 = eq_eval(denom_right_claim.point, z2)
    right_zc = (denom_right_eval
                * (logup_eval_point + evals.h_right_sumcheck_claim.evaluation)
                - evals.multiplicities_claim.evaluation) % R
    right_eval = (right_zc * eq_z2 + beta * denom_right_eval) % R
    if right_eval != denom_right_claim.evaluation % R:
        raise ValueError("Right sumcheck evaluation mismatch")

    # v1 = claimed_sum_left / alpha must equal v2 = claimed_sum_right / beta
    v1 = proof.sumcheck_proof_left.claimed_sum * inv(alpha, R) % R
    v2 = proof.sumcheck_proof_right.claimed_sum * inv(beta, R) % R
    if v1 != v2:
        raise ValueError("Log-derivative sums do not match")
