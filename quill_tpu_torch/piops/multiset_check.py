"""Logup-based multiset-equality PIOP (no grand product).

Counterpart of `quill-zkvm/hyperplonk/src/piops/multiset_check.rs`:
draw gamma; commit the log-derivative tables 1/(gamma + h_left(x)) and
m(x)/(gamma + h_right(x)); batch the two denominator-correctness zero-checks
(challenge lambda) together with the "sums are equal" sumcheck (challenge
alpha) into one sumcheck of

  [denom_l (gamma + h_l) - 1 + lambda (denom_r (gamma + h_r) - m)] eq(x,z) alpha
  + denom_l - denom_r  = 0

The denominators use the engine's batched inversion (Montgomery's trick /
prefix products) instead of the reference's per-element inversions
(`multiset_check.rs:43-65`).  Transcript event order is preserved exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from ..fields.bn254 import R
from ..pcs import EvaluationClaim
from ..transcript.transcript import Transcript
from . import sumcheck
from .virtual_poly import Const, Store, VirtualRef
from .zerocheck import eq_eval


class LookupMode(Enum):
    """`LookupMode` (`multiset_check.rs:11-16`)."""

    SUBSET = "subset"
    EQUALITY = "equality"


@dataclass
class MultisetEqualityProof:
    """`MultisetEqualityProof` (`multiset_check.rs:18-24`)."""

    denom_left_commitment: object
    denom_right_commitment: object
    sumcheck_proof: sumcheck.SumcheckProof
    opening_proof_denom_left: object   # MLEvalProof
    opening_proof_denom_right: object


def prove(store: Store, h_left: VirtualRef, h_right: VirtualRef,
          transcript: Transcript, pcs, mode: LookupMode,
          multiplicities: VirtualRef | None = None
          ) -> tuple[MultisetEqualityProof, list[int]]:
    """`MultisetEqualityProof::prove` (`multiset_check.rs:28-182`).  Returns
    the proof and the common evaluation point for h_left / h_right."""
    engine = store.engine
    num_vars = store.num_vars

    from ..utils.profiling import phase

    logup_eval_point = transcript.draw_field_element()

    with phase("multiset/log_derivative_tables"):
        h_left_evals = store.eval_expr_table(h_left)
        h_right_evals = store.eval_expr_table(h_right)
        u_left = engine.add_scalar(h_left_evals, logup_eval_point)
        u_right = engine.add_scalar(h_right_evals, logup_eval_point)
        denom_left = engine.batch_inverse(u_left)
        denom_right = engine.batch_inverse(u_right)

    if mode == LookupMode.SUBSET:
        assert multiplicities is not None, \
            "Multiplicities polynomial must be provided in subset mode"
        mult_evals = store.eval_expr_table(multiplicities)
        denom_right = engine.mul(denom_right, mult_evals)
    else:
        assert multiplicities is None, \
            "Multiplicities polynomial must not be provided in equality mode"

    with phase("multiset/commits"):
        commitment_left, commitment_right = pcs.commit_many(
            [denom_left, denom_right])
    transcript.append_g1(commitment_left)
    transcript.append_g1(commitment_right)

    lam = transcript.draw_field_element()
    alpha = transcript.draw_field_element()

    denom_left_ref = store.allocate_polynomial(denom_left)
    denom_right_ref = store.allocate_polynomial(denom_right)

    # The reference's zerocheck expr re-derives (gamma + h) from the h-side
    # input tables every round (`multiset_check.rs:128-140`); we feed the
    # ALREADY-MATERIALIZED u = gamma + h tables (built above for the batch
    # inversion) into the sumcheck instead.  Per-point values are identical
    # field elements, so every round message -- and hence the transcript --
    # is unchanged; the round kernels just read 1 fused table per side
    # instead of re-evaluating the h expression (for the permutation check
    # that is id/perm + alpha*witness) at every interpolation node.
    #
    # Soundness of the substitution REQUIRES the h-side expressions to be
    # multilinear (degree <= 1 in the input tables): sumcheck round
    # messages evaluate the expression on per-table interpolations, and
    # interp(gamma + h) == gamma + h(interp(tables)) only when h is linear.
    # Nonlinear h-sides fall back to the original expression form (round
    # messages then differ from the u-table form but match the verifier's
    # reconstruction, which is what matters).
    m_expr = (store.get_expr(multiplicities) if mode == LookupMode.SUBSET
              else Const(1))

    def u_side(u_vec, h_ref):
        h_expr = store.get_expr(h_ref)
        if h_expr.degree() <= 1:
            return store.allocate_polynomial(u_vec).to_expr()
        return Const(logup_eval_point) + h_expr

    zerocheck_expr = (
        denom_left_ref.to_expr() * u_side(u_left, h_left)
        - Const(1)
        + Const(lam) * (denom_right_ref.to_expr() * u_side(u_right, h_right)
                        - m_expr)
    )

    zerocheck_random_point = [transcript.draw_field_element() for _ in range(num_vars)]
    with phase("multiset/eq_table"):
        eq_evals = engine.eq_table(zerocheck_random_point)
    eq_ref = store.allocate_polynomial(eq_evals)
    h_hat = store.new_virtual_from_expr(zerocheck_expr)
    store.mul_in_place(h_hat, eq_ref)
    store.mul_const_in_place(h_hat, alpha)
    store.add_in_place(h_hat, denom_left_ref)
    store.sub_in_place(h_hat, denom_right_ref)

    with phase("multiset/sumcheck"):
        sumcheck_proof, sc_claim = sumcheck.prove(
            num_vars, store, h_hat, 0, transcript)
    evaluation_point = sc_claim.point

    with phase("multiset/opens"):
        # one fused pipeline (shared eq table, one quotient pass, one
        # multi-MSM); byte-identical to two sequential opens
        opening_left, opening_right = pcs.open_many(
            [(denom_left, evaluation_point),
             (denom_right, evaluation_point)], transcript)

    return (
        MultisetEqualityProof(
            denom_left_commitment=commitment_left,
            denom_right_commitment=commitment_right,
            sumcheck_proof=sumcheck_proof,
            opening_proof_denom_left=opening_left,
            opening_proof_denom_right=opening_right,
        ),
        evaluation_point,
    )


def verify(proof: MultisetEqualityProof, transcript: Transcript, pcs,
           left_h_eval: EvaluationClaim, right_h_eval: EvaluationClaim,
           mode: LookupMode,
           multiplicities_eval: EvaluationClaim | None = None,
           strict: bool = False) -> None:
    """`MultisetEqualityProof::verify` (`multiset_check.rs:185-294`).
    Assumes the left/right (and multiplicities) evaluation claims are verified
    separately.  Raises ValueError on failure.

    strict: enforce the structural sumcheck degree bound.  The batched
    expression is eq * [denom*(gamma+h) - {1|m}] (+ linear terms): denoms,
    h-sides and multiplicities are all degree-1 inputs, so the bound is 3."""
    logup_eval_point = transcript.draw_field_element()

    transcript.append_g1(proof.denom_left_commitment)
    transcript.append_g1(proof.denom_right_commitment)

    lam = transcript.draw_field_element()
    alpha = transcript.draw_field_element()

    zerocheck_random_point = [transcript.draw_field_element()
                              for _ in range(len(left_h_eval.point))]

    if proof.sumcheck_proof.claimed_sum % R != 0:
        raise ValueError("Multiset equality sumcheck claimed sum is not zero")

    sc_claim = sumcheck.verify(proof.sumcheck_proof, transcript,
                               max_degree=3 if strict else None)

    if not pcs.verify(proof.denom_left_commitment,
                      proof.opening_proof_denom_left, transcript):
        raise ValueError("Multiset equality opening proof verification failed")
    if not pcs.verify(proof.denom_right_commitment,
                      proof.opening_proof_denom_right, transcript):
        raise ValueError("Multiset equality opening proof verification failed")

    if (proof.opening_proof_denom_left.point() != sc_claim.point
            or proof.opening_proof_denom_right.point() != sc_claim.point):
        raise ValueError(
            "Multiset equality opening proof evaluation point does not match sumcheck")

    if left_h_eval.point != sc_claim.point or right_h_eval.point != sc_claim.point:
        raise ValueError("Multiset equality h evaluation point does not match sumcheck")

    m = 1
    if mode == LookupMode.SUBSET:
        if multiplicities_eval is None:
            raise AssertionError("Multiplicities evaluation must be provided in subset mode")
        if multiplicities_eval.point != sc_claim.point:
            raise ValueError(
                "Multiset equality multiplicities evaluation point does not match sumcheck")
        m = multiplicities_eval.evaluation
    else:
        assert multiplicities_eval is None, \
            "Multiplicities evaluation must not be provided in equality mode"

    denom_left_eval = proof.opening_proof_denom_left.evaluation
    denom_right_eval = proof.opening_proof_denom_right.evaluation

    zerocheck_eval = (
        denom_left_eval * (logup_eval_point + left_h_eval.evaluation) - 1
        + lam * (denom_right_eval * (logup_eval_point + right_h_eval.evaluation) - m)
    ) % R

    e = eq_eval(zerocheck_random_point, left_h_eval.point)
    final_eval = (zerocheck_eval * e * alpha + denom_left_eval - denom_right_eval) % R

    if final_eval != sc_claim.evaluation % R:
        raise ValueError("Multiset equality final evaluation does not match sumcheck")
