"""Zero-check PIOP: reduce "h vanishes on {0,1}^n" to a sumcheck.

Counterpart of `quill-zkvm/hyperplonk/src/piops/zerocheck.rs`: draw a
random point z, multiply h by the eq(x, z) table, sumcheck with claimed sum 0,
then divide the resulting claim by eq(z, r̂).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.bn254 import R
from ..fields.scalar import inv
from ..pcs import EvaluationClaim
from ..transcript.transcript import Transcript
from . import sumcheck
from .virtual_poly import Store, VirtualRef


def eq_eval(x: list[int], r: list[int]) -> int:
    """eq(x, r) point evaluation, O(n)
    (`quill-zkvm/hyperplonk/src/utils/eq_eval.rs:33-43`)."""
    assert len(x) == len(r)
    result = 1
    for xi, ri in zip(x, r):
        term = (xi * ri + (1 - xi) * (1 - ri)) % R
        result = result * term % R
    return result


@dataclass
class ZeroCheckProof:
    """`ZeroCheckProof` (`zerocheck.rs:8-11`)."""

    num_vars: int
    sumcheck_proof: sumcheck.SumcheckProof


def prove(store: Store, h: VirtualRef, transcript: Transcript
          ) -> tuple[ZeroCheckProof, EvaluationClaim]:
    """`ZeroCheckProof::prove` (`zerocheck.rs:14-49`)."""
    num_vars = store.num_vars
    random_point = [transcript.draw_field_element() for _ in range(num_vars)]

    from ..utils.profiling import phase

    with phase("zerocheck/eq_table"):
        eq_evals = store.engine.eq_table(random_point)
    eq_ref = store.allocate_polynomial(eq_evals)
    h_hat = store.new_virtual_from_virtual(h)
    store.mul_in_place(h_hat, eq_ref)

    with phase("zerocheck/sumcheck"):
        sumcheck_proof, sc_claim = sumcheck.prove(num_vars, store, h_hat, 0,
                                                  transcript)

    e = eq_eval(random_point, sc_claim.point)
    claim = EvaluationClaim(
        point=sc_claim.point,
        evaluation=sc_claim.evaluation * inv(e, R) % R,
    )
    return ZeroCheckProof(num_vars=num_vars, sumcheck_proof=sumcheck_proof), claim


def verify(proof: ZeroCheckProof, transcript: Transcript,
           max_degree: int | None = None) -> EvaluationClaim:
    """`ZeroCheckProof::verify` (`zerocheck.rs:51-75`).  Raises ValueError on
    failure.  `max_degree` (strict mode): bound on the sumcheck round-poly
    degree INCLUDING the eq factor; derived by the caller from the circuit
    expressions."""
    num_vars = proof.num_vars
    random_point = [transcript.draw_field_element() for _ in range(num_vars)]

    if proof.sumcheck_proof.claimed_sum % R != 0:
        raise ValueError("Sumcheck claimed sum is not zero")
    if proof.sumcheck_proof.num_vars != num_vars:
        raise ValueError("Sumcheck proof num_vars does not match zerocheck num_vars")

    sc_claim = sumcheck.verify(proof.sumcheck_proof, transcript,
                               max_degree=max_degree)
    e = eq_eval(random_point, sc_claim.point)
    return EvaluationClaim(
        point=sc_claim.point,
        evaluation=sc_claim.evaluation * inv(e, R) % R,
    )
