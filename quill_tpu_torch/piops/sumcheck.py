"""Linear-time sumcheck prover/verifier.

Counterpart of `quill-zkvm/hyperplonk/src/piops/sumcheck.rs`.

TPU-first design: the reference builds per-point degree-1 `DensePolynomial`s
and evaluates the expression tree *symbolically* per hypercube point
(`sumcheck.rs:51-70`).  Here each round evaluates the fused expression at the
(deg+1) interpolation nodes t = 0..deg over the whole (half-size) hypercube in
one device program, sums, and interpolates the coefficient form on the host --
the resulting message polynomial is identical coefficient-for-coefficient
(its degree is bounded by the structural degree), so the transcript bytes
(trailing-zero-stripped `DensePolynomial` encoding) match exactly.

Only polynomials referenced by the expression are folded (the reference clones
and folds the whole store, `sumcheck.rs:42-49` -- a flagged inefficiency);
unused inputs contribute 0 to the final evaluation vector, which the
expression never reads.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.bn254 import R
from ..fields.scalar import batch_inverse
from ..pcs import EvaluationClaim
from ..transcript.transcript import Transcript
from .virtual_poly import Store, VirtualRef


def interpolate_coeffs(values: list[int]) -> list[int]:
    """Lagrange interpolation at nodes t = 0..d over Fr; returns coefficient
    form (low-to-high), *not* stripped (serialization strips)."""
    d = len(values) - 1
    if d < 0:
        return []
    if d == 0:
        return [values[0] % R]
    # denominators: prod_{j != i} (i - j) = (-1)^(d-i) * i! * (d-i)!
    fact = [1] * (d + 1)
    for i in range(1, d + 1):
        fact[i] = fact[i - 1] * i % R
    denoms = []
    for i in range(d + 1):
        den = fact[i] * fact[d - i] % R
        if (d - i) % 2 == 1:
            den = R - den
        denoms.append(den)
    inv_denoms = batch_inverse(denoms, R)
    # numerator polynomial N(X) = prod_j (X - j); per-i quotient by (X - i)
    n_coeffs = [1]
    for j in range(d + 1):
        nxt = [0] * (len(n_coeffs) + 1)
        for k, c in enumerate(n_coeffs):
            nxt[k + 1] = (nxt[k + 1] + c) % R
            nxt[k] = (nxt[k] - j * c) % R
        n_coeffs = nxt
    coeffs = [0] * (d + 1)
    for i in range(d + 1):
        w = values[i] * inv_denoms[i] % R
        if w == 0:
            continue
        # q = N / (X - i): synthetic division
        q = [0] * (d + 1)
        acc = 0
        for k in range(d + 1, 0, -1):
            acc = (acc * i + n_coeffs[k]) % R
            q[k - 1] = acc
        for k in range(d + 1):
            coeffs[k] = (coeffs[k] + w * q[k]) % R
    return coeffs


def poly_eval_host(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


@dataclass
class SumcheckProof:
    """`SumcheckProof { num_vars, claimed_sum, r_polys }` (`sumcheck.rs:14-19`).
    `r_polys` are coefficient lists (low-to-high, trailing zeros stripped to
    mirror `DensePolynomial` normalization)."""

    num_vars: int
    claimed_sum: int
    r_polys: list[list[int]]


def prove(num_vars: int, store: Store, h: VirtualRef, claimed_sum: int,
          transcript: Transcript) -> tuple[SumcheckProof, EvaluationClaim]:
    """`SumcheckProof::prove` (`sumcheck.rs:28-114`).  Binds the LSB variable
    each round; appends each round message then draws the challenge."""
    engine = store.engine
    transcript.append_usize(num_vars)
    transcript.append_field(claimed_sum % R)

    expr = store.get_expr(h)
    degree = expr.degree()
    used = sorted(expr.used_inputs())
    num_inputs = len(store.polynomials)

    # tables list indexed by input index; unused slots None
    tables: list = [None] * num_inputs
    for i in used:
        tables[i] = store.polynomials[i]

    output_r_polys: list[list[int]] = []
    evaluation_point: list[int] = []

    for _round in range(num_vars):
        if _round == 0:
            # may convert tables to the engine's round-loop representation
            tables, msg_evals = engine.sumcheck_begin(tables, expr, degree)
        else:
            # fused: fold at the previous challenge + this round's messages
            # in one device pass
            tables, msg_evals = engine.sumcheck_round_fused(
                tables, expr, degree, evaluation_point[-1])
        coeffs = interpolate_coeffs(msg_evals)
        # strip for serialization parity with DensePolynomial
        stripped = list(coeffs)
        while stripped and stripped[-1] == 0:
            stripped.pop()
        transcript.append_dense_poly(stripped)
        output_r_polys.append(stripped)

        r = transcript.draw_field_element()
        evaluation_point.append(r)

    # final fold at the last challenge to obtain the evaluation vector
    for i in used:
        tables[i] = engine.fold(tables[i], evaluation_point[-1])

    final_evals = [0] * num_inputs
    for i in used:
        final_evals[i] = int(engine.vec_to_ints(tables[i])[0])
    evaluation = expr.evaluate(final_evals)

    return (
        SumcheckProof(num_vars=num_vars, claimed_sum=claimed_sum % R,
                      r_polys=output_r_polys),
        EvaluationClaim(point=evaluation_point, evaluation=evaluation),
    )


def verify(proof: SumcheckProof, transcript: Transcript,
           max_degree: int | None = None) -> EvaluationClaim:
    """`SumcheckProof::verify` (`sumcheck.rs:116-150`).  Raises ValueError on
    failure (the Rust `Result<_, String>` contract).

    Compat note: like the reference, the per-round degree of the received
    polynomials is *not* bounds-checked by default (flagged soundness gap,
    SURVEY §7) -- our prover must satisfy the reference verifier and vice
    versa, so default behavior matches.  Pass `max_degree` to enforce the
    bound; callers (zerocheck / multiset / HyperPlonk) derive it from the
    circuit's expression degrees under QUILL_STRICT_VERIFY / strict=True.
    The check is transcript-invisible (serialized bytes do not change).
    """
    transcript.append_usize(proof.num_vars)
    transcript.append_field(proof.claimed_sum % R)

    v = proof.claimed_sum % R
    evaluation_point: list[int] = []

    if max_degree is not None:
        for coeffs in proof.r_polys:
            if len(coeffs) > max_degree + 1:
                raise ValueError("Sumcheck round polynomial exceeds degree bound")
        if len(proof.r_polys) != proof.num_vars:
            raise ValueError("Sumcheck round count does not match num_vars")

    for coeffs in proof.r_polys:
        eval_at_0 = poly_eval_host(coeffs, 0)
        eval_at_1 = poly_eval_host(coeffs, 1)
        if (eval_at_0 + eval_at_1) % R != v:
            raise ValueError("Sumcheck polynomial does not sum to previous value")
        transcript.append_dense_poly(coeffs)
        r = transcript.draw_field_element()
        evaluation_point.append(r)
        v = poly_eval_host(coeffs, r)

    return EvaluationClaim(point=evaluation_point, evaluation=v)
