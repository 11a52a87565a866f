"""Multilinear PCS over univariate KZG (Mercury-style).

Counterpart of `quill-zkvm/pcs/src/mlpcs.rs`: the multilinear polynomial
P (2^n hypercube evaluations, used as univariate coefficients) is committed
with KZG; an evaluation P(r) = v is the inner-product claim <f, P_r> with
  P_r(x) = prod_i (r_i x^{2^i} + 1 - r_i).

TPU-first shortcut (transcript-identical): the coefficient vector of P_r *is*
the eq(. , r) tensor table (coeff of x^j = eq(bin(j), r)), so we build it with
the O(2^n) doubling/tensor construction instead of the reference's n-point
evaluation + IFFT (`mlpcs.rs:68-78`) -- only S-commitment and openings reach
the transcript, and those are unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ec import curve
from ..fields.bn254 import R
from ..fields.scalar import inv
from ..transcript.transcript import Transcript
from . import EvaluationClaim
from .kzg import KZG, KZGOpeningProof


def eval_pr(r: list[int], x: int) -> int:
    """P_r(x) = prod_i (r_i x^{2^i} + 1 - r_i), O(n) (`mlpcs.rs:52-63`)."""
    result = 1
    x_pow = x % R
    for r_i in r:
        result = result * ((r_i * x_pow + 1 - r_i) % R) % R
        x_pow = x_pow * x_pow % R
    return result


@dataclass
class MLEvalProof:
    """`MLEvalProof` (`mlpcs.rs:32-44`)."""

    evaluation_point: list[int]
    evaluation: int
    s_comm: curve.Jacobian
    poly_opening: KZGOpeningProof
    poly_opening_inv: KZGOpeningProof
    s_opening: KZGOpeningProof
    s_opening_inv: KZGOpeningProof

    # MultilinearPCSProof interface (`pcs/src/lib.rs:15-24`)
    def point(self) -> list[int]:
        return list(self.evaluation_point)

    def evaluation_claim(self) -> EvaluationClaim:
        return EvaluationClaim(point=list(self.evaluation_point),
                               evaluation=self.evaluation)


class MultilinearPCS:
    """The `MultilinearPCS` impl for KZG (`mlpcs.rs:174-207`): the object the
    whole upper stack is generic over."""

    def __init__(self, kzg: KZG):
        self.kzg = kzg
        self.engine = kzg.engine

    def max_degree(self) -> int:
        return self.kzg.max_degree

    def commit(self, poly) -> curve.Jacobian:
        return self.kzg.commit(poly)

    def commit_many(self, polys: list) -> list:
        """Adjacent commitments (no transcript events in between) as one
        fused multi-MSM."""
        return self.kzg.commit_many(polys)

    def open(self, poly, eval_point: list[int], transcript: Transcript) -> MLEvalProof:
        """`MLEvalProof::prove` (`mlpcs.rs:83-124`).  ASSUMES the commitment
        is already in the transcript."""
        from ..utils.profiling import phase

        engine = self.engine
        with phase("mlpcs/eq_table"):
            pr = engine.eq_table(eval_point)  # == compute_pr coefficients
        with phase("mlpcs/inner"):
            evaluation = engine.inner(poly, pr)

        with phase("mlpcs/s_poly"):
            s_poly = engine.s_polynomial(poly, pr)
        with phase("mlpcs/s_commit"):
            s_commitment = self.kzg.commit(s_poly)

        transcript.append_field_vec(eval_point)
        transcript.append_field(evaluation)
        transcript.append_g1(s_commitment)

        r = transcript.draw_field_element()
        r_inv = inv(r, R)

        with phase("mlpcs/kzg_open_x4"):
            (poly_opening, poly_opening_inv, s_opening,
             s_opening_inv) = self.kzg.open_many(
                [(poly, r), (poly, r_inv), (s_poly, r), (s_poly, r_inv)])

        return MLEvalProof(
            evaluation_point=[x % R for x in eval_point],
            evaluation=evaluation,
            s_comm=s_commitment,
            poly_opening=poly_opening,
            poly_opening_inv=poly_opening_inv,
            s_opening=s_opening,
            s_opening_inv=s_opening_inv,
        )

    def open_many(self, items: list, transcript: Transcript) -> list:
        """Batch of opens [(poly, eval_point), ...] with no transcript
        events in between the KZG openings.  Byte-identical to sequential
        `open` calls: per item, the transcript sees (point, evaluation,
        s_comm) then draws r -- and since KZG openings never touch the
        transcript, ALL 4*k of them defer to one fused `kzg.open_many`
        (one stacked quotient pass + one multi-MSM), and the k
        S-commitments fuse into one `commit_many`.  Items sharing an
        evaluation point also share one eq-tensor table.

        This is the round-4 opening-phase cut (VERDICT #6): the multiset
        denominator pair and the permutation-phase (id, perm, witness)
        triple each collapse from k sequential pipelines into one."""
        from ..utils.profiling import phase

        engine = self.engine
        pr_cache: dict = {}
        # free each eq table at its LAST use, not after the whole item
        # loop: with distinct points the old clear-at-end held one
        # full-size eq table per item alongside every S-poly
        uses: dict = {}
        for _, point in items:
            key = tuple(x % R for x in point)
            uses[key] = uses.get(key, 0) + 1

        def pr_for(point):
            key = tuple(x % R for x in point)
            if key not in pr_cache:
                with phase("mlpcs/eq_table"):
                    pr_cache[key] = engine.eq_table(list(point))
            return pr_cache[key]

        evals, s_polys = [], []
        for poly, point in items:
            pr = pr_for(point)
            with phase("mlpcs/inner"):
                evals.append(engine.inner(poly, pr))
            with phase("mlpcs/s_poly"):
                s_polys.append(engine.s_polynomial(poly, pr))
            key = tuple(x % R for x in point)
            uses[key] -= 1
            if uses[key] == 0:
                del pr_cache[key]
            del pr
        pr_cache.clear()
        with phase("mlpcs/s_commit"):
            s_comms = self.kzg.commit_many(s_polys)

        jobs = []
        for (poly, point), evaluation, s_comm, s_poly in zip(
                items, evals, s_comms, s_polys):
            transcript.append_field_vec(point)
            transcript.append_field(evaluation)
            transcript.append_g1(s_comm)
            r = transcript.draw_field_element()
            r_inv = inv(r, R)
            jobs.extend([(poly, r), (poly, r_inv), (s_poly, r),
                         (s_poly, r_inv)])

        with phase("mlpcs/kzg_open_x4"):
            opens = self.kzg.open_many(jobs)

        out = []
        for i, ((poly, point), evaluation, s_comm) in enumerate(
                zip(items, evals, s_comms)):
            po, poi, so, soi = opens[4 * i:4 * i + 4]
            out.append(MLEvalProof(
                evaluation_point=[x % R for x in point],
                evaluation=evaluation,
                s_comm=s_comm,
                poly_opening=po,
                poly_opening_inv=poi,
                s_opening=so,
                s_opening_inv=soi,
            ))
        return out

    def verify(self, commitment: curve.Jacobian, proof: MLEvalProof,
               transcript: Transcript) -> bool:
        """`MLEvalProof::verify` (`mlpcs.rs:126-161`)."""
        transcript.append_field_vec(proof.evaluation_point)
        transcript.append_field(proof.evaluation)
        transcript.append_g1(proof.s_comm)

        r = transcript.draw_field_element()
        r_inv = inv(r, R)

        import os

        if os.environ.get("QUILL_STRICT_VERIFY"):
            # The reference never checks the openings' claimed x against
            # the transcript draw (`quill-zkvm/pcs/src/mlpcs.rs:
            # 142-149`), so the pairing checks accept openings at ANY
            # point; default mode keeps that compat, strict mode pins
            # x to r / 1/r.
            if (proof.poly_opening.x != r
                    or proof.poly_opening_inv.x != r_inv
                    or proof.s_opening.x != r
                    or proof.s_opening_inv.x != r_inv):
                return False

        checks = {
            "poly@r": self.kzg.verify_opening(commitment, proof.poly_opening),
            "poly@1/r": self.kzg.verify_opening(commitment,
                                                proof.poly_opening_inv),
            "s@r": self.kzg.verify_opening(proof.s_comm, proof.s_opening),
            "s@1/r": self.kzg.verify_opening(proof.s_comm,
                                             proof.s_opening_inv),
        }
        if not all(checks.values()):
            if os.environ.get("QUILL_DEBUG_PCS"):
                import sys

                print(f"[mlpcs.verify] KZG opening failures: "
                      f"{[k for k, v in checks.items() if not v]}; "
                      f"r={r}", file=sys.stderr, flush=True)
            return False

        pr_r = eval_pr(proof.evaluation_point, r)
        pr_r_inv = eval_pr(proof.evaluation_point, r_inv)

        lhs = (proof.poly_opening.y * pr_r_inv + proof.poly_opening_inv.y * pr_r) % R
        rhs = (r * proof.s_opening.y + r_inv * proof.s_opening_inv.y
               + 2 * proof.evaluation) % R
        if lhs != rhs and os.environ.get("QUILL_DEBUG_PCS"):
            import sys

            print("[mlpcs.verify] Mercury equation mismatch", file=sys.stderr,
                  flush=True)
        return lhs == rhs
