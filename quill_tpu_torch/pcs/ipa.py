"""Mercury-style inner-product argument over univariate KZG.

Counterpart of `quill-zkvm/pcs/src/ipa.rs`: proves <f, g> = v via
  h(x) = f(x) g(1/x) + f(1/x) g(x) = x S(x) + S(1/x)/x + 2v
with a commitment to S and six KZG openings (the reference keeps the openings
unbatched, `ipa.rs:86`; that layout is transcript-visible so we keep it too).

The S polynomial is extracted from h(x) * x^d = f * rev(g) + rev(f) * g
(`ipa.rs:114-157`) by `engine.s_polynomial`: one NTT product on the
device, two Kronecker big-int products on the host, instead of the
reference's O(d^2) naive products (`ipa.rs:147-148`).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ec import curve
from ..fields.bn254 import R
from ..fields.scalar import inv
from ..transcript.transcript import Transcript
from .kzg import KZG, KZGOpeningProof


@dataclass
class InnerProductProof:
    """`InnerProductProof` (`ipa.rs:40-53`)."""

    inner_product: int
    s_comm: curve.Jacobian
    f_opening: KZGOpeningProof
    f_opening_inv: KZGOpeningProof
    g_opening: KZGOpeningProof
    g_opening_inv: KZGOpeningProof
    s_opening: KZGOpeningProof
    s_opening_inv: KZGOpeningProof


def prove(engine, poly1, poly2, kzg: KZG, transcript: Transcript) -> InnerProductProof:
    """`InnerProductProof::prove` (`ipa.rs:59-112`).  ASSUMES commitments to
    the polynomials are already in the transcript."""
    inner_product = engine.inner(poly1, poly2)

    s_poly = engine.s_polynomial(poly1, poly2)
    s_commitment = kzg.commit(s_poly)

    transcript.append_field(inner_product)
    transcript.append_g1(s_commitment)

    r = transcript.draw_field_element()
    r_inv = inv(r, R)

    (f_opening, f_opening_inv, g_opening, g_opening_inv, s_opening,
     s_opening_inv) = kzg.open_many(
        [(poly1, r), (poly1, r_inv), (poly2, r), (poly2, r_inv),
         (s_poly, r), (s_poly, r_inv)])

    assert (f_opening.y * g_opening_inv.y + f_opening_inv.y * g_opening.y) % R == (
        r * s_opening.y + r_inv * s_opening_inv.y + 2 * inner_product) % R, \
        "Inner product verification equation failed"

    return InnerProductProof(
        inner_product=inner_product,
        s_comm=s_commitment,
        f_opening=f_opening,
        f_opening_inv=f_opening_inv,
        g_opening=g_opening,
        g_opening_inv=g_opening_inv,
        s_opening=s_opening,
        s_opening_inv=s_opening_inv,
    )


def verify(proof: InnerProductProof, comm1: curve.Jacobian, comm2: curve.Jacobian,
           kzg: KZG, transcript: Transcript) -> bool:
    """`InnerProductProof::verify` (`ipa.rs:160-203`)."""
    if not (kzg.verify_opening(comm1, proof.f_opening)
            and kzg.verify_opening(comm1, proof.f_opening_inv)
            and kzg.verify_opening(comm2, proof.g_opening)
            and kzg.verify_opening(comm2, proof.g_opening_inv)
            and kzg.verify_opening(proof.s_comm, proof.s_opening)
            and kzg.verify_opening(proof.s_comm, proof.s_opening_inv)):
        return False

    transcript.append_field(proof.inner_product)
    transcript.append_g1(proof.s_comm)
    r = transcript.draw_field_element()
    r_inv = inv(r, R)

    import os

    if os.environ.get("QUILL_STRICT_VERIFY"):
        # the reference accepts openings at any x (`ipa.rs:160-203` never
        # compares the opening points to the transcript draw); strict
        # mode pins them to r / 1/r
        if (proof.f_opening.x != r or proof.g_opening.x != r
                or proof.s_opening.x != r
                or proof.f_opening_inv.x != r_inv
                or proof.g_opening_inv.x != r_inv
                or proof.s_opening_inv.x != r_inv):
            return False

    return (proof.f_opening.y * proof.g_opening_inv.y
            + proof.f_opening_inv.y * proof.g_opening.y) % R == (
        r * proof.s_opening.y + r_inv * proof.s_opening_inv.y
        + 2 * proof.inner_product) % R
