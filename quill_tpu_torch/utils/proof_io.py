"""Proof (de)serialization: ark-serialize-style uncompressed wire format.

The reference never serializes proofs (no serde anywhere; SURVEY §5) -- this
module defines the byte format using exactly the ark-serialize 0.5 element
encodings the transcript already uses (`transcript/serialize.py`), so every
field element is 32 LE bytes, every G1 point 64 bytes with SW flags, and
every vector is u64-LE-length-prefixed.
"""

from __future__ import annotations

import io

from ..ec import curve
from ..pcs.kzg import KZGOpeningProof
from ..pcs.mlpcs import MLEvalProof
from ..piops import (lookup, multiset_check, permutation_check, set_inclusion,
                     sumcheck, zerocheck)
from ..proof import hyperplonk
from ..transcript import serialize as ser
from .profiling import phase

SW_INF = ser.SW_POINT_AT_INFINITY


def _w_usize(buf, n):
    buf.write(ser.ser_usize(n))


def _w_field(buf, x):
    buf.write(ser.ser_field(x))


def _w_g1(buf, pt):
    buf.write(ser.ser_g1(pt))


def _r_usize(buf) -> int:
    return int.from_bytes(buf.read(8), "little")


def _r_field(buf) -> int:
    return int.from_bytes(buf.read(32), "little")


def _r_g1(buf) -> curve.Jacobian:
    raw = buf.read(64)
    x = int.from_bytes(raw[:32], "little")
    y_raw = bytearray(raw[32:])
    flags = y_raw[31] & 0xC0
    y_raw[31] &= 0x3F
    y = int.from_bytes(bytes(y_raw), "little")
    if flags & SW_INF:
        return curve.Jacobian.identity(curve.Fq(1))
    pt = curve.Jacobian(curve.Fq(x), curve.Fq(y), curve.Fq(1))
    assert curve.g1_is_on_curve(pt.to_affine()), "point not on curve"
    return pt


def _w_kzg_opening(buf, op: KZGOpeningProof):
    _w_field(buf, op.x)
    _w_field(buf, op.y)
    _w_g1(buf, op.proof)


def _r_kzg_opening(buf) -> KZGOpeningProof:
    return KZGOpeningProof(x=_r_field(buf), y=_r_field(buf), proof=_r_g1(buf))


def _w_mleval(buf, pf: MLEvalProof):
    _w_usize(buf, len(pf.evaluation_point))
    for x in pf.evaluation_point:
        _w_field(buf, x)
    _w_field(buf, pf.evaluation)
    _w_g1(buf, pf.s_comm)
    for op in (pf.poly_opening, pf.poly_opening_inv, pf.s_opening,
               pf.s_opening_inv):
        _w_kzg_opening(buf, op)


def _r_mleval(buf) -> MLEvalProof:
    n = _r_usize(buf)
    point = [_r_field(buf) for _ in range(n)]
    evaluation = _r_field(buf)
    s_comm = _r_g1(buf)
    ops = [_r_kzg_opening(buf) for _ in range(4)]
    return MLEvalProof(evaluation_point=point, evaluation=evaluation,
                       s_comm=s_comm, poly_opening=ops[0],
                       poly_opening_inv=ops[1], s_opening=ops[2],
                       s_opening_inv=ops[3])


def _w_sumcheck(buf, pf: sumcheck.SumcheckProof):
    _w_usize(buf, pf.num_vars)
    _w_field(buf, pf.claimed_sum)
    _w_usize(buf, len(pf.r_polys))
    for poly in pf.r_polys:
        _w_usize(buf, len(poly))
        for c in poly:
            _w_field(buf, c)


def _r_sumcheck(buf) -> sumcheck.SumcheckProof:
    num_vars = _r_usize(buf)
    claimed = _r_field(buf)
    n = _r_usize(buf)
    polys = []
    for _ in range(n):
        k = _r_usize(buf)
        polys.append([_r_field(buf) for _ in range(k)])
    return sumcheck.SumcheckProof(num_vars=num_vars, claimed_sum=claimed,
                                  r_polys=polys)


def _w_multiset(buf, pf: multiset_check.MultisetEqualityProof):
    _w_g1(buf, pf.denom_left_commitment)
    _w_g1(buf, pf.denom_right_commitment)
    _w_sumcheck(buf, pf.sumcheck_proof)
    _w_mleval(buf, pf.opening_proof_denom_left)
    _w_mleval(buf, pf.opening_proof_denom_right)


def _r_multiset(buf) -> multiset_check.MultisetEqualityProof:
    return multiset_check.MultisetEqualityProof(
        denom_left_commitment=_r_g1(buf),
        denom_right_commitment=_r_g1(buf),
        sumcheck_proof=_r_sumcheck(buf),
        opening_proof_denom_left=_r_mleval(buf),
        opening_proof_denom_right=_r_mleval(buf),
    )


def serialize_proof(proof: hyperplonk.HyperPlonkProof) -> bytes:
    with phase("proof_io/serialize"):
        return _serialize_proof(proof)


def _serialize_proof(proof: hyperplonk.HyperPlonkProof) -> bytes:
    buf = io.BytesIO()
    _w_usize(buf, len(proof.witness_commitment))
    for c in proof.witness_commitment:
        _w_g1(buf, c)
    _w_usize(buf, len(proof.trace_proofs))
    for tp in proof.trace_proofs:
        _w_usize(buf, tp.zero_check_proof.num_vars)
        _w_sumcheck(buf, tp.zero_check_proof.sumcheck_proof)
        _w_multiset(buf, tp.permutation_check_proof.multiset_equality_proof)
        _w_usize(buf, len(tp.openings_zero_check))
        for op in tp.openings_zero_check:
            _w_mleval(buf, op)
        _w_usize(buf, len(tp.openings_public))
        for op in tp.openings_public:
            _w_mleval(buf, op)
        _w_mleval(buf, tp.opening_id)
        _w_mleval(buf, tp.opening_permutation)
        _w_mleval(buf, tp.opening_permutation_trace)
    if not proof.lookup_proofs:
        # omit the lookup section entirely: proofs without cross-table
        # lookups keep the round-1 wire bytes (deterministic hashes in
        # .claude/skills/verify/SKILL.md stay valid); the reader treats
        # EOF as zero lookups
        return buf.getvalue()
    _w_usize(buf, len(proof.lookup_proofs))
    for lp in proof.lookup_proofs:
        _w_g1(buf, lp.multiplicities_commitment)
        si = lp.lookup_proof.set_inclusion_proof
        _w_g1(buf, si.denom_left_commitment)
        _w_g1(buf, si.denom_right_commitment)
        _w_sumcheck(buf, si.sumcheck_proof_left)
        _w_sumcheck(buf, si.sumcheck_proof_right)
        _w_mleval(buf, si.opening_proof_denom_left)
        _w_mleval(buf, si.opening_proof_denom_right)
        _w_usize(buf, len(lp.src_openings))
        for op in lp.src_openings:
            _w_mleval(buf, op)
        _w_usize(buf, len(lp.dst_openings))
        for op in lp.dst_openings:
            _w_mleval(buf, op)
        _w_mleval(buf, lp.multiplicities_opening)
    return buf.getvalue()


def deserialize_proof(data: bytes) -> hyperplonk.HyperPlonkProof:
    buf = io.BytesIO(data)
    n_comm = _r_usize(buf)
    commitments = [_r_g1(buf) for _ in range(n_comm)]
    n_traces = _r_usize(buf)
    trace_proofs = []
    for _ in range(n_traces):
        zc_vars = _r_usize(buf)
        zc = zerocheck.ZeroCheckProof(num_vars=zc_vars,
                                      sumcheck_proof=_r_sumcheck(buf))
        perm = permutation_check.PermutationCheckProof(
            multiset_equality_proof=_r_multiset(buf))
        n_zc = _r_usize(buf)
        openings_zc = [_r_mleval(buf) for _ in range(n_zc)]
        n_pub = _r_usize(buf)
        openings_pub = [_r_mleval(buf) for _ in range(n_pub)]
        trace_proofs.append(hyperplonk.TraceProof(
            zero_check_proof=zc,
            permutation_check_proof=perm,
            openings_zero_check=openings_zc,
            openings_public=openings_pub,
            opening_id=_r_mleval(buf),
            opening_permutation=_r_mleval(buf),
            opening_permutation_trace=_r_mleval(buf),
        ))
    lookup_proofs = []
    raw_count = buf.read(8)
    if len(raw_count) not in (0, 8):
        # a 1-7 byte remainder is a truncated lookup-count field, not a
        # legacy lookup-free proof -- fail at deserialization rather than
        # relying on the downstream vk.lookups length cross-check
        raise ValueError("truncated lookup count in proof bytes")
    n_lookups = int.from_bytes(raw_count, "little") if raw_count else 0
    for _ in range(n_lookups):
        mult_comm = _r_g1(buf)
        si = set_inclusion.SetInclusionProof(
            denom_left_commitment=_r_g1(buf),
            denom_right_commitment=_r_g1(buf),
            sumcheck_proof_left=_r_sumcheck(buf),
            sumcheck_proof_right=_r_sumcheck(buf),
            opening_proof_denom_left=_r_mleval(buf),
            opening_proof_denom_right=_r_mleval(buf),
        )
        src_openings = [_r_mleval(buf) for _ in range(_r_usize(buf))]
        dst_openings = [_r_mleval(buf) for _ in range(_r_usize(buf))]
        lookup_proofs.append(hyperplonk.CrossTableLookupProof(
            multiplicities_commitment=mult_comm,
            lookup_proof=lookup.LookupProof(set_inclusion_proof=si),
            src_openings=src_openings,
            dst_openings=dst_openings,
            multiplicities_opening=_r_mleval(buf),
        ))
    return hyperplonk.HyperPlonkProof(witness_commitment=commitments,
                                      trace_proofs=trace_proofs,
                                      lookup_proofs=lookup_proofs)
