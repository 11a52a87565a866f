"""HyperPlonk multi-table SNARK: preprocess / prove / verify.

Counterpart of `quill-zkvm/hyperplonk/src/proof/proof.rs`.  One
transcript (domain b"hyperplonk_proof") spans all traces; per trace the prover
runs a zero-check over the alpha-batched constraint expressions (log2(rows)
variables), a permutation check over the whole rows*cols-cell trace as one
polynomial, and opens the witness / public columns / id / permutation at the
returned points.  Transcript event order matches the reference exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fields.bn254 import R
from ..piops import lookup as lookup_piop
from ..piops import permutation_check, zerocheck
from ..piops.virtual_poly import Const, Store
from ..transcript.transcript import Transcript
from ..utils.profiling import phase
from .circuit import Circuit

DOMAIN = b"hyperplonk_proof"


@dataclass
class CrossTableLookup:
    """Cross-table lookup argument: every row-tuple of `src_cols` in trace
    `src_trace` must appear among the row-tuples of `dst_cols` in trace
    `dst_trace`.

    Growth beyond reference parity: the reference ships the lookup PIOP
    (`quill-zkvm/hyperplonk/src/piops/lookup.rs`) but never wires it
    into the HyperPlonk proof ("cross-table lookups" unchecked in
    `quill-zkvm/README.md:21`).  Column indices refer to witness
    columns; the two traces may have different row counts (set-inclusion
    over different hypercube sizes)."""

    src_trace: int
    src_cols: list[int]
    dst_trace: int
    dst_cols: list[int]


@dataclass
class CrossTableLookupProof:
    """Proof material for one `CrossTableLookup`: the multiplicities
    commitment (bound to the transcript BEFORE the logup challenge is
    drawn), the lookup PIOP proof, and the openings that discharge the
    per-column evaluation claims against the trace witness commitments."""

    multiplicities_commitment: object
    lookup_proof: lookup_piop.LookupProof
    src_openings: list
    dst_openings: list
    multiplicities_opening: object


@dataclass
class TraceProof:
    """`TraceProof` (`proof.rs:17-25`)."""

    zero_check_proof: zerocheck.ZeroCheckProof
    permutation_check_proof: permutation_check.PermutationCheckProof
    openings_zero_check: list
    openings_public: list
    opening_id: object
    opening_permutation: object
    opening_permutation_trace: object


@dataclass
class HyperPlonkProof:
    """`HyperPlonkProof` (`proof.rs:27-30`), extended with the cross-table
    lookup section (empty when no lookups are configured)."""

    witness_commitment: list
    trace_proofs: list[TraceProof]
    lookup_proofs: list[CrossTableLookupProof] = field(default_factory=list)


@dataclass
class TraceVK:
    """`TraceVK` (`proof.rs:32-37`)."""

    circuit: Circuit
    public_columns_commitments: list
    id_commitment: object
    permutation_commitment: object


@dataclass
class TracePK:
    """`TracePK` (`proof.rs:50-54`)."""

    id_poly: object          # engine vec, rows*cols cells
    permutation_poly: object
    public_values: list      # engine vecs, one a public column, rows cells:
    # the zero check's store and the public openings read them


@dataclass
class HyperPlonkVK:
    """`HyperPlonkVK` (`proof.rs:56-58`), plus the cross-table lookup
    configuration (statement-level, fixed at preprocess time)."""

    trace_vks: list[TraceVK]
    lookups: list[CrossTableLookup] = field(default_factory=list)


@dataclass
class TraceWitness:
    """`TraceWitness` (`proof.rs:60`): list of witness columns."""

    columns: list[list[int]]


class HyperPlonk:
    """`HyperPlonk { trace_vks, trace_pks }` (`proof.rs:12-15`)."""

    def __init__(self, trace_vks: list[TraceVK], trace_pks: list[TracePK], pcs,
                 lookups: list[CrossTableLookup] | None = None):
        self.trace_vks = trace_vks
        self.trace_pks = trace_pks
        self.pcs = pcs
        self.lookups = list(lookups or [])
        # lookups proved, and their source and table rows, over every prove
        self.lookup_counts = dict.fromkeys(
            ("lookups", "source_rows", "table_rows"), 0)
        # witness values converted to engine vectors, and traces whose
        # constraints were checked on the device and on the host, over
        # every prove
        self.witness_counts = dict.fromkeys(
            ("values_uploaded", "device_checks", "host_checks"), 0)

    # -- preprocess ---------------------------------------------------------

    @staticmethod
    def _preprocess_trace(circuit: Circuit, pcs) -> tuple[TracePK, TraceVK]:
        """`preprocess_trace` (`proof.rs:63-122`)."""
        engine = pcs.engine
        rows, cols = circuit.num_rows(), circuit.num_cols()
        assert rows & (rows - 1) == 0, "Number of rows must be a power of two"
        assert cols & (cols - 1) == 0, "Number of columns must be a power of two"
        trace_size = rows * cols

        public_values, public_padded = [], []
        for col in circuit.public_values():
            assert len(col) == rows, "Public column length mismatch"
            vec = engine.vec_from_ints(col)
            public_values.append(vec)
            public_padded.append(engine.pad(vec, trace_size))

        id_evals, permutation_evals = circuit.permutation()
        assert len(id_evals) == trace_size, "ID polynomial length mismatch"
        assert len(permutation_evals) == trace_size, \
            "Permutation polynomial length mismatch"
        id_vec = engine.vec_from_ints(id_evals)
        perm_vec = engine.vec_from_ints(permutation_evals)

        # all preprocessing commitments in one fused multi-MSM batch
        *public_commitments, id_commitment, permutation_commitment = \
            pcs.commit_many(public_padded + [id_vec, perm_vec])

        vk = TraceVK(circuit=circuit,
                     public_columns_commitments=public_commitments,
                     id_commitment=id_commitment,
                     permutation_commitment=permutation_commitment)
        pk = TracePK(id_poly=id_vec, permutation_poly=perm_vec,
                     public_values=public_values)
        return pk, vk

    @staticmethod
    def preprocess(circuits: list[Circuit], pcs,
                   lookups: list[CrossTableLookup] | None = None
                   ) -> "HyperPlonk":
        """`preprocess` (`proof.rs:124-137`), plus validation of the
        cross-table lookup configuration."""
        pks, vks = [], []
        for circuit in circuits:
            pk, vk = HyperPlonk._preprocess_trace(circuit, pcs)
            pks.append(pk)
            vks.append(vk)
        for lk in (lookups or []):
            assert len(lk.src_cols) == len(lk.dst_cols) > 0, \
                "Lookup column lists must be non-empty and the same length"
            for t, cols in ((lk.src_trace, lk.src_cols),
                            (lk.dst_trace, lk.dst_cols)):
                assert 0 <= t < len(circuits), "Lookup trace index out of range"
                assert all(0 <= c < circuits[t].num_cols() for c in cols), \
                    "Lookup column index out of range"
        return HyperPlonk(trace_vks=vks, trace_pks=pks, pcs=pcs,
                          lookups=lookups)

    def to_vk(self) -> HyperPlonkVK:
        return HyperPlonkVK(trace_vks=list(self.trace_vks),
                            lookups=list(self.lookups))

    # -- prove --------------------------------------------------------------

    def _prove_trace(self, witness: list[list[int]], full_witness,
                     columns: list | None, transcript: Transcript,
                     pk: TracePK, circuit: Circuit) -> TraceProof:
        """`prove_trace` (`proof.rs:145-237`).  `columns`: the witness
        columns as views of `full_witness`, or None where they are
        converted from `witness` here (host vectors)."""
        pcs = self.pcs
        engine = pcs.engine
        rows, cols = circuit.num_rows(), circuit.num_cols()
        log2_rows = rows.bit_length() - 1
        log2_cols = cols.bit_length() - 1

        store = Store(engine, log2_rows)
        with phase("prove/witness_upload"):
            for column in (witness if columns is None else columns):
                store.allocate_polynomial(column)
            for public in pk.public_values:
                store.allocate_polynomial(public)

        # alpha-batch all constraints (`proof.rs:166-175`)
        with phase("prove/zerocheck_expr"):
            exprs = circuit.zero_check_expressions()
            alpha = transcript.draw_field_element()
            zero_check_expr = Const(0)
            a = 1
            for expr in exprs:
                zero_check_expr = zero_check_expr + Const(a) * expr
                a = a * alpha % R
            zero_check_virtual = store.new_virtual_from_expr(zero_check_expr)

        with phase("prove/zerocheck"):
            zero_check_proof, zc_claim = zerocheck.prove(
                store, zero_check_virtual, transcript)

        # permutation check on the whole trace as one polynomial
        # (`proof.rs:183-196`)
        store2 = Store(engine, log2_rows + log2_cols)
        witness_ref = store2.allocate_polynomial(full_witness)
        witness_virtual = store2.new_virtual_from_input(witness_ref)

        with phase("prove/permutation_check"):
            perm_proof, perm_point = permutation_check.prove(
                store2, witness_virtual, witness_virtual,
                pk.id_poly, pk.permutation_poly, transcript, pcs)

        # witness openings at the zero-check point extended with column bits
        # (`proof.rs:202-210`); fused in memory-bounded groups (each open
        # holds a full-size S-poly, so the group size caps peak HBM)
        with phase("prove/witness_openings"):
            items = []
            for col in range(cols):
                point = list(zc_claim.point)
                for i in range(log2_cols):
                    point.append((col >> i) & 1)
                items.append((full_witness, point))
            openings_zero_check = _open_grouped(pcs, items, transcript)

        # public-column openings at the zero-check point (`proof.rs:213-219`)
        with phase("prove/public_openings"):
            openings_public = _open_grouped(
                pcs, [(public, list(zc_claim.point))
                      for public in pk.public_values], transcript)

        # id / permutation / trace openings at the permutation-check point
        # (`proof.rs:222-226`): one fused pipeline, shared eq table
        with phase("prove/id_perm_trace_openings"):
            (opening_id, opening_permutation,
             opening_permutation_trace) = _open_grouped(
                pcs, [(pk.id_poly, perm_point),
                      (pk.permutation_poly, perm_point),
                      (full_witness, perm_point)], transcript)

        return TraceProof(
            zero_check_proof=zero_check_proof,
            permutation_check_proof=perm_proof,
            openings_zero_check=openings_zero_check,
            openings_public=openings_public,
            opening_id=opening_id,
            opening_permutation=opening_permutation,
            opening_permutation_trace=opening_permutation_trace,
        )

    def _prove_lookup(self, lk: CrossTableLookup,
                      witness_traces: list[TraceWitness], full_traces,
                      columns: list, transcript: Transcript
                      ) -> CrossTableLookupProof:
        """One cross-table lookup argument.  Transcript event order (ours to
        define -- the reference never wires lookups in):
          1. multiplicities commitment (before the logup challenge draw);
          2. the lookup PIOP (`lookup.rs:28-83` event order);
          3. source-column openings of the source trace witness (column
             order), destination-column openings, multiplicities opening.
        The prover does NOT pre-check inclusion: a witness violating the
        lookup yields an honest proof that fails verification (same posture
        as the reference's multiset tests, `multiset_check.rs:404`).
        `columns[t]`: trace t's columns as views of `full_traces[t]`, or
        None where they are converted from the witness here."""
        pcs = self.pcs
        engine = pcs.engine
        src_circ = self.trace_vks[lk.src_trace].circuit
        dst_circ = self.trace_vks[lk.dst_trace].circuit
        src_cols = [witness_traces[lk.src_trace].columns[c]
                    for c in lk.src_cols]
        dst_cols = [witness_traces[lk.dst_trace].columns[c]
                    for c in lk.dst_cols]
        n_src, n_dst = src_circ.num_rows(), dst_circ.num_rows()

        with phase("prove/lookup_multiplicities"):
            # multiplicities: count each source tuple at its FIRST matching
            # destination row (duplicate destination tuples carry zero)
            first_at: dict = {}
            for j in range(n_dst):
                key = tuple(col[j] % R for col in dst_cols)
                first_at.setdefault(key, j)
            mult = [0] * n_dst
            for i in range(n_src):
                key = tuple(col[i] % R for col in src_cols)
                j = first_at.get(key)
                if j is not None:
                    mult[j] += 1

            src_store = Store(engine, n_src.bit_length() - 1)
            dst_store = Store(engine, n_dst.bit_length() - 1)
            src_refs = [src_store.new_virtual_from_input(
                src_store.allocate_polynomial(col)) for col in _trace_columns(
                    columns[lk.src_trace], src_cols, lk.src_cols)]
            dst_refs = [dst_store.new_virtual_from_input(
                dst_store.allocate_polynomial(col)) for col in _trace_columns(
                    columns[lk.dst_trace], dst_cols, lk.dst_cols)]
            mult_vec = engine.vec_from_ints(mult)
            mult_ref = dst_store.new_virtual_from_input(
                dst_store.allocate_polynomial(mult_vec))

        with phase("prove/lookup_commit"):
            mult_commitment = pcs.commit(mult_vec)
        transcript.append_g1(mult_commitment)

        with phase("prove/lookup_piop"):
            lk_proof, points = lookup_piop.prove(
                src_store, src_refs, dst_store, dst_refs, mult_ref,
                transcript, pcs)

        log2_cols_src = src_circ.num_cols().bit_length() - 1
        log2_cols_dst = dst_circ.num_cols().bit_length() - 1
        with phase("prove/lookup_openings"):
            src_openings = _open_grouped(
                pcs, [(full_traces[lk.src_trace],
                       _extend_point(points.left, c, log2_cols_src))
                      for c in lk.src_cols], transcript)
            dst_items = [(full_traces[lk.dst_trace],
                          _extend_point(points.right, c, log2_cols_dst))
                         for c in lk.dst_cols]
            *dst_openings, mult_opening = _open_grouped(
                pcs, dst_items + [(mult_vec, list(points.right))],
                transcript)

        counts = self.lookup_counts
        counts["lookups"] += 1
        counts["source_rows"] += n_src
        counts["table_rows"] += n_dst
        return CrossTableLookupProof(
            multiplicities_commitment=mult_commitment,
            lookup_proof=lk_proof,
            src_openings=src_openings,
            dst_openings=dst_openings,
            multiplicities_opening=mult_opening,
        )

    def prove(self, witness_traces: list[TraceWitness]) -> HyperPlonkProof:
        """`prove` (`proof.rs:239-301`), in the span `prove`: the root of
        the prove's spans."""
        with phase("prove"):
            return self._prove(witness_traces)

    def _prove(self, witness_traces: list[TraceWitness]) -> HyperPlonkProof:
        pcs = self.pcs
        engine = pcs.engine
        transcript = Transcript(DOMAIN)

        counts = self.witness_counts
        full_traces, columns = [], []
        for trace_witness, vk in zip(witness_traces, self.trace_vks):
            witness = trace_witness.columns
            circuit = vk.circuit
            rows = circuit.num_rows()
            assert len(witness) == circuit.num_cols(), "Witness columns length mismatch"
            for col in witness:
                assert len(col) == rows, "Witness column row length mismatch"

            # column-major flattening (`proof.rs:270`), converted once: every
            # reader of the witness in this prove reads this vector or a
            # view of one of its columns
            with phase("prove/witness_upload"):
                flat: list[int] = []
                for col in witness:
                    flat.extend(col)
                full = engine.vec_from_ints(flat)
                counts["values_uploaded"] += len(flat)
                views = _column_views(engine, full, rows, len(witness))
            full_traces.append(full)
            columns.append(views)

            with phase("prove/check_constraints"):
                device_check = getattr(circuit, "check_constraints_device",
                                       None)
                if views is not None and device_check is not None:
                    counts["device_checks"] += 1
                    device_check(engine, views, witness)
                else:
                    counts["host_checks"] += 1
                    circuit.check_constraints(witness)

        # the per-trace appends (`proof.rs:279-280`) only interleave
        # appends, never draws, so all witness commitments batch into one
        # fused multi-MSM with an unchanged transcript
        with phase("prove/witness_commit"):
            trace_commitments = pcs.commit_many(full_traces)
        for witness_commitment in trace_commitments:
            transcript.append_g1(witness_commitment)

        trace_proofs = []
        for i, trace_witness in enumerate(witness_traces):
            trace_proofs.append(self._prove_trace(
                trace_witness.columns, full_traces[i], columns[i],
                transcript, self.trace_pks[i], self.trace_vks[i].circuit))

        lookup_proofs = [self._prove_lookup(lk, witness_traces, full_traces,
                                            columns, transcript)
                         for lk in self.lookups]

        return HyperPlonkProof(witness_commitment=trace_commitments,
                               trace_proofs=trace_proofs,
                               lookup_proofs=lookup_proofs)


# -- verification ------------------------------------------------------------


def _open_grouped(pcs, items: list, transcript) -> list:
    """Run `pcs.open_many` over `items` in memory-bounded groups.

    Peak residency per group of bs opens (all full-size n-vectors): bs
    S-polynomials live for the whole group, plus at most ONE eq table
    during the S-poly loop (freed at last use inside `mlpcs.open_many`),
    plus the quotient vectors of the KZG stage -- 4*bs in the fully fused
    path, capped at 4 above 2^22 elements by `kzg.open_many`'s sub-group
    split.  So: ~bs+4 full vectors at scale, ~5*bs below the split
    (bs=8 at 2^20 = ~40 x 88 MB = 3.5 GB, fine beside the ~2-3 GB
    resident bases on a 16 GB chip).  8 opens per group up to
    2^20-element polys, 2 above (the 2^23-cell scale campaign ceiling).
    Group boundaries are transcript-invisible (the fused pipeline is
    byte-identical to sequential opens)."""
    if not items:
        return []
    num_vars = max(len(point) for _, point in items)
    bs = 8 if num_vars <= 20 else 2
    out = []
    for i in range(0, len(items), bs):
        out.extend(pcs.open_many(items[i:i + bs], transcript))
    return out


def _column_views(engine, full, rows: int, cols: int) -> list | None:
    """Column c of a column-major trace, `full[c * rows:(c + 1) * rows]`,
    as a view that shares `full`'s storage, for each column; None where
    the engine has no such views or the columns are below its device
    size (they are then converted from the witness as host vectors)."""
    views = [engine.view(full, c * rows, (c + 1) * rows)
             for c in range(cols)]
    return None if any(v is None for v in views) else views


def _trace_columns(views: list | None, lists: list, cols: list[int]) -> list:
    """The columns `cols` of a trace: its views where it has them, else
    the witness's lists (`lists`, in the order of `cols`)."""
    return lists if views is None else [views[c] for c in cols]


def _extend_point(point: list[int], col: int, log2_cols: int) -> list[int]:
    """Row-variable point extended with the column-index bits (LSB first),
    selecting column `col` of the column-major flattened trace
    (`proof.rs:204-207` layout)."""
    out = list(point)
    for i in range(log2_cols):
        out.append((col >> i) & 1)
    return out


def _verify_opening(comm, proof, expected_point, expected_num_vars, pcs,
                    transcript) -> bool:
    """`verify_opening` (`proof.rs:305-325`)."""
    if len(proof.point()) != expected_num_vars:
        return False
    if expected_point is not None and proof.point() != expected_point:
        return False
    return pcs.verify(comm, proof, transcript)


def _get_and_verify_column_evaluations(vk: TraceVK, pcs, proof: TraceProof,
                                       witness_commitment, zc_claim,
                                       log2_cols, log2_rows, transcript
                                       ) -> list[int]:
    """`get_and_verify_column_evaluations` (`proof.rs:330-385`)."""
    if len(zc_claim.point) != log2_rows:
        raise ValueError("Zero check evaluation claim point length mismatch")

    points = []
    for col in range(vk.circuit.num_cols()):
        point = list(zc_claim.point)
        for i in range(log2_cols):
            point.append((col >> i) & 1)
        points.append(point)

    col_evaluations = []
    for i, opening in enumerate(proof.openings_zero_check):
        if opening.point() != points[i]:
            raise ValueError("Zero check opening point mismatch")
        if not pcs.verify(witness_commitment, opening, transcript):
            raise ValueError("Zero check opening verification failed")
        col_evaluations.append(opening.evaluation)

    for i, op in enumerate(proof.openings_public):
        if not _verify_opening(vk.public_columns_commitments[i], op,
                               list(zc_claim.point), log2_rows, pcs, transcript):
            raise ValueError("Public opening verification failed")
        col_evaluations.append(op.evaluation)

    return col_evaluations


def _recover_zerocheck_expr_evaluation(vk: TraceVK, col_evaluations, alpha) -> int:
    """`recover_zerocheck_expr_evaluation` (`proof.rs:387-402`)."""
    total = 0
    a = 1
    for expr in vk.circuit.zero_check_expressions():
        total = (total + a * expr.evaluate(col_evaluations)) % R
        a = a * alpha % R
    return total


def _verify_trace_proof(witness_commitment, vk: TraceVK, pcs,
                        proof: TraceProof, transcript,
                        strict: bool = False) -> None:
    """`verify_trace_proof` (`proof.rs:404-491`).

    strict: additionally enforce sumcheck round-polynomial degree bounds
    derived from the circuit (the reference verifier never bounds them,
    `sumcheck.rs:116-150` -- a flagged soundness gap).  Transcript-invisible
    either way."""
    alpha = transcript.draw_field_element()

    zc_bound = None
    if strict:
        # alpha-batched circuit expressions times the zerocheck eq factor
        zc_bound = max((e.degree() for e in
                        vk.circuit.zero_check_expressions()), default=0) + 1
    zc_claim = zerocheck.verify(proof.zero_check_proof, transcript,
                                max_degree=zc_bound)
    log2_cols = vk.circuit.num_cols().bit_length() - 1
    log2_rows = vk.circuit.num_rows().bit_length() - 1

    if len(zc_claim.point) != log2_rows:
        raise ValueError("Zero check evaluation claim point length mismatch")

    id_claim = proof.opening_id.evaluation_claim()
    perm_claim = proof.opening_permutation.evaluation_claim()
    trace_claim = proof.opening_permutation_trace.evaluation_claim()

    permutation_check.verify(
        proof.permutation_check_proof, transcript, pcs,
        trace_claim, trace_claim, id_claim, perm_claim, strict=strict)

    col_evaluations = _get_and_verify_column_evaluations(
        vk, pcs, proof, witness_commitment, zc_claim, log2_cols, log2_rows,
        transcript)

    recomputed = _recover_zerocheck_expr_evaluation(vk, col_evaluations, alpha)
    if recomputed != zc_claim.evaluation % R:
        raise ValueError("Zero check evaluation mismatch")

    if not _verify_opening(vk.id_commitment, proof.opening_id, None,
                           log2_rows + log2_cols, pcs, transcript):
        raise ValueError("ID commitment opening verification failed")
    if not _verify_opening(vk.permutation_commitment, proof.opening_permutation,
                           None, log2_rows + log2_cols, pcs, transcript):
        raise ValueError("Permutation commitment opening verification failed")
    if not _verify_opening(witness_commitment, proof.opening_permutation_trace,
                           None, log2_rows + log2_cols, pcs, transcript):
        raise ValueError("Permutation trace commitment opening verification failed")


def _verify_lookup(lk: CrossTableLookup, lkp: CrossTableLookupProof,
                   vk: HyperPlonkVK, witness_commitments, pcs,
                   transcript) -> None:
    """Mirror of `HyperPlonk._prove_lookup`: replay the transcript events in
    the same order, building the per-column claims from the proof's opening
    objects (verified right after, the `_verify_trace_proof` pattern)."""
    from ..pcs import EvaluationClaim

    src_circ = vk.trace_vks[lk.src_trace].circuit
    dst_circ = vk.trace_vks[lk.dst_trace].circuit
    log2_rows_src = src_circ.num_rows().bit_length() - 1
    log2_rows_dst = dst_circ.num_rows().bit_length() - 1
    log2_cols_src = src_circ.num_cols().bit_length() - 1
    log2_cols_dst = dst_circ.num_cols().bit_length() - 1

    if (len(lkp.src_openings) != len(lk.src_cols)
            or len(lkp.dst_openings) != len(lk.dst_cols)):
        raise ValueError("Lookup opening count mismatch")

    transcript.append_g1(lkp.multiplicities_commitment)

    # claim stems: the row-variable prefixes of the opening points
    def stem(opening, log2_rows, log2_cols, col):
        pt = opening.point()
        if len(pt) != log2_rows + log2_cols:
            raise ValueError("Lookup opening point length mismatch")
        if pt != _extend_point(pt[:log2_rows], col, log2_cols):
            raise ValueError("Lookup opening column bits mismatch")
        return pt[:log2_rows]

    src_stems = [stem(op, log2_rows_src, log2_cols_src, c)
                 for op, c in zip(lkp.src_openings, lk.src_cols)]
    dst_stems = [stem(op, log2_rows_dst, log2_cols_dst, c)
                 for op, c in zip(lkp.dst_openings, lk.dst_cols)]

    mult_claim = lkp.multiplicities_opening.evaluation_claim()
    if len(mult_claim.point) != log2_rows_dst:
        raise ValueError("Lookup multiplicities point length mismatch")

    claims = lookup_piop.LookupEvaluationClaims(
        source_claims=[EvaluationClaim(point=s, evaluation=op.evaluation)
                       for s, op in zip(src_stems, lkp.src_openings)],
        dests_claims=[EvaluationClaim(point=s, evaluation=op.evaluation)
                      for s, op in zip(dst_stems, lkp.dst_openings)],
        multiplicities_claim=mult_claim,
    )
    lookup_piop.verify(lkp.lookup_proof, transcript, pcs, claims)

    for op in lkp.src_openings:
        if not pcs.verify(witness_commitments[lk.src_trace], op, transcript):
            raise ValueError("Lookup source opening verification failed")
    for op in lkp.dst_openings:
        if not pcs.verify(witness_commitments[lk.dst_trace], op, transcript):
            raise ValueError("Lookup destination opening verification failed")
    if not pcs.verify(lkp.multiplicities_commitment,
                      lkp.multiplicities_opening, transcript):
        raise ValueError("Lookup multiplicities opening verification failed")


def verify(proof: HyperPlonkProof, vk: HyperPlonkVK, pcs,
           batch_pairings: bool | None = None,
           strict: bool | None = None) -> None:
    """`HyperPlonkProof::verify` (`proof.rs:493-522`).  Raises ValueError on
    failure.

    batch_pairings (default: env QUILL_BATCH_PAIRINGS, else off): defer all
    KZG pairing checks and settle them in one random-linear-combination
    multi-pairing at the end -- transcript-invisible, ~10x fewer pairings.

    strict (default: env QUILL_STRICT_VERIFY, else off = reference-compat):
    enforce sumcheck round-polynomial degree bounds derived from the
    circuit expressions (see `_verify_trace_proof`).
    """
    import os

    if batch_pairings is None:
        batch_pairings = bool(os.environ.get("QUILL_BATCH_PAIRINGS"))
    if strict is None:
        strict = bool(os.environ.get("QUILL_STRICT_VERIFY"))

    transcript = Transcript(DOMAIN)
    for commitment in proof.witness_commitment:
        transcript.append_g1(commitment)

    if len(vk.trace_vks) != len(proof.trace_proofs):
        raise ValueError("Number of trace VKS and proofs mismatch")
    if len(vk.lookups) != len(proof.lookup_proofs):
        raise ValueError("Number of lookup configs and proofs mismatch")

    kzg = getattr(pcs, "kzg", None)
    if batch_pairings and kzg is not None:
        kzg.begin_deferred()
    try:
        for i in range(len(vk.trace_vks)):
            _verify_trace_proof(proof.witness_commitment[i], vk.trace_vks[i],
                                pcs, proof.trace_proofs[i], transcript,
                                strict=strict)
        for lk, lkp in zip(vk.lookups, proof.lookup_proofs):
            _verify_lookup(lk, lkp, vk, proof.witness_commitment, pcs,
                           transcript)
    except Exception:
        if batch_pairings and kzg is not None:
            kzg._deferred = None
        raise
    if batch_pairings and kzg is not None:
        if not kzg.flush_deferred():
            raise ValueError("Batched pairing verification failed")
