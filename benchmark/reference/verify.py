"""The plain reference: a strict verifier of serialized HyperPlonk proofs
that holds the trapdoor of the CRS.

It reads a proof as bytes and judges it against the benchmark's own
statement: the circuit's constraints, public columns and copy permutation,
and the witness.  Nothing here imports the program or takes anything that
the program made; the benchmark makes tau and the statement from the seed
and hands the same to both sides.

Knowing tau, a KZG commitment to the coefficients c_i is [sum c_i tau^i]G,
and the pairing check of an opening (x, y, pi) of C,
e(C - yG, G2) = e(pi, [tau - x]G2), is the G1 equation C - yG = (tau - x) pi.
So each trace's verifying key (public columns, identity and permutation),
each witness commitment and each lookup's multiplicities commitment are
worked out again as field sums, and every opening is checked on G1 alone.
The protocol replayed is the program's, read strictly: each sumcheck
message within its degree bound, each KZG opening at the transcript's
challenge r or 1/r, the identity and permutation openings at the
permutation check's point, and each lookup's column openings at its
sumchecks' points.  A statement of several traces names them in
`traces()` and its lookups in `lookups()` (`registry.py`).

`Verifier.check(data)` returns the names of the checks that failed: an empty
list for a correct proof.
"""

from __future__ import annotations

from operator import mul

from . import curve
from .blake3 import digest, xof
from .curve import P, R

DOMAIN = b"hyperplonk_proof"
CHALLENGE_BYTES = 48          # (254 + 128 + 7) // 8
FIELD_BYTES = 32
Y_IS_NEGATIVE = 1 << 7
POINT_AT_INFINITY = 1 << 6
MULTISET_DEGREE = 3           # eq x (denominator x (gamma + h) - 1)


class ParseError(ValueError):
    pass


# -- transcript ----------------------------------------------------------------


def ser_usize(n: int) -> bytes:
    return int(n).to_bytes(8, "little")


def ser_field(x: int) -> bytes:
    return int(x).to_bytes(FIELD_BYTES, "little")


def ser_field_vec(xs) -> bytes:
    return ser_usize(len(xs)) + b"".join(ser_field(x) for x in xs)


def ser_g1(point) -> bytes:
    """ark-serialize's uncompressed short-Weierstrass layout: x, then y
    with the sign flag in bit 7 and the infinity flag in bit 6 of its last
    byte."""
    aff = curve.to_affine(point)
    if aff is None:
        y = bytearray(ser_field(0))
        y[-1] |= POINT_AT_INFINITY
        return ser_field(0) + bytes(y)
    x, y = aff
    yb = bytearray(ser_field(y))
    if y > P - y:
        yb[-1] |= Y_IS_NEGATIVE
    return ser_field(x) + bytes(yb)


class Transcript:
    """The BLAKE3 hash chain: each message rehashes state || message; a
    challenge is 48 bytes of output over state || b"challenge", appended
    back into the state and reduced mod R."""

    def __init__(self):
        self.state = digest(DOMAIN)

    def append(self, message: bytes) -> None:
        self.state = digest(self.state + message)

    def draw(self) -> int:
        data = xof(self.state + b"challenge", CHALLENGE_BYTES)
        self.append(data)
        return int.from_bytes(data, "little") % R


# -- the proof's bytes ---------------------------------------------------------


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ParseError("proof bytes end early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def usize(self, limit: int = 1 << 16) -> int:
        n = int.from_bytes(self.take(8), "little")
        if n > limit:
            raise ParseError(f"length {n} over {limit}")
        return n

    def field(self) -> int:
        x = int.from_bytes(self.take(FIELD_BYTES), "little")
        if x >= R:
            raise ParseError("field element not reduced")
        return x

    def g1(self):
        raw = self.take(64)
        x = int.from_bytes(raw[:32], "little")
        yb = bytearray(raw[32:])
        flags = yb[31] & 0xC0
        yb[31] &= 0x3F
        y = int.from_bytes(bytes(yb), "little")
        if flags & POINT_AT_INFINITY:
            if x or y or flags & Y_IS_NEGATIVE:
                raise ParseError("point at infinity with coordinates")
            return curve.INFINITY
        if x >= P or y >= P or not curve.on_curve(x, y):
            raise ParseError("point not on the curve")
        if bool(flags & Y_IS_NEGATIVE) != (y > P - y):
            raise ParseError("point with a wrong sign flag")
        return (x, y, 1)

    def sumcheck(self):
        num_vars = self.usize()
        claimed = self.field()
        polys = [[self.field() for _ in range(self.usize())]
                 for _ in range(self.usize())]
        return {"num_vars": num_vars, "claimed": claimed, "polys": polys}

    def opening(self):
        point = [self.field() for _ in range(self.usize())]
        evaluation = self.field()
        s_comm = self.g1()
        kzg = [(self.field(), self.field(), self.g1()) for _ in range(4)]
        return {"point": point, "eval": evaluation, "s_comm": s_comm,
                "kzg": kzg}


def read_trace(rd: Reader) -> dict:
    """One trace's proof: the zero check, the permutation check and the
    openings."""
    proof = {"zc_vars": rd.usize(), "zc": rd.sumcheck(), "denom_l": rd.g1(),
             "denom_r": rd.g1(), "ms": rd.sumcheck(), "open_l": rd.opening(),
             "open_r": rd.opening()}
    proof["open_cols"] = [rd.opening() for _ in range(rd.usize())]
    proof["open_pub"] = [rd.opening() for _ in range(rd.usize())]
    proof["open_id"] = rd.opening()
    proof["open_perm"] = rd.opening()
    proof["open_trace"] = rd.opening()
    return proof


def read_lookup(rd: Reader) -> dict:
    """One cross-table lookup's proof: the multiplicities commitment, the
    set inclusion's denominators, its two sumchecks and the denominators'
    openings, then the source, destination and multiplicities openings."""
    proof = {"mult_comm": rd.g1(), "denom_l": rd.g1(), "denom_r": rd.g1(),
             "sc_l": rd.sumcheck(), "sc_r": rd.sumcheck(),
             "open_l": rd.opening(), "open_r": rd.opening()}
    proof["open_src"] = [rd.opening() for _ in range(rd.usize())]
    proof["open_dst"] = [rd.opening() for _ in range(rd.usize())]
    proof["open_mult"] = rd.opening()
    return proof


def parse(data: bytes, traces: int = 1, lookups: int = 0) -> dict:
    """The proof of `traces` traces and `lookups` cross-table lookups: the
    witness commitments, each trace's proof, and the lookup section, which
    a proof with no lookups leaves out."""
    rd = Reader(data)
    comms = [rd.g1() for _ in range(rd.usize())]
    if len(comms) != traces or rd.usize() != traces:
        raise ParseError(f"not a proof of {traces} trace(s)")
    proof = {"witness_comms": comms,
             "traces": [read_trace(rd) for _ in range(traces)],
             "lookups": []}
    if lookups:
        if rd.usize() != lookups:
            raise ParseError(f"not a proof of {lookups} lookup(s)")
        proof["lookups"] = [read_lookup(rd) for _ in range(lookups)]
    if rd.pos != len(data):
        raise ParseError("bytes after the proof")
    return proof


# -- field helpers -------------------------------------------------------------


def inv(x: int) -> int:
    return pow(x, R - 2, R)


def horner(coeffs, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def eq_eval(x, r) -> int:
    out = 1
    for xi, ri in zip(x, r):
        out = out * ((xi * ri + (1 - xi) * (1 - ri)) % R) % R
    return out


def eval_pr(r, x: int) -> int:
    """P_r(x) = prod_i (r_i x^(2^i) + 1 - r_i): the univariate form of
    eq(., r) that the multilinear PCS opens against."""
    out, xp = 1, x % R
    for ri in r:
        out = out * ((ri * xp + 1 - ri) % R) % R
        xp = xp * xp % R
    return out


def tau_powers(tau: int, n: int) -> list[int]:
    out = [1] * n
    acc = 1
    for i in range(1, n):
        acc = acc * tau % R
        out[i] = acc
    return out


def at_tau(coeffs, powers) -> int:
    """sum c_i tau^i: the discrete log of the KZG commitment to coeffs."""
    return sum(map(mul, coeffs, powers)) % R


def column_point(point, col: int, log2_cols: int):
    return list(point) + [(col >> i) & 1 for i in range(log2_cols)]


# -- the verifier --------------------------------------------------------------


def traces_of(statement) -> list:
    """The statement's traces: its `traces()`, or the statement alone."""
    traces = getattr(statement, "traces", None)
    return list(traces()) if traces else [statement]


def multiplicities(src_cols, dst_cols) -> list[int]:
    """How often each destination row is looked up.  The program's rule:
    each source tuple is counted at its first matching destination row
    (a later duplicate destination row counts 0); a tuple that matches no
    row is counted nowhere."""
    first: dict = {}
    for j, key in enumerate(zip(*dst_cols)):
        first.setdefault(tuple(x % R for x in key), j)
    out = [0] * len(dst_cols[0])
    for key in zip(*src_cols):
        j = first.get(tuple(x % R for x in key))
        if j is not None:
            out[j] += 1
    return out


class TraceKey:
    """One trace's verifying key and witness commitment, as discrete logs
    (O(rows x columns) field products)."""

    def __init__(self, trace, witness, powers):
        self.st = trace
        self.log2_rows = trace.rows.bit_length() - 1
        self.log2_cols = trace.columns.bit_length() - 1
        self.nv = self.log2_rows + self.log2_cols
        self.witness_log = at_tau([x for column in witness for x in column],
                                  powers)
        self.public_logs = [at_tau(col, powers)
                            for col in trace.public_columns()]
        id_map, perm_map = trace.permutation()
        self.id_log = at_tau(id_map, powers)
        self.perm_log = at_tau(perm_map, powers)
        self.public = [curve.mul(curve.G, s) for s in self.public_logs]
        self.id_comm = curve.mul(curve.G, self.id_log)
        self.perm_comm = curve.mul(curve.G, self.perm_log)


class Verifier:
    """Works out each trace's verifying key and witness commitment, and
    each lookup's multiplicities commitment, once; then checks proofs of
    the statement."""

    def __init__(self, statement, tau: int):
        self.st = statement
        self.tau = tau % R
        traces = traces_of(statement)
        self.lookups = list(statement.lookups()) if hasattr(
            statement, "lookups") else []
        powers = tau_powers(self.tau, max(tr.rows * tr.columns
                                          for tr in traces))
        witnesses = [tr.witness() for tr in traces]
        self.keys = [TraceKey(tr, w, powers)
                     for tr, w in zip(traces, witnesses)]
        self.mult_logs = [
            at_tau(multiplicities([witnesses[src][c] for c in src_cols],
                                  [witnesses[dst][c] for c in dst_cols]),
                   powers)
            for src, src_cols, dst, dst_cols in self.lookups]

    # one proof ---------------------------------------------------------------

    def check(self, data: bytes) -> list[str]:
        self.failed: list[str] = []
        try:
            proof = parse(data, len(self.keys), len(self.lookups))
        except ParseError as exc:
            return [f"parse: {exc}"]
        try:
            self._verify(proof)
        except ParseError as exc:
            self.failed.append(f"shape: {exc}")
        return self.failed

    def _need(self, ok: bool, name: str) -> None:
        if not ok:
            self.failed.append(name)

    def _sumcheck(self, sc, t: Transcript, degree: int, name: str):
        """Rounds summing to the claim, each message within the degree
        bound; -> (point, the last round's value)."""
        t.append(ser_usize(sc["num_vars"]))
        t.append(ser_field(sc["claimed"]))
        if len(sc["polys"]) != sc["num_vars"]:
            raise ParseError(f"{name}: rounds != num_vars")
        v, point = sc["claimed"], []
        for i, coeffs in enumerate(sc["polys"]):
            self._need(len(coeffs) <= degree + 1, f"{name}: round {i} degree")
            self._need((horner(coeffs, 0) + horner(coeffs, 1)) % R == v,
                       f"{name}: round {i} sum")
            stripped = list(coeffs)
            while stripped and stripped[-1] == 0:
                stripped.pop()
            t.append(ser_field_vec(stripped))
            r = t.draw()
            point.append(r)
            v = horner(coeffs, r)
        return point, v

    def _kzg(self, comm, comm_log, opening, x: int, name: str) -> None:
        """C - yG = (tau - x) pi.  With C's discrete log known the check
        is pi = [(c - y) / (tau - x)]G."""
        ox, y, pi = opening
        self._need(ox == x, f"{name}: opened at another point")
        if comm_log is not None and (self.tau - ox) % R:
            want = curve.mul(curve.G, (comm_log - y) * inv(self.tau - ox))
            self._need(curve.equal(pi, want), f"{name}: opening")
            return
        lhs = curve.add(comm, curve.neg(curve.mul(curve.G, y)))
        self._need(curve.equal(lhs, curve.mul(pi, self.tau - ox)),
                   f"{name}: opening")

    def _pcs(self, comm, comm_log, op, t: Transcript, nvars: int,
             name: str) -> None:
        """The multilinear opening: evaluation = <coefficients, P_point>,
        by two KZG openings of the polynomial and two of its S polynomial
        at r and 1/r, bound by the Mercury equation."""
        if len(op["point"]) != nvars:
            raise ParseError(f"{name}: point of {len(op['point'])} vars")
        t.append(ser_field_vec(op["point"]))
        t.append(ser_field(op["eval"]))
        t.append(ser_g1(op["s_comm"]))
        r = t.draw()
        r_inv = inv(r)
        (po, poi, so, soi) = op["kzg"]
        self._kzg(comm, comm_log, po, r, f"{name} at r")
        self._kzg(comm, comm_log, poi, r_inv, f"{name} at 1/r")
        self._kzg(op["s_comm"], None, so, r, f"{name} S at r")
        self._kzg(op["s_comm"], None, soi, r_inv, f"{name} S at 1/r")
        lhs = (po[1] * eval_pr(op["point"], r_inv)
               + poi[1] * eval_pr(op["point"], r)) % R
        rhs = (r * so[1] + r_inv * soi[1] + 2 * op["eval"]) % R
        self._need(lhs == rhs, f"{name}: Mercury equation")

    def _verify(self, pf) -> None:
        """The program's transcript order: every witness commitment, each
        trace's proof, then each lookup.  With several traces each check's
        name starts with its trace's."""
        t = Transcript()
        several = len(self.keys) > 1
        for i, (key, wc) in enumerate(zip(self.keys, pf["witness_comms"])):
            self._need(curve.equal(wc, curve.mul(curve.G, key.witness_log)),
                       f"trace {i}: witness commitment" if several
                       else "witness commitment")
            t.append(ser_g1(wc))
        for i, (key, wc, tp) in enumerate(zip(
                self.keys, pf["witness_comms"], pf["traces"])):
            self._trace(key, wc, tp, t, f"trace {i}: " if several else "")
        for k, (lk, lp) in enumerate(zip(self.lookups, pf["lookups"])):
            self._lookup(k, lk, lp, pf["witness_comms"], t)

    def _trace(self, key: TraceKey, wc, pf, t: Transcript, tag: str) -> None:
        """One trace's zero check, permutation check and openings."""
        st = key.st
        lr, lc, nv = key.log2_rows, key.log2_cols, key.nv

        # zero check over the rows: sum_k alpha^k constraint_k = 0
        alpha = t.draw()
        if pf["zc_vars"] != lr or pf["zc"]["num_vars"] != lr:
            raise ParseError(f"{tag}zero check over the wrong number of "
                             "variables")
        z = [t.draw() for _ in range(lr)]
        self._need(pf["zc"]["claimed"] == 0, f"{tag}zero check: claimed sum")
        zc_point, v = self._sumcheck(pf["zc"], t, st.constraint_degree + 1,
                                     f"{tag}zero check")
        zc_eval = v * inv(eq_eval(z, zc_point)) % R

        # permutation check over the whole trace: id + beta w against
        # perm + beta w, as a log-derivative multiset equality
        ops = (pf["open_id"], pf["open_perm"], pf["open_trace"])
        for op, name in zip(ops, ("identity", "permutation", "trace")):
            if len(op["point"]) != nv:
                raise ParseError(f"{tag}{name} opening of "
                                 f"{len(op['point'])} vars")
        trace_pt = pf["open_trace"]["point"]
        self._need(pf["open_id"]["point"] == trace_pt
                   and pf["open_perm"]["point"] == trace_pt,
                   f"{tag}permutation check: openings at different points")
        beta = t.draw()
        left = (pf["open_id"]["eval"] + beta * pf["open_trace"]["eval"]) % R
        right = (pf["open_perm"]["eval"]
                 + beta * pf["open_trace"]["eval"]) % R
        gamma = t.draw()
        t.append(ser_g1(pf["denom_l"]))
        t.append(ser_g1(pf["denom_r"]))
        lam = t.draw()
        alpha2 = t.draw()
        zr = [t.draw() for _ in range(nv)]
        if pf["ms"]["num_vars"] != nv:
            raise ParseError(f"{tag}multiset sumcheck over the wrong "
                             "variables")
        self._need(pf["ms"]["claimed"] == 0, f"{tag}multiset: claimed sum")
        ms_point, ms_v = self._sumcheck(pf["ms"], t, MULTISET_DEGREE,
                                        f"{tag}multiset")
        self._pcs(pf["denom_l"], None, pf["open_l"], t, nv,
                  f"{tag}left denominator")
        self._pcs(pf["denom_r"], None, pf["open_r"], t, nv,
                  f"{tag}right denominator")
        self._need(pf["open_l"]["point"] == ms_point
                   and pf["open_r"]["point"] == ms_point
                   and trace_pt == ms_point,
                   f"{tag}multiset: openings off the sumcheck point")
        dl, dr = pf["open_l"]["eval"], pf["open_r"]["eval"]
        zc_ms = (dl * (gamma + left) - 1 + lam * (dr * (gamma + right) - 1)) % R
        final = (zc_ms * eq_eval(zr, trace_pt) * alpha2 + dl - dr) % R
        self._need(final == ms_v, f"{tag}multiset: final evaluation")

        # the columns at the zero check's point, then the constraints there
        if len(pf["open_cols"]) != st.columns:
            raise ParseError(f"{tag}column openings != columns")
        if len(pf["open_pub"]) != len(key.public):
            raise ParseError(f"{tag}public openings != public columns")
        evals = []
        for col, op in enumerate(pf["open_cols"]):
            self._need(op["point"] == column_point(zc_point, col, lc),
                       f"{tag}column {col}: opened off the zero check's "
                       "point")
            self._pcs(wc, key.witness_log, op, t, nv, f"{tag}column {col}")
            evals.append(op["eval"])
        for i, op in enumerate(pf["open_pub"]):
            self._need(op["point"] == zc_point,
                       f"{tag}public {i}: opened off the zero check's point")
            self._pcs(key.public[i], key.public_logs[i], op, t, lr,
                      f"{tag}public {i}")
            evals.append(op["eval"])
        total, a = 0, 1
        for value in st.constraints(evals):
            total = (total + a * value) % R
            a = a * alpha % R
        self._need(total == zc_eval,
                   f"{tag}zero check: constraints at the point")

        self._pcs(key.id_comm, key.id_log, pf["open_id"], t, nv,
                  f"{tag}identity")
        self._pcs(key.perm_comm, key.perm_log, pf["open_perm"], t, nv,
                  f"{tag}permutation")
        self._pcs(wc, key.witness_log, pf["open_trace"], t, nv,
                  f"{tag}trace")

    def _lookup(self, k: int, lk, pf, wcs, t: Transcript) -> None:
        """One cross-table lookup (Logup over two hypercubes): the source
        tuples, batched by powers of a challenge into h_l, are among the
        destination's, h_r, counted by the multiplicities m, when
        sum 1 / (gamma + h_l) = sum m / (gamma + h_r).  The program commits
        d_l = 1 / (gamma + h_l) and d_r = m / (gamma + h_r) and proves each
        sum by a sumcheck that batches it with d's own zero check."""
        tag = f"lookup {k}: "
        src, src_cols, dst, dst_cols = lk
        sk, dk = self.keys[src], self.keys[dst]
        mult_log = self.mult_logs[k]
        n = len(src_cols)
        if len(pf["open_src"]) != n or len(pf["open_dst"]) != n:
            raise ParseError(f"{tag}column openings != lookup columns")
        self._need(curve.equal(pf["mult_comm"],
                               curve.mul(curve.G, mult_log)),
                   f"{tag}multiplicities commitment")
        t.append(ser_g1(pf["mult_comm"]))
        t.append(ser_usize(n))
        alpha_lk = t.draw()

        # the set inclusion
        gamma = t.draw()
        t.append(ser_g1(pf["denom_l"]))
        t.append(ser_g1(pf["denom_r"]))
        if (pf["sc_l"]["num_vars"] != sk.log2_rows
                or pf["sc_r"]["num_vars"] != dk.log2_rows):
            raise ParseError(f"{tag}sumcheck over the wrong variables")
        z1 = [t.draw() for _ in range(sk.log2_rows)]
        alpha = t.draw()
        pt_l, v_l = self._sumcheck(pf["sc_l"], t, MULTISET_DEGREE,
                                   f"{tag}left sumcheck")
        z2 = [t.draw() for _ in range(dk.log2_rows)]
        beta = t.draw()
        pt_r, v_r = self._sumcheck(pf["sc_r"], t, MULTISET_DEGREE,
                                   f"{tag}right sumcheck")
        self._pcs(pf["denom_l"], None, pf["open_l"], t, sk.log2_rows,
                  f"{tag}left denominator")
        self._pcs(pf["denom_r"], None, pf["open_r"], t, dk.log2_rows,
                  f"{tag}right denominator")
        self._need(pf["open_l"]["point"] == pt_l
                   and pf["open_r"]["point"] == pt_r,
                   f"{tag}denominators opened off the sumchecks' points")

        # the columns at the sumchecks' points, each against its trace's
        # witness commitment, then the multiplicities
        h_l = h_r = 0
        for i, (c, op) in enumerate(zip(src_cols, pf["open_src"])):
            self._need(op["point"] == column_point(pt_l, c, sk.log2_cols),
                       f"{tag}source column {c}: opened off the left point")
            self._pcs(wcs[src], sk.witness_log, op, t, sk.nv,
                      f"{tag}source column {c}")
            h_l = (h_l + pow(alpha_lk, i, R) * op["eval"]) % R
        for i, (c, op) in enumerate(zip(dst_cols, pf["open_dst"])):
            self._need(op["point"] == column_point(pt_r, c, dk.log2_cols),
                       f"{tag}destination column {c}: opened off the right "
                       "point")
            self._pcs(wcs[dst], dk.witness_log, op, t, dk.nv,
                      f"{tag}destination column {c}")
            h_r = (h_r + pow(alpha_lk, i, R) * op["eval"]) % R
        self._need(pf["open_mult"]["point"] == pt_r,
                   f"{tag}multiplicities: opened off the right point")
        self._pcs(pf["mult_comm"], mult_log, pf["open_mult"], t,
                  dk.log2_rows, f"{tag}multiplicities")

        # each sumcheck's last value rebuilt from the openings, and the
        # two sums equal
        d_l, d_r = pf["open_l"]["eval"], pf["open_r"]["eval"]
        m = pf["open_mult"]["eval"]
        left = ((d_l * (gamma + h_l) - 1) * eq_eval(pt_l, z1)
                + alpha * d_l) % R
        right = ((d_r * (gamma + h_r) - m) * eq_eval(pt_r, z2)
                 + beta * d_r) % R
        self._need(left == v_l, f"{tag}left sumcheck: final evaluation")
        self._need(right == v_r, f"{tag}right sumcheck: final evaluation")
        self._need(pf["sc_l"]["claimed"] * inv(alpha) % R
                   == pf["sc_r"]["claimed"] * inv(beta) % R,
                   f"{tag}log-derivative sums differ")
