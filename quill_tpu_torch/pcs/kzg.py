"""Univariate KZG commitments over BN254.

Counterpart of `quill-zkvm/pcs/src/kzg.rs`.  Differences from the
reference (all transcript-invisible):
- the CRS is stored in affine form once at setup (the reference converts the
  whole projective CRS to affine on *every* commit, `kzg.rs:67-71`);
- quotient polynomials are produced by synthetic division (associative-scan
  friendly) instead of generic polynomial division (`kzg.rs:80-85`);
- verification uses one multi-pairing (2 Miller loops, 1 shared final
  exponentiation) instead of two full pairings (`kzg.rs:104-107`).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ec import curve
from ..ec.pairing import pairing_check
from ..fields.bn254 import R
from ..kernels.build import crs_cache_dir

# Above OPEN_SPLIT elements an `open_many` batch runs in sub-groups of
# OPEN_GROUP jobs, so that at most OPEN_GROUP full-size quotients are in
# flight (the 2^23-cell ceiling of the JAX package's scale runs)
OPEN_SPLIT = 1 << 22
OPEN_GROUP = 4


def _tau_from_seed(seed: int) -> int:
    import hashlib

    return int.from_bytes(
        hashlib.sha256(b"quill-tpu-trusted-setup"
                       + seed.to_bytes(8, "little")).digest(), "little") % R


@dataclass
class KZGOpeningProof:
    """`KZGOpeningProof { x, y, proof }` (`kzg.rs:25-32`)."""

    x: int
    y: int
    proof: curve.Jacobian


class KZG:
    """CRS + commit/open/verify.  `g1_points` are affine G1 powers of tau;
    `g2_points` = [G2, tau*G2] (`kzg.rs:35-59`)."""

    def __init__(self, engine, max_degree: int, g1_points: list[curve.Affine],
                 g2_points: list[curve.Jacobian], g1: curve.Jacobian,
                 g2: curve.Jacobian):
        self.engine = engine
        self.max_degree = max_degree
        self.g1 = g1
        self.g2 = g2
        self.g1_points = g1_points
        self.g2_points = g2_points
        self._basis = engine.load_points(g1_points)

    # -- setup --------------------------------------------------------------

    @staticmethod
    def trusted_setup(engine, max_degree: int, tau: int | None = None,
                      seed: int = 0) -> "KZG":
        """Deterministic τ-powers CRS.  The reference samples generators and τ
        from an RNG (`kzg.rs:35-59`); we derive them from a seed (τ is toxic
        waste either way; CRS bytes are not transcript material)."""
        if tau is None:
            tau = _tau_from_seed(seed)
        g2 = curve.g2_generator()
        g1_points = curve.g1_tau_powers(tau, max_degree + 1)
        g2_points = [g2, g2.scalar_mul(tau)]
        return KZG(engine, max_degree, g1_points, g2_points,
                   curve.g1_generator(), g2)

    @staticmethod
    def device_setup(engine, max_degree: int, tau: int | None = None,
                     seed: int = 0) -> "KZG":
        """CRS made by the engine (`quill_tpu/pcs/kzg.py:106`):
        `engine.tau_basis`, the same points as `trusted_setup` with the
        same seed (on the card fixed-base tau powers, kernel J, cached on
        disk); the basis stays with the engine and `g1_points` is None."""
        if tau is None:
            tau = _tau_from_seed(seed)
        g2 = curve.g2_generator()
        kzg = KZG.__new__(KZG)
        kzg.engine = engine
        kzg.max_degree = max_degree
        kzg.g1 = curve.g1_generator()
        kzg.g2 = g2
        kzg.g1_points = None
        kzg.g2_points = [g2, g2.scalar_mul(tau)]
        kzg._basis = engine.tau_basis(tau, max_degree + 1)
        return kzg

    # -- core ops ------------------------------------------------------------

    def commit(self, poly) -> curve.Jacobian:
        """MSM of coefficients against the CRS (`kzg.rs:61-73`)."""
        from ..utils.profiling import phase

        n = self.engine.vec_len(poly)
        assert n <= self.max_degree + 1, "Polynomial degree exceeds max degree"
        with phase("kzg/commit_msm"):
            return self.engine.msm(self.engine.basis_slice(self._basis, n),
                                   poly)

    def open(self, poly, x: int) -> KZGOpeningProof:
        """Open p at x: y = p(x), commit to q = (p - y)/(X - x)
        (`kzg.rs:75-96`)."""
        return self.open_many([(poly, x)])[0]

    def open_many(self, polys_xs: list) -> list:
        """Batch of openings [(poly, x), ...] with no transcript events in
        between: ALL quotients in one batched pass (`engine.quotient_many`:
        on the card kernel M, one host readback for the whole batch), then
        ALL quotient commitments as one fused multi-MSM
        (engine.msm_many).  Proof
        objects are byte-identical to sequential `open` calls.

        Residency: the fused path holds every quotient vector (one per
        job) until the multi-MSM lands; above OPEN_SPLIT elements the
        batch runs in sub-groups of OPEN_GROUP jobs.  Sub-grouping is
        output-invisible."""
        n = len(polys_xs)
        if n > OPEN_GROUP and any(self.engine.vec_len(p) >= OPEN_SPLIT
                                  for p, _ in polys_xs):
            out = []
            for i in range(0, n, OPEN_GROUP):
                out.extend(self.open_many(polys_xs[i:i + OPEN_GROUP]))
            return out
        from ..utils.profiling import phase

        ys, qs = [], []
        with phase("kzg/quotient"):
            for y, q in self.engine.quotient_many(polys_xs):
                ys.append(y)
                qs.append(q)
        with phase("kzg/open_msm"):
            comms = self.engine.msm_many(
                [(self.engine.basis_slice(self._basis,
                                          self.engine.vec_len(q)), q)
                 for q in qs])
        return [KZGOpeningProof(x=x % R, y=y, proof=c)
                for (_, x), y, c in zip(polys_xs, ys, comms)]

    def commit_many(self, polys: list) -> list:
        """Batch of commitments with no transcript events in between, as
        one fused multi-MSM."""
        from ..utils.profiling import phase

        with phase("kzg/commit_msm"):
            return self.engine.msm_many(
                [(self.engine.basis_slice(self._basis,
                                          self.engine.vec_len(p)), p)
                 for p in polys])

    def verify_opening(self, commitment: curve.Jacobian, proof: KZGOpeningProof) -> bool:
        """Pairing equation e(C - y G1, G2) = e(pi, tau G2 - x G2)
        (`kzg.rs:98-108`), checked as one multi-pairing product == 1.

        When a deferred batch is active (`begin_deferred`), the check is
        queued instead and settled by `flush_deferred` -- a random-linear-
        combination batch with verifier-local coefficients, one 2-pair
        multi-pairing for the whole batch (transcript-invisible; sound by
        Schwartz-Zippel over the 128-bit coefficients)."""
        if self._deferred is not None:
            self._deferred.append((commitment, proof))
            return True
        c_minus_y = commitment.add(self.g1.scalar_mul(proof.y).neg())
        tau_minus_x = self.g2_points[1].add(self.g2_points[0].scalar_mul(proof.x).neg())
        return pairing_check([
            (c_minus_y.to_affine(), self.g2.to_affine()),
            (proof.proof.neg().to_affine(), tau_minus_x.to_affine()),
        ])

    # -- deferred batched verification --------------------------------------
    #
    # For each queued opening:  e(C_i - y_i G, G2) = e(pi_i, tau G2 - x_i G2)
    #   <=>  e(C_i - y_i G + x_i pi_i, G2) * e(-pi_i, tau G2) = 1.
    # Batch with random c_i:
    #   e(sum c_i C_i - (sum c_i y_i) G + sum (c_i x_i) pi_i, G2)
    #     * e(-(sum c_i pi_i), tau G2) = 1
    # i.e. three small host MSMs + one fixed-base mul + ONE multi-pairing.

    _deferred = None

    def begin_deferred(self) -> None:
        self._deferred = []

    def flush_deferred(self) -> bool:
        import os as _os

        batch = self._deferred
        self._deferred = None
        if not batch:
            return True
        cs = [int.from_bytes(_os.urandom(16), "little") | 1 for _ in batch]
        comms = curve.batch_to_affine([c for c, _ in batch])
        pis = curve.batch_to_affine([p.proof for _, p in batch])
        sum_cC = curve.msm_host(comms, cs)
        sum_cy = sum(c * (p.y % R) for c, (_, p) in zip(cs, batch)) % R
        sum_cx_pi = curve.msm_host(pis, [c * (p.x % R) % R
                                         for c, (_, p) in zip(cs, batch)])
        sum_c_pi = curve.msm_host(pis, [c % R for c in cs])
        left = sum_cC.add(self.g1.scalar_mul(sum_cy).neg()).add(sum_cx_pi)
        return pairing_check([
            (left.to_affine(), self.g2.to_affine()),
            (sum_c_pi.neg().to_affine(), self.g2_points[1].to_affine()),
        ])


# module-level + on-disk CRS caches so tests and benches reuse setups (host
# tau-power generation is O(degree) scalar muls of Python EC)
_SETUP_CACHE: dict = {}


def _disk_cache_path(max_degree: int, seed: int) -> str | None:
    import os

    d = crs_cache_dir()
    if d is None:
        return None
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"crs_{max_degree}_{seed}.npz")


def _save_crs(path: str, kzg: KZG) -> None:
    import numpy as np

    xs = np.array([[p.x.v >> (64 * i) & ((1 << 64) - 1) for i in range(4)]
                   for p in kzg.g1_points], dtype=np.uint64)
    ys = np.array([[p.y.v >> (64 * i) & ((1 << 64) - 1) for i in range(4)]
                   for p in kzg.g1_points], dtype=np.uint64)
    g2 = kzg.g2_points[1].to_affine()
    g2_words = np.array([g2.x.c0, g2.x.c1, g2.y.c0, g2.y.c1], dtype=object)
    np.savez_compressed(path, xs=xs, ys=ys,
                        g2=np.array([str(int(v)) for v in g2_words]))


def _load_crs(path: str, engine, max_degree: int):
    import numpy as np

    from ..ec.tower import Fq2

    try:
        data = np.load(path, allow_pickle=False)
    except Exception:
        return None
    xs, ys = data["xs"], data["ys"]
    if xs.shape[0] != max_degree + 1:
        return None
    points = []
    for i in range(xs.shape[0]):
        x = sum(int(xs[i, j]) << (64 * j) for j in range(4))
        y = sum(int(ys[i, j]) << (64 * j) for j in range(4))
        points.append(curve.Affine(curve.Fq(x), curve.Fq(y)))
    g2w = [int(s) for s in data["g2"]]
    g2 = curve.g2_generator()
    tau_g2 = curve.Jacobian(Fq2(g2w[0], g2w[1]), Fq2(g2w[2], g2w[3]),
                            Fq2.one())
    return KZG(engine, max_degree, points, [g2, tau_g2], curve.g1_generator(),
               g2)


def cached_trusted_setup(engine, max_degree: int, seed: int = 0) -> KZG:
    key = (max_degree, seed, id(engine))
    crs = _SETUP_CACHE.get(key)
    if crs is not None:
        return crs
    path = _disk_cache_path(max_degree, seed)
    crs = _load_crs(path, engine, max_degree) if path is not None else None
    if crs is None:
        base = KZG.trusted_setup(engine, max_degree, seed=seed)
        crs = KZG(engine, base.max_degree, base.g1_points, base.g2_points,
                  base.g1, base.g2)
        if path is not None:
            try:
                _save_crs(path, crs)
            except Exception:
                pass
    _SETUP_CACHE[key] = crs
    return crs
