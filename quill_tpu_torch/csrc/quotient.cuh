// The pieces of kernel M (csrc/quotient.cu) that one thread runs alone,
// shared by the kernel and its host emulation (bn254_host.cpp:
// q_quotient_blocked).
//
// A job is one opening: coefficients c (n Fr elements, Montgomery form) and a
// point x != 0.  Ruffini's recurrence gives its quotient by (X - x): with
// H_k = sum_{t >= k} c_t x^(t - k), H_k = c_k + x H_(k+1) from H_n = 0, the
// quotient's coefficients are q_(k-1) = H_k and y = p(x) = H_0.  The
// coefficients are cut into tiles of QUOT_BLOCK runs of r consecutive
// coefficients, one run a thread.  A run [lo, hi) maps H at its top to H at
// its bottom by an affine map, H_lo = L_lo + x^(hi - lo) H_hi, with L the
// run's own recurrence from L_hi = 0.  Phase 1 (`qt_run_map`) computes each
// run's map, one product a coefficient; the maps compose from the top,
// (a1, b1) o (a2, b2) = (a1 a2, b1 + a1 b2) (`qt_compose`), so the block's
// exclusive scan of them from the top gives each run its map from the
// tile's top, and the block total is the tile's.  Phase 2 scans each job's
// tile maps from the top into each tile's H at its top; the whole job's map
// sends H_n = 0 to y.  Phase 3 (`qt_run_finish`) turns the run's carry into
// H at its top and runs the recurrence again, one product a coefficient,
// writing q once.
#pragma once

#include "bn254.cuh"

namespace bn254 {

constexpr int QUOT_BLOCK = 128;  // runs (threads) a tile

struct QtMap {  // H -> b + a H
  Fe a, b;
};

QHD QtMap qt_identity() {
  QtMap m;
  m.a = fe_one<FrM>();
  m.b = fe_zero<FrM>();
  return m;
}

// lo o hi: first the map of the higher coefficients, then the lower one's
QHD QtMap qt_compose(const QtMap& lo, const QtMap& hi) {
  QtMap m;
  m.a = fe_mul<FrM>(lo.a, hi.a);
  m.b = fe_add<FrM>(lo.b, fe_mul<FrM>(lo.a, hi.b));
  return m;
}

// x^e, e >= 0, by square and multiply
QHD Fe qt_pow(const Fe& x, long long e) {
  Fe r = fe_one<FrM>(), s = x;
#pragma unroll 1
  for (; e != 0; e >>= 1) {
    if (e & 1) r = fe_mul<FrM>(r, s);
    if (e > 1) s = fe_mul<FrM>(s, s);
  }
  return r;
}

// Phase 1 over coefficients [lo, hi): the run's map (x^(hi - lo), L_lo),
// with xr = x^r for a whole run of r; the identity for an empty run.
QHD QtMap qt_run_map(const uint32_t* c, const Fe& x, const Fe& xr, long long r,
                     long long lo, long long hi) {
  if (lo >= hi) return qt_identity();
  QtMap m;
  m.a = hi - lo == r ? xr : qt_pow(x, hi - lo);
  m.b = fe_load16(c + 8 * (hi - 1));
#pragma unroll 1
  for (long long k = hi - 2; k >= lo; --k)
    m.b = fe_add<FrM>(fe_load16(c + 8 * k), fe_mul<FrM>(x, m.b));
  return m;
}

// Phase 3 over [lo, hi) of a job of n coefficients: from h = H_hi,
// out[k - 1] = H_k for k >= 1, and out[n - 1] = 0 where hi = n.
QHD void qt_run_finish(const uint32_t* c, const Fe& x, long long lo,
                       long long hi, long long n, Fe h, uint32_t* out) {
  if (hi == n) fe_store16(out + 8 * (n - 1), fe_zero<FrM>());
#pragma unroll 1
  for (long long k = hi - 1; k >= lo && k >= 1; --k) {
    h = fe_add<FrM>(fe_load16(c + 8 * k), fe_mul<FrM>(x, h));
    fe_store16(out + 8 * (k - 1), h);
  }
}

}  // namespace bn254
