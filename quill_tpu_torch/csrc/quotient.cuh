// The pieces of kernel M (csrc/quotient.cu) that one thread runs alone,
// shared by the kernel and its host emulation (bn254_host.cpp:
// q_quotient_blocked).
//
// A job is one opening: coefficients c (n Fr elements, Montgomery form) and a
// point x != 0.  Its quotient by (X - x) is q_k = (y - P_k) x^-(k+1) with
// P_k = sum_{t <= k} c_t x^t and y = P_{n-1}.  The coefficients are cut into
// tiles of QUOT_BLOCK runs of r consecutive coefficients, one run a thread.
// Phase 1 (`qt_run_scan`) writes each run's own inclusive prefix sums of
// c_t x^t; the block's exclusive scan of the run totals gives each run its
// carry inside the tile, and the block total is the tile's.  Phase 2 scans
// each job's tile totals (its sum is y).  Phase 3 (`qt_run_finish`) adds the
// tile's and the run's carries to each prefix and turns it into q_k in place.
// A run starts its power of x from a table of x^(2^i) (`qt_pow`) and then
// steps it with one product a coefficient.
#pragma once

#include "bn254.cuh"

namespace bn254 {

constexpr int QUOT_BLOCK = 128;  // runs (threads) a tile
constexpr int QUOT_LOG = 32;     // rows of a power table: x^(2^i), i < 32

// x^e from tab[i] = x^(2^i) (QUOT_LOG rows of 8 words), e < 2^QUOT_LOG
QHD Fe qt_pow(const uint32_t* tab, unsigned long long e) {
  Fe r = fe_one<FrM>();
#pragma unroll 1
  for (int i = 0; e != 0; ++i, e >>= 1)
    if (e & 1ull) r = fe_mul<FrM>(r, fe_load(tab + 8 * i));
  return r;
}

// Phase 1 over coefficients [lo, hi), lo < hi: out[k] = sum_{lo <= t <= k}
// c_t x^t, with tab the table of x.  -> the run's total.
QHD Fe qt_run_scan(const uint32_t* c, const uint32_t* tab, long long lo,
                   long long hi, uint32_t* out) {
  const Fe x = fe_load(tab);
  Fe pw = qt_pow(tab, (unsigned long long)lo);
  Fe acc = fe_mul<FrM>(fe_load16(c + 8 * lo), pw);
  fe_store16(out + 8 * lo, acc);
#pragma unroll 1
  for (long long k = lo + 1; k < hi; ++k) {
    pw = fe_mul<FrM>(pw, x);
    acc = fe_add<FrM>(acc, fe_mul<FrM>(fe_load16(c + 8 * k), pw));
    fe_store16(out + 8 * k, acc);
  }
  return acc;
}

// Phase 3 over [lo, hi): P_k = out[k] + carry, out[k] = (y - P_k) x^-(k+1),
// with itab the table of x^-1.  At k = n - 1, P_k = y and out[k] = 0.
QHD void qt_run_finish(uint32_t* out, const uint32_t* itab, long long lo,
                       long long hi, const Fe& carry, const Fe& y) {
  const Fe xi = fe_load(itab);
  Fe pw = qt_pow(itab, (unsigned long long)lo + 1);
#pragma unroll 1
  for (long long k = lo; k < hi; ++k) {
    if (k > lo) pw = fe_mul<FrM>(pw, xi);
    const Fe p = fe_add<FrM>(fe_load16(out + 8 * k), carry);
    fe_store16(out + 8 * k, fe_mul<FrM>(fe_sub<FrM>(y, p), pw));
  }
}

}  // namespace bn254
