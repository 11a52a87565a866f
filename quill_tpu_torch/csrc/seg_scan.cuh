// The pieces of kernel I (csrc/msm8.cu) that one thread runs alone, shared
// by the kernel and its host emulation (bn254_host.cpp: q_seg_scan_blocked).
//
// A lane of s steps is cut into T runs of r = ceil(s / T) consecutive steps,
// one run a thread.  Phase 1 (`run_scan`) scans a run from the identity,
// restarting at flags; phase 2 scans the T run totals with the segmented
// operator (`seg_op`); phase 3 (`block_fixup`) adds each run's exclusive
// carry-in to its steps before its first flag, the only ones not final yet,
// dealt out evenly over a block of SCAN_BLOCK threads (the host emulation
// also takes T above SCAN_BLOCK, a block of T threads).
#pragma once

#include "bn254.cuh"

namespace bn254 {

constexpr int SCAN_BLOCK = 128;  // threads a block of kernel I

// (fa, a) (+) (fb, b) = (fa | fb, fb ? b : a + b), with (fa, a) the earlier
// operand; the result overwrites (fb, b).
QHD void seg_op(bool fa, const G1P& a, bool& fb, G1P& b) {
  if (!fb) b = g1_add(a, b);
  fb = fb || fa;
}

// Phase 1 over steps [lo, hi) of one lane (lo < hi): y[t] is the scan of
// x[lo..t] from the identity, restarting at x[t] where flag[t] is set.
// -> the run total; *first is the first flagged step (hi if none).
QHD G1P run_scan(const uint32_t* x, const uint8_t* f, long long lo,
                 long long hi, uint32_t* y, long long* first) {
  long long ff = hi;
  G1P acc = g1_load(x + 24 * lo);
  if (f != nullptr && f[lo]) ff = lo;
  g1_store(y + 24 * lo, acc);
#pragma unroll 1
  for (long long t = lo + 1; t < hi; ++t) {
    G1P p = g1_load(x + 24 * t);
    if (f != nullptr && f[t]) {
      acc = p;
      if (ff == hi) ff = t;
    } else {
      acc = g1_add(acc, p);
    }
    g1_store(y + 24 * t, acc);
  }
  *first = ff;
  return acc;
}

// Phase 3 at one step: y = carry + y.
QHD void step_fixup(const G1P& carry, uint32_t* y) {
  g1_store(y, g1_add(carry, g1_load(y)));
}

// Phase 3 dealt out over a block of n runs (n / T whole lanes, the first
// lane0): run a needs the steps [lo[a], lo[a] + count a) fixed, and `off` is
// the exclusive prefix sum of the counts, so fix-up i is step
// lo[a] + i - off[a] of the last run a with off[a] <= i.
QHD void block_fixup(long long i, const long long* off, const long long* lo,
                     const G1P* carry, int n, int T, long long lane0,
                     long long s, uint32_t* ys) {
  int a = 0, b = n - 1;
#pragma unroll 1
  while (a < b) {
    const int mid = (a + b + 1) >> 1;
    if (off[mid] <= i) a = mid;
    else b = mid - 1;
  }
  step_fixup(carry[a], ys + ((lane0 + a / T) * s + lo[a] + (i - off[a])) * 24);
}

}  // namespace bn254
