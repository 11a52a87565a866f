// The pieces of v8's entries kernels (csrc/msm8.cu: v8e_*) that one thread
// runs alone, shared by the kernels and their host emulation
// (bn254_host.cpp: q_v8_entries_blocked).
//
// One chunk of n Montgomery Fr scalars becomes NWIN rows of npad sorted
// entries (npad = n rounded up to the scan's blocks; the padding has digit
// 0): the scalar's canonical value (`v8e_canonical`), its unsigned 13-bit
// digit in each window (`v8e_digit`), each window's digits sorted stably by
// counting (per-segment histograms, their prefixes over the segments
// `v8e_column`, then over the digits) into packed entries (`v8e_pack`), and
// each sorted position's point (`v8e_emit`) and flag (`v8e_flag`).
#pragma once

#include "bn254.cuh"

namespace bn254 {

constexpr int V8E_NWIN = 20;   // ec/msm5.py: NWIN = ceil(254 / 13)
constexpr int V8E_WBITS = 13;  // ec/msm5.py: WBITS
constexpr int V8E_NBUCK = 1 << V8E_WBITS;
constexpr long long V8E_MAX_N = 1 << 16;  // scalars a chunk: 16-bit indices

// a sorted entry: its digit above its scalar's index in the chunk
QHD int32_t v8e_pack(int d, long long i) { return (d << 16) | (int32_t)i; }
QHD int v8e_entry_digit(int32_t e) { return e >> 16; }
QHD long long v8e_entry_index(int32_t e) { return e & 0xffff; }

// a Montgomery Fr scalar's canonical value: s * 1 / R mod r
QHD Fe v8e_canonical(const uint32_t* s) {
  Fe one = fe_zero<FrM>();
  one.v[0] = 1u;
  return fe_mul<FrM>(fe_load(s), one);
}

// bits 13 w .. 13 w + 12 of c (`msm5.window_digits`); the top window holds
// the scalar's last 7 bits
QHD int v8e_digit(const Fe& c, int w) {
  const int bit = w * V8E_WBITS, limb = bit >> 5, sh = bit & 31;
  uint32_t d = c.v[limb] >> sh;
  if (sh + V8E_WBITS > 32 && limb + 1 < 8) d |= c.v[limb + 1] << (32 - sh);
  return (int)(d & (V8E_NBUCK - 1));
}

// One digit's counts in S segments (col[s * stride]) -> their exclusive
// prefix over the segments, in place; returns the digit's total.
QHD int v8e_column(int* col, long long S, long long stride) {
  int run = 0;
#pragma unroll 4
  for (long long s = 0; s < S; ++s) {
    const int c = col[s * stride];
    col[s * stride] = run;
    run += c;
  }
  return run;
}

// Coordinate k (X, Y, Z) of sorted position p of one window's row; q is its
// index in the (NWIN, npad) rows, z the window's first position of a digit
// above 0 (the digit-0 entries and the padding come first), and ent the
// packed entries from z on.  An entry of digit 0, or whose point is at
// infinity, is the identity (0 : 1 : 0); any other is its affine point
// (x : y : 1).
QHD void v8e_emit(long long q, int k, long long p, int z,
                  const int32_t* ent, const uint32_t* xy,
                  const uint8_t* inf, uint32_t* pts) {
  bool dead = true;
  long long i = 0;
  if (p >= z) {
    i = v8e_entry_index(ent[q]);
    dead = inf[i] != 0;
  }
  Fe v;
  if (dead) {
    v = k == 1 ? fe_one<FqM>() : fe_zero<FqM>();
  } else {
    v = k == 2 ? fe_one<FqM>() : fe_load16(xy + 16 * i + 8 * k);
  }
  fe_store16(pts + 24 * q + 8 * k, v);
}

// Whether sorted position p (0 .. npad - 1, q as above) starts a run of
// its digit: the row's first position, the first digit above 0, or a digit
// other than the one before it.
QHD bool v8e_flag(long long q, long long p, int z, const int32_t* ent) {
  if (p == 0 || p == z) return true;
  return p > z &&
         v8e_entry_digit(ent[q]) != v8e_entry_digit(ent[q - 1]);
}

}  // namespace bn254
