// The tile pass of kernel B (csrc/ntt.cu): which elements a tile holds,
// which pairs a butterfly joins and which twiddle it takes.  Shared by the
// kernel and its host emulation (bn254_host.cpp: q_ntt_pass_blocked).
//
// Transforms of n = 2^logn points over Fr, without a permutation pass:
// - forward, decimation in frequency (DIF): natural order in, stages on
//   bits logn-1 down to 0, butterfly (u, v) -> (u + v, (u - v) w), the
//   result in bit-reversed order (the "DIF order");
// - inverse, decimation in time (DIT): DIF order in, stages on bits 0 up to
//   logn-1, butterfly (u, v) -> (u + w' v, u - w' v) with w' = w^-1,
//   natural order out.
// A stage on bit b pairs the elements i and i + 2^b with bit b of i clear,
// and its twiddle is w_(2^(b+1))^j, j = i mod 2^b.
//
// A pass runs the stages on the bits [b0, b0 + s) of one tile at a time.  A
// tile is 2^s rows of 2^logc columns: the elements whose index has the same
// bits outside [b0, b0 + s) and outside the column bits [0, logc) -- so
// row r, column c of tile g is element (high << (b0 + s)) | (r << b0) |
// (cg << logc) | c, with g = high 2^(b0 - logc) + cg.  A row is 2^logc
// consecutive elements: the strided passes (b0 > 0) load 256-byte rows or
// longer, the contiguous pass (b0 = 0, logc = 0) one block of 2^s.
//
// Twiddles come from one table, built once (ntt.cu: ntt_twiddles_kernel):
// row b holds w_(2^(b+1))^j for j = 0 .. 2^b (2^b + 1 entries; the last is
// -1), rows in order of b.  A forward butterfly of row b reads entry j; an
// inverse one reads entry 2^b - j, which is -w^-j, and swaps its sum and
// difference.  The rows do not depend on n, so one table serves every
// transform up to its size, and neighbouring columns read neighbouring
// entries.
#pragma once

#include "bn254.cuh"

namespace bn254 {

constexpr int NTT_TILE_LOG = 11;  // the kernel's tile: 2^11 elements, 64 KB
constexpr int NTT_THREADS = 256;  // the kernel's block

struct NttPass {
  int logn, b0, s, logc;
};

// first entry of row b of the twiddle table: rows c < b hold 2^c + 1 each
QHD long long ntt_tw_row(int b) { return (1ll << b) - 1 + b; }

QHD int ntt_tile_size(const NttPass& p) { return 1 << (p.s + p.logc); }

QHD long long ntt_tiles(const NttPass& p) {
  return (1ll << p.logn) >> (p.s + p.logc);
}

// index in the array of element e of tile g
QHD long long ntt_global(const NttPass& p, long long g, int e) {
  const int cgbits = p.b0 - p.logc;
  const long long high = g >> cgbits;
  const long long cg = g & ((1ll << cgbits) - 1);
  const long long r = e >> p.logc;
  const long long c = e & ((1 << p.logc) - 1);
  return (high << (p.b0 + p.s)) | (r << p.b0) | (cg << p.logc) | c;
}

// butterfly k (< 2^(s - 1 + logc)) on the pass's bit q of tile g: its two
// tile elements and the twiddle exponent j (the low b0 + q bits of e0's
// index)
QHD void ntt_pair(const NttPass& p, long long g, int q, int k, int* e0,
                  int* e1, long long* j) {
  const int c = k & ((1 << p.logc) - 1);
  const int pi = k >> p.logc;
  const int lowr = pi & ((1 << q) - 1);
  const int r0 = ((pi >> q) << (q + 1)) | lowr;
  *e0 = (r0 << p.logc) | c;
  *e1 = *e0 + ((1 << q) << p.logc);
  const long long cg = g & ((1ll << (p.b0 - p.logc)) - 1);
  *j = ((long long)lowr << p.b0) | (cg << p.logc) | c;
}

// forward butterfly k of bit q; Tile has get(e) and set(e, Fe)
template <class Tile>
QHD void ntt_bfly_dif(Tile& t, const NttPass& p, const uint32_t* tw,
                      long long g, int q, int k) {
  int e0, e1;
  long long j;
  ntt_pair(p, g, q, k, &e0, &e1, &j);
  const Fe w = fe_load16(tw + 8 * (ntt_tw_row(p.b0 + q) + j));
  const Fe u = t.get(e0), v = t.get(e1);
  t.set(e0, fe_add<FrM>(u, v));
  t.set(e1, fe_mul<FrM>(fe_sub<FrM>(u, v), w));
}

// inverse butterfly k of bit q: entry 2^b - j is -w^-j, so the sum and the
// difference trade places
template <class Tile>
QHD void ntt_bfly_dit(Tile& t, const NttPass& p, const uint32_t* tw,
                      long long g, int q, int k) {
  int e0, e1;
  long long j;
  ntt_pair(p, g, q, k, &e0, &e1, &j);
  const int b = p.b0 + q;
  const Fe w = fe_load16(tw + 8 * (ntt_tw_row(b) + (1ll << b) - j));
  const Fe u = t.get(e0), v = fe_mul<FrM>(t.get(e1), w);
  t.set(e0, fe_sub<FrM>(u, v));
  t.set(e1, fe_add<FrM>(u, v));
}

// entry j of twiddle row b from roots[m] = a primitive 2^m-th root of
// unity (Montgomery form, m <= logn): the product of roots[b + 1 - i] over
// the set bits i of j
template <class Roots>
QHD Fe ntt_twiddle(const Roots& roots, int b, long long j) {
  Fe r = fe_one<FrM>();
  for (int i = 0; j != 0; ++i, j >>= 1)
    if (j & 1) r = fe_mul<FrM>(r, roots[b + 1 - i]);
  return r;
}

// row b of flat index idx of the table
QHD int ntt_tw_row_of(long long idx) {
  int b = 0;
  while (ntt_tw_row(b + 1) <= idx) ++b;
  return b;
}

}  // namespace bn254
