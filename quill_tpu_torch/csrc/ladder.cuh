// The thread body of kernel E's shifted basis (csrc/msm5.cu:
// shifted_basis_kernel), shared with its host emulation (bn254_host.cpp:
// q_shifted_basis).
//
// Replaces quill_tpu/ec/msm3.py:90 _shift_doubling (one
// fields/pallas8.py:475 _stacked_combine_kernel launch a doubling) and the
// batch normalisation after it.  For point i of n, window w of nwin holds
// 2^(wbits w) P_i as an affine row; a point at infinity is replaced by the
// generator (1, 2).
//
// One thread owns one base point through all its windows.  It runs nwin - 1
// rounds of wbits doublings in registers (g1_dbl, 8 products against
// g1_add's 12), writes each window's X and Y to the window's output row and
// its Z and the product of the Zs before it to a scratch row, then
// normalises its own windows by Montgomery's trick: one inversion of the
// product of the Zs (fe_inv, 366 products), then back down, 5 products a
// window point in all.  The prefixes live in the scratch rows, not in an
// array indexed at run time, which would go to local memory.  No Z is 0:
// 2^k P_i is never the identity in a group of prime order, so nothing checks
// for it.  Each row is 64 bytes of one thread, neighbouring threads on
// neighbouring rows.
//
// Products a point: (nwin - 1) (8 wbits + 5) + 366, 2,437 at the small
// route's (20, 13) and 2,361 at v6's (16, 16); 247 adds of P + P would take
// 2,964 before any normalisation.  Bound on the card: those products'
// IMADs; the bytes, 65 read and 64 nwin written a point, are ~20x fewer
// operations' worth.
#pragma once

#include "bn254.cuh"

namespace bn254 {

// Point i of n.  Its chunk of `chunk` points (the last one ragged) is laid
// out window-major: window w of point i is row c0 nwin + w nc + (i - c0),
// c0 the chunk's first point and nc its size.  Scratch row (w - 1) n + i
// holds Z_w and Z_1 ... Z_(w-1).  Rows are 16 words.
QHD void shifted_point(const uint32_t* xy, const uint8_t* inf, long long i,
                       long long n, long long chunk, int nwin, int wbits,
                       uint32_t* out, uint32_t* scratch) {
  const long long c0 = i - i % chunk;
  const long long nc = n - c0 < chunk ? n - c0 : chunk;
  uint32_t* row = out + 16 * (c0 * nwin + (i - c0));
  const long long step = 16 * nc;
  G1P p;
  p.z = fe_one<FqM>();
  if (inf[i]) {
    p.x = p.z;
    p.y = fe_add<FqM>(p.z, p.z);
  } else {
    p.x = fe_load16(xy + 16 * i);
    p.y = fe_load16(xy + 16 * i + 8);
  }
  fe_store16(row, p.x);
  fe_store16(row + 8, p.y);
  Fe pre = p.z;
#pragma unroll 1
  for (int w = 1; w < nwin; ++w) {
#pragma unroll 1
    for (int b = 0; b < wbits; ++b) p = g1_dbl(p);
    uint32_t* s = scratch + 16 * ((long long)(w - 1) * n + i);
    fe_store16(row + w * step, p.x);
    fe_store16(row + w * step + 8, p.y);
    fe_store16(s, p.z);
    fe_store16(s + 8, pre);
    pre = fe_mul<FqM>(pre, p.z);
  }
  Fe inv = fe_inv<FqM>(pre);
#pragma unroll 1
  for (int w = nwin - 1; w >= 1; --w) {
    const uint32_t* s = scratch + 16 * ((long long)(w - 1) * n + i);
    const Fe zinv = fe_mul<FqM>(inv, fe_load16(s + 8));
    inv = fe_mul<FqM>(inv, fe_load16(s));
    uint32_t* r = row + w * step;
    fe_store16(r, fe_mul<FqM>(fe_load16(r), zinv));
    fe_store16(r + 8, fe_mul<FqM>(fe_load16(r + 8), zinv));
  }
}

}  // namespace bn254
