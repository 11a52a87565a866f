// Kernel J's thread and block bodies (csrc/fixed_base.cu: fixed_base_kernel),
// shared with their host emulation (bn254_host.cpp: q_fixed_base_blocked).
//
// Replaces quill_tpu/ec/fixed_base.py:90 _k_fixed_base_chunk (XLA: 64
// complete adds of four-bit digits a point, a chunk of 2^16 points a
// program) and :158 _batch_normalize (XLA).  out[i] = s_i G as an affine
// row, for canonical scalars s_i.
//
// Signed windows of w bits (1 <= w <= FB_WMAX): nwin = ceil(255 / w)
// windows, so that the top window never carries out; digit k is bits [w k,
// w k + w) plus the carry of the one below, and a digit above 2^(w-1)
// becomes d - 2^w with a carry of 1, so |d| <= 2^(w-1).  The table holds
// 2^(w-1) affine rows a window, row k 2^(w-1) + |d| - 1 = |d| 2^(w k) G
// (16 words: x, y in Montgomery form); a negative digit negates y.  A zero
// digit is skipped, the first nonzero one is loaded and every later one
// added by the mixed add (bn254.cuh: g1_add_mixed, 11 products against
// g1_add's 12), whose formula is complete, so a partial sum may be the
// identity.  The table is read through L2: 2^(w-1) nwin 64 bytes, 5.2 MB at
// w = 13.
//
// A block of FB_NT threads owns span = FB_NT ppt consecutive points (ppt <=
// FB_PPT points a thread, fewer where the launch is too small to fill the
// card: `fb_ppt`), point r of the block in slot r, thread t computing slots
// j FB_NT + t (j < ppt) one after another with one copy of the add.  Then
// Montgomery's trick over the block: each thread's running products c_j of its own Z's
// (in its own memory), a product tree over the FB_NT thread totals in
// shared memory (a heap: node v = node 2v times node 2v + 1), one inversion
// of the root by one thread, the tree back down (the inverse of a child is
// its parent's inverse times its sibling), and each thread's Z^-1 from its
// total's inverse and its c_j.  x = X Z^-1 and y = Y Z^-1 go back to the
// slots, and the block copies them out as 16-byte pieces, neighbouring
// threads on neighbouring pieces of contiguous rows.  About 5 products a
// point (1 up, 2 down, x and y) and one inversion a block.
//
// A point at infinity (s = 0 mod r) cannot be normalised: the block takes
// Z = 1 for it, writes (0, 0) and sets the error flag, which the wrapper
// raises on.  Bound on the card: the products' integer multiply-adds, (nwin
// - 1) 11 + ~5 a point; the bytes (32 read, 64 written) are ~1% of it.
#pragma once

#include "bn254.cuh"
#include "tree.cuh"

#define FB_NT 128    // threads a block
#define FB_PPT 4     // points a thread, at most
#define FB_SPAN (FB_NT * FB_PPT)  // points a block, at most
#define FB_WMAX 16   // widest window
#define FB_SLOT 24   // words of a slot: X, Y, Z, then x, y

namespace bn254 {

// windows of width w: ceil(255 / w), so that the top digit never carries
QHD int fb_windows(int w) { return (255 + w - 1) / w; }

// words of a block's shared memory: the slots, then the heap (2 FB_NT
// elements, node 0 unused)
QHD int fb_words() { return FB_SLOT * FB_SPAN + 2 * 8 * FB_NT; }

// Signed digit k of the canonical scalar s (8 words), from the carry of
// digit k - 1; sets the carry for digit k + 1.
QHD int fb_digit(const uint32_t* s, int w, int k, uint32_t* carry) {
  const int b = w * k, limb = b >> 5, sh = b & 31;
  uint32_t v = s[limb] >> sh;
  if (sh + w > 32 && limb + 1 < 8) v |= s[limb + 1] << (32 - sh);
  const int d = (int)(v & ((1u << w) - 1u)) + (int)*carry;
  if (d > (1 << (w - 1))) {
    *carry = 1u;
    return d - (1 << w);
  }
  *carry = 0u;
  return d;
}

// s G: the windows' table rows, the first nonzero one loaded and each
// later one added; the identity for s = 0
QHD G1P fb_point(const uint32_t* s, const uint32_t* table, int w, int nwin) {
  const long long half = 1LL << (w - 1);
  uint32_t carry = 0u;
  bool have = false;
  G1P acc = g1_identity();
#pragma unroll 1
  for (int k = 0; k < nwin; ++k) {
    const int d = fb_digit(s, w, k, &carry);
    if (d == 0) continue;
    const uint32_t* row = table + 16 * (k * half + (d < 0 ? -d : d) - 1);
    G1A q;
    q.x = fe_load16(row);
    q.y = fe_load16(row + 8);
    if (d < 0) q.y = fe_neg<FqM>(q.y);
    if (have) {
      acc = g1_add_mixed(acc, q);
    } else {
      acc = g1_from_affine(q);
      have = true;
    }
  }
  return acc;
}

QHD uint32_t* fb_slot(uint32_t* sh, int r) { return sh + FB_SLOT * r; }

QHD Fe* fb_heap(uint32_t* sh, int v) {
  return reinterpret_cast<Fe*>(sh + FB_SLOT * FB_SPAN) + v;
}

// Points a thread for a launch over n points on `sms` SMs: FB_PPT, halved
// while the blocks would not give every SM `minb` of them
QHD int fb_ppt(long long n, int sms, int minb) {
  int ppt = FB_PPT;
  while (ppt > 1 &&
         (n + FB_NT * ppt - 1) / (FB_NT * ppt) < (long long)minb * sms)
    ppt >>= 1;
  return ppt;
}

// Phase 1, slot r of block b (span points a block): point b span + r into
// the slot as (X, Y, Z); past n, or at infinity, (0, 0, 1).  Returns true
// for a point at infinity.
QHD bool fb_compute(const uint32_t* scalars, long long n,
                    const uint32_t* table, int w, int nwin, long long b,
                    int span, int r, uint32_t* sh) {
  const long long i = b * span + r;
  G1P p;
  bool bad = false;
  if (i < n) {
    p = fb_point(scalars + 8 * i, table, w, nwin);
    bad = fe_is_zero(p.z);
  }
  if (i >= n || bad) {
    p.x = fe_zero<FqM>();
    p.y = p.x;
    p.z = fe_one<FqM>();
  }
  pt_st(fb_slot(sh, r), p);
  return bad;
}

// Phase 2, thread t: c[j] = Z of its slots 0..j (j < ppt), the total to
// heap leaf FB_NT + t
QHD void fb_chain(uint32_t* sh, int t, int ppt, Fe* c) {
  Fe acc = fe_load16(fb_slot(sh, t) + 16);
  c[0] = acc;
#pragma unroll 1
  for (int j = 1; j < ppt; ++j) {
    acc = fe_mul<FqM>(acc, fe_load16(fb_slot(sh, j * FB_NT + t) + 16));
    c[j] = acc;
  }
  *fb_heap(sh, FB_NT + t) = acc;
}

// Phase 3, node v (1 <= v < FB_NT) of the tree up
QHD void fb_heap_up(uint32_t* sh, int v) {
  *fb_heap(sh, v) = fe_mul<FqM>(*fb_heap(sh, 2 * v), *fb_heap(sh, 2 * v + 1));
}

// Phase 4, one thread: the root's inverse, by Fermat's little theorem as
// bn254.cuh's fe_inv (the same products in the same order) with the
// exponent's words in a rolled loop, so that the product's code appears
// twice, not sixteen times
QHD uint32_t fq_pm2_word(int i) {
  switch (i) {
    case 0: return 0xd87cfd45u;  // p - 2, low word
    case 1: return 0x3c208c16u;
    case 2: return 0x6871ca8du;
    case 3: return 0x97816a91u;
    case 4: return 0x8181585du;
    case 5: return 0xb85045b6u;
    case 6: return 0xe131a029u;
    default: return 0x30644e72u;
  }
}

QHD void fb_heap_invert(uint32_t* sh) {
  const Fe a = *fb_heap(sh, 1);
  Fe r = fe_one<FqM>();
#pragma unroll 1
  for (int i = 7; i >= 0; --i) {
    const uint32_t e = fq_pm2_word(i);
#pragma unroll 1
    for (int bit = 31; bit >= 0; --bit) {
      r = fe_mul<FqM>(r, r);
      if ((e >> bit) & 1u) r = fe_mul<FqM>(r, a);
    }
  }
  *fb_heap(sh, 1) = r;
}

// Phase 5, node v (1 <= v < FB_NT) of the tree down: its children's
// inverses from its own
QHD void fb_heap_down(uint32_t* sh, int v) {
  const Fe inv = *fb_heap(sh, v);
  const Fe a = *fb_heap(sh, 2 * v), b = *fb_heap(sh, 2 * v + 1);
  *fb_heap(sh, 2 * v) = fe_mul<FqM>(inv, b);
  *fb_heap(sh, 2 * v + 1) = fe_mul<FqM>(inv, a);
}

// Phase 6, thread t: from the inverse of its total, slot j's Z^-1 =
// (c[j])^-1 c[j - 1], then x and y into the slot's first 16 words
QHD void fb_back(uint32_t* sh, int t, int ppt, const Fe* c) {
  Fe inv = *fb_heap(sh, FB_NT + t);
#pragma unroll 1
  for (int j = ppt - 1; j >= 0; --j) {
    uint32_t* s = fb_slot(sh, j * FB_NT + t);
    Fe zinv = inv;
    if (j > 0) {
      zinv = fe_mul<FqM>(inv, c[j - 1]);
      inv = fe_mul<FqM>(inv, fe_load16(s + 16));
    }
    fe_store16(s, fe_mul<FqM>(fe_load16(s), zinv));
    fe_store16(s + 8, fe_mul<FqM>(fe_load16(s + 8), zinv));
  }
}

// Phase 7, piece i (0 .. 4 span) of block b: out row b span + i / 4,
// 16-byte piece i % 4, below n
QHD void fb_store(uint32_t* out, long long n, long long b, int span, int i,
                  const uint32_t* sh) {
  const int r = i >> 2, c = i & 3;
  const long long row = b * span + r;
  if (row < n) piece_copy(out + 16 * row + 4 * c, sh + FB_SLOT * r + 4 * c);
}

QHD long long fb_blocks(long long n, int ppt) {
  return (n + FB_NT * ppt - 1) / (FB_NT * ppt);
}

}  // namespace bn254
