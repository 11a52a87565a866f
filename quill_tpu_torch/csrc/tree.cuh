// The prefix tree's thread bodies and staging maps: kernels G and H
// (csrc/msm5.cu: tree_up_kernel, tree_down_kernel, tree_top_kernel) and the
// affine leaf level of kernels F and K (tree_leaf_kernel), shared with
// their host emulation (bn254_host.cpp: q_tree_up_blocked,
// q_tree_down_blocked, q_tree_top, q_tree_leaf_blocked).
//
// Replaces quill_tpu/ec/msm3.py:258 _up_kernel and :267 _down_kernel, one
// level a launch, and the fused top levels of quill_tpu/ec/msm3.py:361
// _k_treetop_up and :391 _k_treetop_down.  The tree is ec/msm5.py's: level
// l + 1 node j = x[2j] + x[2j+1], an odd level padded with the identity
// (0 : 1 : 0) and the add still done, so that every triple is the one the
// one-level chain of plain twins gives; prefixes P[2j+1] = P'[j] and P[2j] =
// P'[j] - U[2j+1], P' the prefixes of the level above.
//
// Wide levels (more than TREE_TOP points) go two a launch (L = 2; L = 1 is
// the one-level launch).  A block copies its span of S points into shared
// memory with 16-byte pieces, neighbouring threads on neighbouring pieces
// of contiguous rows, slot r for row r (4 words of padding after every 4
// slots keep a quarter warp's 16-byte accesses on distinct banks).  Rows
// past a level's end load as the identity, so the pad of an odd level
// needs no branch.  Then the block adds the first level's pairs in the
// slots, a barrier, the second level's, and copies both out, coalesced.
// H's prefixes P[2j+1] = P'[j] are loaded into their output slots, so no
// copy of one is live across an add.
//
// What the card taught (quill_tpu_torch/probe_tree.py): an add is ~13,000
// instructions of unrolled CIOS code, ~200 KB, more than the SM's
// instruction cache, so a kernel keeps one copy of it: the items of both
// levels run in one loop, one add a thread a round, a barrier after each
// (three adds a thread in one body took 218 registers and 1.7x the time).
// Levels of at most TREE_LANE_LEVEL points do not fill the card with an add
// a thread, and one thread's add takes as long as its 12 products in a
// row; there a group of six lanes shares each add (g1_add_lanes: each lane
// one product of each of g1_add's two layers of six), ~2 products' time.
//
// The leaf level (F: quill_tpu/ec/msm5.py:245 _up0_kernel; K:
// quill_tpu/ec/msm6k.py:58 _lvl0_kernel): node j = sh[idx[2j]] +
// sh[idx[2j+1]], affine rows of the shifted basis gathered through the
// sort's index, 9 products (g1_add_affine).  A block of LEAF_NT threads
// copies its pairs' leaves into shared memory with cp.async, four
// neighbouring threads on the four 16-byte pieces of one 64-byte row, so
// that a random gather still uses every sector it fetches whole; then one
// add a thread in the slots, and the sums out as coalesced pieces.  Blocks
// of 256 threads, 2 an SM, as G's.  Level 2 in the same launch, with one
// copy of g1_finish shared by the two adds, was tried and dropped: on an
// H100 the whole prefix tree took 4.29-4.31 ms with it against 3.88-3.90
// ms without, a v6 MSM 8.9-9.2 ms against 8.8 (PERF.md).
//
// The fused top: one block holds a level of at most TREE_TOP points and
// every level above it in shared memory, runs the up-sweep to one point
// and the down-sweep back, and writes the level's prefixes (tree mode).
// Reduce mode is the same body stopped after the up-sweep: each block sums
// an aligned span of 2^s points, which is the pairwise tree's order.  A
// level's adds go one a thread while they are many, else one a group.
//
// Bound on the card: the adds' integer products (12 CIOS products, 3,168
// 32-bit multiply-adds an add); the bytes (G: 4 points in, 3 out; H: 4 in,
// 4 out) are a few percent of it.
#pragma once

#include "bn254.cuh"

#define TREE_NT 256      // threads of a wide block, adds by threads
#define TREE_LANE_NT 128  // threads of a wide block, adds by lanes
#define TREE_TOP 512     // widest level of the fused top, and its span
#define TREE_TOP_NT 256  // threads of the fused top

namespace bn254 {

constexpr int PT_WORDS = 24;

// 16-byte piece c (0-5) of a point: copy, or the identity's
QHD void piece_copy(uint32_t* dst, const uint32_t* src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
  for (int i = 0; i < 4; ++i) dst[i] = src[i];
#endif
}

QHD void piece_identity(uint32_t* dst, int c) {
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = c == 2 ? FqM::one(i) : c == 3 ? FqM::one(4 + i) : 0u;
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
#else
  for (int i = 0; i < 4; ++i) dst[i] = v[i];
#endif
}

QHD G1P pt_ld(const uint32_t* p) {
  G1P r;
  r.x = fe_load16(p);
  r.y = fe_load16(p + 8);
  r.z = fe_load16(p + 16);
  return r;
}

QHD void pt_st(uint32_t* p, const G1P& a) {
  fe_store16(p, a.x);
  fe_store16(p + 8, a.y);
  fe_store16(p + 16, a.z);
}

QHD G1P pt_ld_neg(const uint32_t* p) {
  G1P r = pt_ld(p);
  r.y = fe_neg<FqM>(r.y);
  return r;
}

// ---------------------------------------------------------------------------
// one add split over the six lanes of a group (the fused top's narrow levels)
// ---------------------------------------------------------------------------

// g1_add's two layers of six independent products, lane g (0-5) taking
// product g of each; the adds between them are done by every lane.  The
// same operations in the same order as g1_add, so the same triple.

// layer 1, lane g: t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, (X1 + Y1)(X2 + Y2),
// (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2)
QHD Fe lane_factor1(const G1P& p, int g) {
  const Fe a0 = (g == 1 || g == 4) ? p.y : g == 2 ? p.z : p.x;
  const Fe a1 = g == 3 ? p.y : p.z;
  const Fe s = fe_add<FqM>(a0, a1);
  return g < 3 ? a0 : s;
}

QHD Fe lane_mul1(const G1P& p, const G1P& q, int g) {
  return fe_mul<FqM>(lane_factor1(p, g), lane_factor1(q, g));
}

struct LaneMid {
  Fe t0, t1, t3, t4, y3, z3;
};

// g1_add between its layers, from the six layer-1 products
QHD LaneMid lane_mid(const Fe* P) {
  LaneMid m;
  m.t3 = fe_sub<FqM>(P[3], fe_add<FqM>(P[0], P[1]));
  m.t4 = fe_sub<FqM>(P[4], fe_add<FqM>(P[1], P[2]));
  const Fe y3 = fe_sub<FqM>(P[5], fe_add<FqM>(P[0], P[2]));
  m.t0 = fe_add<FqM>(fe_add<FqM>(P[0], P[0]), P[0]);
  const Fe t2 = fq_mul_b3(P[2]);
  m.z3 = fe_add<FqM>(P[1], t2);
  m.t1 = fe_sub<FqM>(P[1], t2);
  m.y3 = fq_mul_b3(y3);
  return m;
}

// layer 2 (g1_finish), lane g: t4 y3, t3 t1, y3 t0, t1 z3, t0 t3, z3 t4
QHD Fe lane_mul2(const LaneMid& m, int g) {
  const Fe a = g == 0 ? m.t4 : g == 1 ? m.t3 : g == 2 ? m.y3
             : g == 3 ? m.t1 : g == 4 ? m.t0 : m.z3;
  const Fe b = g == 0 ? m.y3 : g == 1 ? m.t1 : g == 2 ? m.t0
             : g == 3 ? m.z3 : g == 4 ? m.t3 : m.t4;
  return fe_mul<FqM>(a, b);
}

QHD G1P lane_finish(const Fe* R) {
  G1P r;
  r.x = fe_sub<FqM>(R[1], R[0]);
  r.y = fe_add<FqM>(R[3], R[2]);
  r.z = fe_add<FqM>(R[5], R[4]);
  return r;
}

// the six lanes' steps in turn, as one thread (the host's emulation)
QHD G1P g1_add_split(const G1P& p, const G1P& q) {
  Fe P[6];
  for (int g = 0; g < 6; ++g) P[g] = lane_mul1(p, q, g);
  const LaneMid m = lane_mid(P);
  for (int g = 0; g < 6; ++g) P[g] = lane_mul2(m, g);
  return lane_finish(P);
}

#ifdef __CUDACC__
// Lane g of a group of six in one warp; xs the group's 48 words of shared
// scratch.  Every lane of the warp calls it together (__syncwarp).
__device__ __forceinline__ G1P g1_add_lanes(const G1P& p, const G1P& q,
                                            int g, uint32_t* xs) {
  Fe P[6];
  fe_store16(xs + 8 * g, lane_mul1(p, q, g));
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 6; ++k) P[k] = fe_load16(xs + 8 * k);
  __syncwarp();
  const LaneMid m = lane_mid(P);
  fe_store16(xs + 8 * g, lane_mul2(m, g));
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 6; ++k) P[k] = fe_load16(xs + 8 * k);
  __syncwarp();
  return lane_finish(P);
}
#endif

// ---------------------------------------------------------------------------
// wide levels: slots, staging maps, work items
// ---------------------------------------------------------------------------

// A block's slots: S points (S = 2^L TREE_NT, or TREE_LANE_SPAN when two
// levels' adds go one a group of six lanes), slot r at 24 r + 4 floor(r / 4)
// words (4 words of padding after every 4 points).
#define TREE_LANE_SPAN 32       // 16 and 8 adds: one round of the groups
#define TREE_LANE_LEVEL 65536   // two-level launches by lanes up to this m
#define TREE_LANE_GROUPS (TREE_LANE_NT / 32 * 5)

constexpr QHD int tree_span(int L, bool lanes) {
  return lanes ? TREE_LANE_SPAN : TREE_NT << L;
}

// a two-level launch over m points goes by lanes where the level is too
// narrow to fill the card with an add a thread, whose latency is 12
// products
QHD bool tree_lanes(long long m) { return m <= TREE_LANE_LEVEL; }

// words of a block's slots, and (lanes) the groups' scratch after them
QHD int tree_words(int S, bool lanes) {
  return 25 * S + (lanes ? TREE_LANE_NT / 32 * 6 * 48 : 0);
}

QHD uint32_t* tree_slot(uint32_t* sh, int r) {
  return sh + PT_WORDS * r + 4 * (r >> 2);
}

QHD const uint32_t* tree_slot(const uint32_t* sh, int r) {
  return sh + PT_WORDS * r + 4 * (r >> 2);
}

// blocks of a launch over a level of m points (G) or that level's m
// prefixes (H)
QHD long long tree_blocks(int S, long long m) { return (m + S - 1) / S; }

// piece i (0 .. 6 S) of block b: slot i / 6, 16-byte piece i % 6
QHD int tree_pieces(int S) { return 6 * S; }

// G's load: slot r <- x[S b + r], the identity at or past m
QHD void up_load(int S, const uint32_t* x, long long m, long long b, int i,
                 uint32_t* sh) {
  const int r = i / 6, c = i % 6;
  const long long row = b * S + r;
  uint32_t* dst = tree_slot(sh, r) + 4 * c;
  if (row < m)
    piece_copy(dst, x + PT_WORDS * row + 4 * c);
  else
    piece_identity(dst, c);
}

// G's work, phase 1 (level l + 1): item k adds slots 2k and 2k + 1 into
// slot 2k.  Phase 2 (L = 2, level l + 2): item k adds slots 4k and 4k + 2
// (level l + 1's nodes 2k, 2k + 1) into slot 4k + 1.  An item whose first
// input lies past m is skipped: its slots hold the identity, which is the
// identity's sum with itself.  S >> phase items a phase.
QHD bool up_item_live(int S, long long m, long long b, int phase, int k) {
  return b * S + ((long long)k << phase) < m;
}

QHD void up_item_operands(const uint32_t* sh, int phase, int k, G1P* p,
                          G1P* q) {
  const int f = k << phase;  // 2k or 4k, then 2k + 1 or 4k + 2
  *p = pt_ld(tree_slot(sh, f));
  *q = pt_ld(tree_slot(sh, f + phase));
}

QHD void up_item_store(uint32_t* sh, int phase, int k, const G1P& r) {
  pt_st(tree_slot(sh, (k << phase) + phase - 1), r);
}

QHD void up_item(uint32_t* sh, int phase, int k) {
  G1P p, q;
  up_item_operands(sh, phase, k, &p, &q);
  up_item_store(sh, phase, k, g1_add(p, q));
}

// G's store, piece i of block b: o1[S b / 2 + k] (level l + 1, ceil(m / 2)
// rows) from slot 2k, then for L = 2 o2[S b / 4 + k] (level l + 2, ceil(m
// / 4) rows) from slot 4k + 1.
QHD int up_store_pieces(int L, int S) { return L == 1 ? 3 * S : 9 * S / 2; }

QHD void up_store(int S, uint32_t* o1, uint32_t* o2, long long m,
                  long long b, int i, const uint32_t* sh) {
  const int half = S / 2, c = i % 6;
  int k = i / 6, slot;
  long long row, rows;
  uint32_t* dst;
  if (k < half) {
    slot = 2 * k;
    row = b * half + k, rows = (m + 1) >> 1, dst = o1;
  } else {
    k -= half;
    slot = 4 * k + 1;
    row = b * (half / 2) + k, rows = (m + 3) >> 2, dst = o2;
  }
  if (row < rows) piece_copy(dst + PT_WORDS * row + 4 * c,
                             tree_slot(sh, slot) + 4 * c);
}

// H's load, block b of the m prefixes of level l: slot r ends as P[S b +
// r].  L = 1 (p: the k prefixes of level l + 1; u0: level l): slot 2k + 1
// <- p[S b / 2 + k] (already its prefix, P[2j+1] = P'[j]), slot 2k <-
// u0[2 (S b / 2 + k) + 1].  L = 2 (p: prefixes of level l + 2; u1: level l
// + 1, ceil(m / 2) rows): slot 4k + 3 <- p[S b / 4 + k], slot 4k + 1 <-
// u1[2 (S b / 4 + k) + 1], slot 2k <- u0[2 (S b / 2 + k) + 1].  Rows past
// a level's end read as the identity (the pad of an odd level).
QHD void down_load(int L, int S, const uint32_t* p, const uint32_t* u1,
                   const uint32_t* u0, long long m, long long b, int i,
                   uint32_t* sh) {
  const int r = i / 6, c = i % 6;
  const uint32_t* src;
  long long row, rows;
  if ((r & 1) == 0) {
    src = u0, row = 2 * (b * S / 2 + r / 2) + 1, rows = m;
  } else if (L == 1) {
    src = p, row = b * S / 2 + r / 2, rows = (m + 1) >> 1;
  } else if ((r & 3) == 3) {
    src = p, row = b * S / 4 + r / 4, rows = (m + 3) >> 2;
  } else {
    src = u1, row = 2 * (b * S / 4 + r / 4) + 1, rows = (m + 1) >> 1;
  }
  uint32_t* dst = tree_slot(sh, r) + 4 * c;
  if (row < rows)
    piece_copy(dst, src + PT_WORDS * row + 4 * c);
  else
    piece_identity(dst, c);
}

// H's work.  Phase 1 (L = 2, level l + 1's prefixes): item k, slot 4k + 1
// <- slot 4k + 3 - slot 4k + 1 (P'[2k] = P''[k] - U'[2k+1]; P'[2k+1] =
// P''[k] is slot 4k + 3 already).  Phase 2: item k, slot 2k <- slot 2k + 1
// - slot 2k.  The prefix that is copied (P[2k+1]) is in place before the
// add, so no copy of it is live across it.  S >> (3 - phase) items a phase.
QHD bool down_item_live(int S, long long m, long long b, int phase, int k) {
  return b * S + ((long long)k << (3 - phase)) < m;
}

// the slot item k of a phase writes: 4k + 1 or 2k; its prefix is 2 or 1
// slot after it
QHD int down_item_slot(int phase, int k) {
  return (k << (3 - phase)) + 2 - phase;
}

QHD void down_item_operands(const uint32_t* sh, int phase, int k, G1P* p,
                            G1P* q) {
  const int o = down_item_slot(phase, k);
  *p = pt_ld(tree_slot(sh, o + 3 - phase));
  *q = pt_ld_neg(tree_slot(sh, o));
}

QHD void down_item_store(uint32_t* sh, int phase, int k, const G1P& r) {
  pt_st(tree_slot(sh, down_item_slot(phase, k)), r);
}

QHD void down_item(uint32_t* sh, int phase, int k) {
  G1P p, q;
  down_item_operands(sh, phase, k, &p, &q);
  down_item_store(sh, phase, k, g1_add(p, q));
}

// H's store: out[S b + r] from slot r, below m
QHD void down_store(int S, uint32_t* out, long long m, long long b, int i,
                    const uint32_t* sh) {
  const int r = i / 6, c = i % 6;
  const long long row = b * S + r;
  if (row < m) piece_copy(out + PT_WORDS * row + 4 * c,
                          tree_slot(sh, r) + 4 * c);
}

// ---------------------------------------------------------------------------
// the affine leaf level (kernels F and K)
// ---------------------------------------------------------------------------

// 16-byte piece copy from device memory into shared memory: cp.async on the
// card (LDGSTS, no registers between), so that the gather's loads are all
// in flight at once; a plain copy on the host.  leaf_wait waits for the
// thread's own copies; a barrier then makes the block's visible.
QHD void piece_copy_async(uint32_t* dst, const uint32_t* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
#else
  for (int i = 0; i < 4; ++i) dst[i] = src[i];
#endif
}

QHD void leaf_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// A block's slots: pair r's two affine leaves (16 words each) at LEAF_SLOT
// r words, 4 words of padding after them, so that a quarter warp's 16-byte
// accesses to 8 slots fall on distinct banks.  A block takes LEAF_NT
// pairs, one add a thread, and stores each sum over its pair's leaves (24
// of the slot's words).
#define LEAF_NT 256
#define LEAF_SLOT 36

constexpr QHD int leaf_words() { return LEAF_SLOT * LEAF_NT; }

QHD uint32_t* leaf_slot(uint32_t* sh, int r) { return sh + LEAF_SLOT * r; }

QHD const uint32_t* leaf_slot(const uint32_t* sh, int r) {
  return sh + LEAF_SLOT * r;
}

// the row of the basis that leaf e (0 or 1) of pair g reads: idx[2g + e],
// or 2g + e where there is no index (contiguous leaves)
QHD long long leaf_row(const int* idx, long long g, int e) {
  return idx != nullptr ? (long long)idx[2 * g + e] : 2 * g + e;
}

// The gather, piece i (0 .. 8 LEAF_NT) of block b: pair r = i / 8, its
// leaf e = i / 4 % 2, 16-byte quarter i % 4, from the basis row
// leaf_row(idx, LEAF_NT b + r, e) into slot r's words 16 e + 4 (i % 4):
// four neighbouring threads copy one 64-byte row, so every sector fetched
// is used whole.  Pairs at or past k load nothing.
QHD void leaf_load(const uint32_t* sh, const int* idx, long long k,
                   long long b, int i, uint32_t* s) {
  const int r = i >> 3, c = i & 7;
  const long long g = b * LEAF_NT + r;
  if (g < k)
    piece_copy_async(leaf_slot(s, r) + 4 * c,
                     sh + 16 * leaf_row(idx, g, c >> 2) + 4 * (c & 3));
}

// The thread body: pair j of the block, live while LEAF_NT b + j < k,
// summed by g1_add_affine (9 products) into its slot.
QHD void leaf_pair(uint32_t* s, int j) {
  uint32_t* a = leaf_slot(s, j);
  G1A p, q;
  p.x = fe_load16(a);
  p.y = fe_load16(a + 8);
  q.x = fe_load16(a + 16);
  q.y = fe_load16(a + 24);
  pt_st(a, g1_add_affine(p, q));
}

// The store, piece i (0 .. 6 LEAF_NT) of block b: out[LEAF_NT b + i / 6]'s
// 16-byte piece i % 6 from slot i / 6, below k.
QHD void leaf_store(uint32_t* out, long long k, long long b, int i,
                    const uint32_t* s) {
  const int r = i / 6, c = i % 6;
  const long long row = b * LEAF_NT + r;
  if (row < k)
    piece_copy(out + PT_WORDS * row + 4 * c, leaf_slot(s, r) + 4 * c);
}

// ---------------------------------------------------------------------------
// the fused top
// ---------------------------------------------------------------------------

// Level k of a top over w points: its first slot and its size; an odd
// level below the top has a pad slot after it.
QHD void top_level(int w, int k, int* off, int* size) {
  int o = 0, s = w;
  for (int i = 0; i < k; ++i) {
    o += s + (s & 1);
    s = (s + 1) >> 1;
  }
  *off = o;
  *size = s;
}

// levels of a top over w >= 1 points (the base and the single point
// included), and its slots
QHD int top_levels(int w) {
  int k = 1;
  for (int s = w; s > 1; s = (s + 1) >> 1) ++k;
  return k;
}

QHD int top_slots(int w) {
  int off, size;
  top_level(w, top_levels(w) - 1, &off, &size);
  return off + 1;
}

// shared memory of a top over w points: its slots, then 48 words of
// scratch for each group of six lanes (six a warp, the last one short)
QHD int top_bytes(int w) {
  return 4 * (PT_WORDS * top_slots(w) + TREE_TOP_NT / 32 * 6 * 48);
}

// A level's adds in the fused top: one a thread while they are more than
// TREE_TOP_LANE_MAX, else one a group of six lanes (g1_add_lanes), in
// rounds of TREE_TOP_GROUPS groups (five a warp).
#define TREE_TOP_GROUPS (TREE_TOP_NT / 32 * 5)
#define TREE_TOP_LANE_MAX (2 * TREE_TOP_GROUPS)

// up-sweep, node j of the level above level (off, s): p + q, q the pad
// (identity) of an odd level past its end
QHD void top_up_operands(const uint32_t* sh, int off, int s, int j, G1P* p,
                         G1P* q) {
  const uint32_t* a = sh + PT_WORDS * (off + 2 * j);
  *p = pt_ld(a);
  *q = 2 * j + 1 < s ? pt_ld(a + PT_WORDS) : g1_identity();
}

// ... stored at off1 + j; the pad slot is written for the down-sweep
QHD void top_up_store(uint32_t* sh, int off, int s, int off1, int j,
                      const G1P& r) {
  if (2 * j + 1 == s) pt_st(sh + PT_WORDS * (off + s), g1_identity());
  pt_st(sh + PT_WORDS * (off1 + j), r);
}

// down-sweep, item j of level (off, s), the prefixes of the level above at
// off1: P'[j] + (-U[2j+1])
QHD void top_down_operands(const uint32_t* sh, int off, int off1, int j,
                           G1P* p, G1P* q) {
  *p = pt_ld(sh + PT_WORDS * (off1 + j));
  *q = pt_ld_neg(sh + PT_WORDS * (off + 2 * j + 1));
}

// ... slot 2j + 1 <- P'[j], slot 2j <- the sum
QHD void top_down_store(uint32_t* sh, int off, int off1, int j,
                        const G1P& r) {
  const uint32_t* p = sh + PT_WORDS * (off1 + j);
  uint32_t* a = sh + PT_WORDS * (off + 2 * j);
  for (int c = 0; c < 6; ++c) piece_copy(a + PT_WORDS + 4 * c, p + 4 * c);
  pt_st(a, r);
}

// ---------------------------------------------------------------------------
// kernel E's add
// ---------------------------------------------------------------------------

#define ADD_LANE_SPAN TREE_LANE_GROUPS  // E's add by lanes: one round a block

// Kernel E's add (csrc/msm5.cu: pt_add_kernel) stages a block's S rows of
// a and b in slots 0 .. S - 1 and S .. 2S - 1.  Piece i (0 .. 12 S) of a block's rows from r0: a's row r0 +
// r into slot r, b's into slot S + r, 16 bytes each; rows past n are left
QHD void add_load(const uint32_t* a, const uint32_t* b, long long n,
                  long long r0, int S, int i, uint32_t* sh) {
  const int which = i / (6 * S), r = (i % (6 * S)) / 6, c = i % 6;
  if (r0 + r < n)
    piece_copy(tree_slot(sh, which * S + r) + 4 * c,
               (which ? b : a) + PT_WORDS * (r0 + r) + 4 * c);
}

// piece i (0 .. 6 S) out: the a slot's sum, or b's row where flagged
QHD void add_store(const uint8_t* flags, long long n, long long r0, int S,
                   int i, const uint32_t* sh, uint32_t* out) {
  const int r = i / 6, c = i % 6;
  const long long row = r0 + r;
  if (row >= n) return;
  const int slot = flags != nullptr && flags[row] ? S + r : r;
  piece_copy(out + PT_WORDS * row + 4 * c, tree_slot(sh, slot) + 4 * c);
}

#ifdef __CUDACC__
// Items [0, n) of a phase, one a group of six lanes (g1_add_lanes), in
// rounds of `groups` groups (five a warp; lanes 30 and 31 and the groups
// past n add identities, so that every lane meets every __syncwarp):
// live(k) says whether item k is needed, ops(k, &p, &q) gives its operands
// and st(k, r) stores its sum, from lane 0 of its group.  scratch: 48 words
// for each group of six lanes of the block (six a warp).
template <class Live, class Ops, class Store>
__device__ __forceinline__ void group_items(int n, int groups,
                                            uint32_t* scratch, Live live,
                                            Ops ops, Store st) {
  const int lane = threadIdx.x & 31, gw = lane / 6, g = lane % 6;
  const int group = (threadIdx.x >> 5) * 5 + gw;
  uint32_t* xs = scratch + 48 * ((threadIdx.x >> 5) * 6 + gw);
  for (int j0 = 0; j0 < n; j0 += groups) {
    const int k = j0 + group;
    const bool on = gw < 5 && k < n && live(k);
    G1P p = g1_identity(), q = p;
    if (on) ops(k, &p, &q);
    const G1P r = g1_add_lanes(p, q, g, xs);
    if (on && g == 0) st(k, r);
  }
}
#endif

}  // namespace bn254
