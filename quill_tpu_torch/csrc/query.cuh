// v6's bucket-query walk: the thread body of kernel E's walk mode
// (csrc/msm5.cu: query_walk_kernel), shared with its host emulation
// (bn254_host.cpp: q_query_walk).
//
// Replaces the XLA query walk of quill_tpu/ec/msm6k.py:174 _qinit_fn, :193
// _qstep_fn, :219 _qstep0_fn and :239 _qstep_pair_fn, which the port ran
// as ~12 launches of kernel E's flagged mode with plain-torch gathers and
// offset updates between every two (ec/msm6.py: queries, its plain twin).
//
// Bucket b of a v6 MSM needs P[c_b], the sum of the first c_b sorted
// leaves.  The tree keeps levels 1 .. kmin (node s of level k the sum of
// leaves [s 2^k, (s + 1) 2^k)) and the top level's inclusive prefix sums
// `top`.  The walk starts from top[q - 1], q = c >> kmin (the identity for
// q = 0), and goes from level kmin - 1 down to the leaves: where bit k of
// c is set, node offset >> k of level k is added and the offset advances
// by 2^k; a leaf (level 0) is the shifted-basis row idx[offset] with Z = 1.
// Every add is node + acc, level by level in that order, as the chain of
// flagged launches adds, so the triples are the chain's.  The leaf's add
// is g1_add with Z = 1 (one product more than g1_add_mixed, whose values
// are the same): one copy of the add a kernel, since an inlined add is
// ~200 KB of code, more than the SM's instruction cache (PR 10).  Gathers
// happen only where the bit is set, so no index is clamped.
#pragma once

#include "bn254.cuh"
#include "tree.cuh"

#define WALK_MAX 40  // levels 1 .. kmin - 1 a launch can pass

namespace bn254 {

struct WalkLevels {  // level k (1 <= k < kmin) at p[k - 1], rows of 24 words
  const uint32_t* p[WALK_MAX];
};

// the walk's start for count c: top[q - 1] or the identity
QHD G1P walk_start(long long c, int kmin, const uint32_t* top) {
  const long long q = c >> kmin;
  return q > 0 ? pt_ld(top + PT_WORDS * (q - 1)) : g1_identity();
}

// the node that step k (kmin - 1 down to 0) of count c adds at offset off,
// if bit k of c is set
QHD bool walk_node(long long c, int k, long long off, const WalkLevels& lv,
                   const uint32_t* sh, const int* idx, G1P* node) {
  if (!((c >> k) & 1)) return false;
  if (k > 0) {
    *node = pt_ld(lv.p[k - 1] + PT_WORDS * (off >> k));
  } else {
    const uint32_t* row = sh + 16LL * idx[off];
    node->x = fe_load16(row);
    node->y = fe_load16(row + 8);
    node->z = fe_one<FqM>();
  }
  return true;
}

// one bucket's walk by one thread
QHD G1P walk_query(long long c, int kmin, const uint32_t* top,
                   const WalkLevels& lv, const uint32_t* sh, const int* idx) {
  G1P acc = walk_start(c, kmin, top);
  long long off = (c >> kmin) << kmin;
#pragma unroll 1
  for (int k = kmin - 1; k >= 0; --k) {
    G1P node;
    if (walk_node(c, k, off, lv, sh, idx, &node)) {
      acc = g1_add(node, acc);
      off += 1LL << k;
    }
  }
  return acc;
}

}  // namespace bn254
