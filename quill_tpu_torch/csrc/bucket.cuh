// The pieces of kernels C and D (csrc/msm.cu) that one thread runs alone,
// shared by the kernels and their host emulation (bn254_host.cpp:
// q_bucket_sums_blocked, q_bucket_reduce_blocked).
//
// Kernel C: a thread sums K consecutive entries of the sorted list
// (`run_sums`), across bucket boundaries.  A run of equal keys that opens
// and closes inside the range is a whole bucket and goes straight to the
// dense array; what crosses into a neighbour's range becomes the thread's
// item (`BucketItem`).  Items are joined by a segmented scan over threads,
// then over blocks (`fold_items` walks a thread's share of a level's
// items); `resolve` closes a head once the scan has given its carry.
//
// Kernel D: a thread reduces a segment of s buckets to a = sum_l (l + 1) b_l
// and S = sum_l b_l (`seg_sums`, the running sum); a block then weighs its
// threads' S by their index with a suffix scan, `scaled_add` adding
// 2^lg suf_t to a_t.
#pragma once

#include "seg_scan.cuh"

namespace bn254 {

// A thread's (or a block's) partials in kernel C's fix-up.
//   f, P: P is the partial of the last run, which goes on into the next
//         item; f is set where that run opened in this item (a bucket
//         starts here), the segmented scan's flag.  An item whose last run
//         closed inside has f set and P the identity.
//   key, V: a run that opened before this item and closed in it, still
//         missing its carry: bucket key = (the scan of P up to the item
//         before) + V.  key < 0: none.  An item with a head has f set.
struct BucketItem {
  bool f;
  int key;
  G1P P;
  G1P V;
};

QHD BucketItem empty_item() {
  BucketItem it;
  it.f = false;
  it.key = -1;
  it.P = g1_identity();
  it.V = g1_identity();
  return it;
}

// the affine basis row of entry e (point e >> 1; the sign bit e & 1 is
// applied by the caller)
QHD G1A load_row(const uint32_t* basis, int e) {
  return g1a_load(basis + 16 * (long long)(e >> 1));
}

// A run that closed at this thread: a head (it opened before lo) waits for
// its carry in the item; any other run is a whole bucket.
QHD void close_run(bool head, int key, const G1P& acc, uint32_t* dense,
                   BucketItem& it) {
  if (head) {
    it.key = key;
    it.V = acc;
  } else {
    g1_store(dense + 24 * (long long)key, acc);
  }
}

// Kernel C, one thread: entries [lo, hi) of the n sorted ones (lo < hi),
// keys window * 2^15 + |d| - 1 and entries point * 2 + sign.  Every entry
// is one mixed add into its run's sum, which starts from the identity, with
// y negated by the sign bit.  The next entry's basis row is loaded before
// the current add, so the gather is in flight behind it.
QHD BucketItem run_sums(const uint32_t* basis, const int* keys,
                        const int* entries, long long n, long long lo,
                        long long hi, uint32_t* dense) {
  BucketItem it = empty_item();
  int run = keys[lo];
  const bool open = lo > 0 && keys[lo - 1] == run;  // began in a neighbour
  const int after = hi < n ? keys[hi] : -1;
  bool first = true;                                // run is the first one
  G1P acc = g1_identity();
  int e = entries[lo];
  G1A next = load_row(basis, e);
#pragma unroll 1
  for (long long i = lo; i < hi; ++i) {
    const int key = keys[i];
    const bool neg = (e & 1) != 0;
    G1A p = next;
    if (i + 1 < hi) {
      e = entries[i + 1];
      next = load_row(basis, e);
    }
    if (key != run) {                   // the run before entry i closed
      close_run(first && open, run, acc, dense, it);
      first = false;
      run = key;
      acc = g1_identity();
    }
    if (neg) p.y = fe_neg<FqM>(p.y);
    acc = g1_add_mixed(acc, p);
  }
  if (after == run) {                   // the last run goes on
    it.f = !(first && open);
    it.P = acc;
  } else {
    close_run(first && open, run, acc, dense, it);
    it.f = true;
  }
  return it;
}

// Kernel C's later levels, one thread: items [lo, hi) of a level (meta:
// (n, 2) int32 flag and key; pts: (n, 2, 24) words P and V), folded in
// order into one item.  A head whose chain opened in an earlier item of the
// range is closed here.
QHD BucketItem fold_items(const int* meta, const uint32_t* pts, long long lo,
                          long long hi, uint32_t* dense) {
  BucketItem it = empty_item();
#pragma unroll 1
  for (long long i = lo; i < hi; ++i) {
    const int key = meta[2 * i + 1];
    if (key >= 0) {
      const G1P v = g1_add(it.P, g1_load(pts + 48 * i + 24));
      if (it.f) {
        g1_store(dense + 24 * (long long)key, v);
      } else {
        it.key = key;
        it.V = v;
      }
    }
    bool f = meta[2 * i] != 0;
    G1P p = g1_load(pts + 48 * i);
    seg_op(it.f, it.P, f, p);
    it.f = f;
    it.P = p;
  }
  return it;
}

// A head (key >= 0, partial V) once the scan over the items before it in
// its group gave (cf, carry): closed if its chain opened in the group, else
// returned in *v as the group's head (true; at most one item of a group).
QHD bool resolve(int key, const G1P& V, bool cf, const G1P& carry,
                 uint32_t* dense, G1P* v) {
  *v = g1_add(carry, V);
  if (!cf) return true;
  g1_store(dense + 24 * (long long)key, *v);
  return false;
}

// Kernel D, one thread: s consecutive buckets (24 words each) -> a =
// sum_l (l + 1) b_l and S = sum_l b_l, from the top down (2 s adds).  The
// next bucket is loaded before the current adds.
QHD void seg_sums(const uint32_t* b, int s, G1P* a, G1P* S) {
  G1P run = g1_identity(), acc = g1_identity();
  G1P next = g1_load(b + 24 * (long long)(s - 1));
#pragma unroll 1
  for (int l = s - 1; l >= 0; --l) {
    const G1P x = next;
    if (l > 0) next = g1_load(b + 24 * (long long)(l - 1));
    run = g1_add(run, x);
    acc = g1_add(acc, run);
  }
  *a = acc;
  *S = run;
}

// a + 2^lg suf, by lg doublings
QHD G1P scaled_add(const G1P& a, G1P suf, int lg) {
#pragma unroll 1
  for (int i = 0; i < lg; ++i) suf = g1_add(suf, suf);
  return g1_add(a, suf);
}

}  // namespace bn254
