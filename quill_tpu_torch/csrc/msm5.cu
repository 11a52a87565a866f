// Kernels E to H: the point adds of the small-MSM route (shifted basis +
// prefix tree), quill_tpu_torch/ec/msm5.py.
//
// E  pt_add      replaces quill_tpu/fields/pallas8.py:_stacked_combine_kernel
//                (pt_add_stacked and its flagged mode seg_combine_stacked;
//                :188 _pt_add_kernel, :245 _pt_add_b16_kernel, :283
//                _seg_combine_kernel): out[i] = flags && flags[i] ? b[i] :
//                a[i] + b[i], staged through shared memory as 16-byte
//                pieces, one add a thread or, for small launches, one a
//                group of six lanes (below).
//    query_walk  replaces the XLA query walk of quill_tpu/ec/msm6k.py:174-247
//                (one flagged pt_add launch a level before): v6's 2^16 - 1
//                bucket queries in one launch (csrc/query.cuh).
//    shifted_basis  replaces E's doubling ladder (quill_tpu/ec/msm3.py:90
//                _shift_doubling, one _stacked_combine_kernel launch a
//                doubling) and the batch normalisation after it: for n
//                points, nwin windows of 2^(wbits w) P_i as affine rows,
//                one launch (below).
//    pt_dbl      k doublings of each point in one launch (v8's triangle,
//                ec/msm8.py, where E added a point to itself k times).
// F  tree_leaf   replaces quill_tpu/ec/msm5.py:245 _up0_kernel (F, the small
// K              route) and quill_tpu/ec/msm6k.py:58 _lvl0_kernel (K, v6's
//                level 0): the affine leaf level gathered through an index,
//                out[j] = sh[idx[2j]] + sh[idx[2j+1]] with Z1 = Z2 = 1 (9
//                products instead of 12), projective out.  The TPU kernels
//                read leaf arrays that an XLA gather had written first; here
//                the kernel gathers the rows of the shifted basis itself, so
//                no leaf array is written.
// G  tree_up     replaces quill_tpu/ec/msm3.py:258 _up_kernel: the up-sweep,
//                one level (L = 1) or two (L = 2) a launch.
//    tree_top    replaces the fused top levels (quill_tpu/ec/msm3.py:361
//                _k_treetop_up, :391 _k_treetop_down): every level of at most
//                TREE_TOP points up and back down in one block; in reduce
//                mode the pairwise sums of aligned spans (the collect's and
//                v6's reductions).
// H  tree_down   replaces quill_tpu/ec/msm3.py:267 _down_kernel: the down-
//                sweep, one level or two a launch, P[2j+1] = P'[j], P[2j] =
//                P'[j] + (-U[2j+1]), negation being Y -> -Y.
//
// The TPU kernels worked on (S, 3L, M) tiles of 8-bit limbs in f32 so that
// a level was a few large dispatches.  Here a point is 24 uint32 words (X,
// Y, Z, each eight Montgomery limbs, bn254.cuh) and one thread does one
// complete add at a time.  Bound on the card: integer multiply throughput.
// A complete add is 12 CIOS products (9 for F), each 128 32x32->64-bit
// multiply-adds (a low and a high IMAD) and 8 low products: 3,168 32-bit
// multiply-adds (2,376 for F), against 224 to 384 bytes read and written:
// 8 to 11 operations a byte, above the card's ~5 int32 multiply-adds a
// byte (132 SMs x 64 a clock against 3.35 TB/s).  E's shifted basis and
// doubling keep everything in registers, since every byte is read once.
// E's add, F and K, G and H stage their spans through shared memory
// (csrc/tree.cuh has their thread bodies, staging maps and design), so that
// every global access is a coalesced 16-byte piece (F and K gather whole
// 64-byte rows) and a two-level launch never writes and reads back the
// level between its two.
//
// The shifted basis: one thread a base point, its windows' doublings in
// registers and their normalisation by Montgomery's trick inside the
// thread (csrc/ladder.cuh has the thread body and its design).
#include <cuda_runtime.h>

#include "bn254.cuh"
#include "ladder.cuh"
#include "query.cuh"
#include "tree.cuh"

using namespace bn254;

#define MSM5_BLOCK 128

// E's add: block b stages rows [S b, S (b + 1)) of a and b in slots 0 ..
// S - 1 and S .. 2S - 1 (tree.cuh's slot map) as 16-byte pieces, adds each
// unflagged pair into its a slot, one add a thread (S = MSM5_BLOCK) or one
// a group of six lanes (S = ADD_LANE_SPAN, g1_add_lanes), and copies out
// the a slot, or the b slot where the row is flagged.
template <bool LANES>
__global__ void __launch_bounds__(MSM5_BLOCK)
pt_add_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
              const uint8_t* __restrict__ flags, long long n,
              uint32_t* __restrict__ out) {
  constexpr int S = LANES ? ADD_LANE_SPAN : MSM5_BLOCK;
  extern __shared__ uint4 add_sh[];
  uint32_t* sh = reinterpret_cast<uint32_t*>(add_sh);
  const long long r0 = (long long)blockIdx.x * S;
  for (int i = threadIdx.x; i < 12 * S; i += MSM5_BLOCK)
    add_load(a, b, n, r0, S, i, sh);
  __syncthreads();
  auto live = [&](int k) {
    return r0 + k < n && !(flags != nullptr && flags[r0 + k]);
  };
  if (!LANES) {
    const int k = threadIdx.x;
    if (live(k))
      pt_st(tree_slot(sh, k),
            g1_add(pt_ld(tree_slot(sh, k)), pt_ld(tree_slot(sh, S + k))));
  } else {
    group_items(
        S, TREE_LANE_GROUPS, sh + 25 * 2 * S, live,
        [&](int k, G1P* p, G1P* q) {
          *p = pt_ld(tree_slot(sh, k));
          *q = pt_ld(tree_slot(sh, S + k));
        },
        [&](int k, const G1P& r) { pt_st(tree_slot(sh, k), r); });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 6 * S; i += MSM5_BLOCK)
    add_store(flags, n, r0, S, i, sh, out);
}

// E's walk mode, v6's bucket queries: one bucket a thread (csrc/query.cuh
// has the walk); one a group of six lanes took 1.6x the time on an H100
// (PERF.md, PR 11)
__global__ void __launch_bounds__(MSM5_BLOCK)
query_walk_kernel(const long long* __restrict__ cnt, long long nq,
                  const uint32_t* __restrict__ top, WalkLevels lv, int kmin,
                  const uint32_t* __restrict__ sh, const int* __restrict__ idx,
                  uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * MSM5_BLOCK + threadIdx.x;
  if (i < nq)
    pt_st(out + PT_WORDS * i, walk_query(cnt[i], kmin, top, lv, sh, idx));
}

// G's and H's blocks of TREE_NT threads (csrc/tree.cuh): the minimum of
// resident blocks an SM that ptxas is held to (registers), by measurement
// (builds with other values timed on an H100; PERF.md): 256 threads and 2
// blocks give the two-level launches by threads 128 registers, no stack
// frame and no spills, 16 warps an SM (their 100 KB of shared memory a
// block allow 2 as well); 128 threads and 4 blocks were 10-15% slower, 1
// block of 256 (144 registers, 8 warps) ~40%.  By lanes: 106 registers,
// blocks of 128.  One level: 126.  The fused top (256 threads, one block
// an SM): 134 registers in tree mode, 128 and an 8-byte stack frame in
// reduce mode.
#define TREE_MINB 2

// F and K, the affine leaf level: block b gathers its LEAF_NT pairs' leaves
// through idx into shared memory (cp.async), adds each pair in its slot,
// one add a thread, and writes the pair sums out (csrc/tree.cuh has the
// maps).  36,864 bytes of slots a block.
__global__ void __launch_bounds__(LEAF_NT, TREE_MINB)
tree_leaf_kernel(const uint32_t* __restrict__ sh, const int* __restrict__ idx,
                 long long k, uint32_t* __restrict__ out) {
  __shared__ uint4 leaf_sh[leaf_words() / 4];
  uint32_t* s = reinterpret_cast<uint32_t*>(leaf_sh);
  const long long b = blockIdx.x;
  for (int i = threadIdx.x; i < 8 * LEAF_NT; i += LEAF_NT)
    leaf_load(sh, idx, k, b, i, s);
  leaf_wait();
  __syncthreads();
  if (b * LEAF_NT + threadIdx.x < k) leaf_pair(s, threadIdx.x);
  __syncthreads();
  for (int i = threadIdx.x; i < 6 * LEAF_NT; i += LEAF_NT)
    leaf_store(out, k, b, i, s);
}

// G: block b stages level l's rows [S b, S (b + 1)), adds level l + 1's
// pairs in shared memory and, for L = 2, level l + 2's, and writes both
// levels out.  By threads (TREE_NT of them, S = 2^L TREE_NT): one add a
// thread at a time, a barrier after each, so that one add's operands are
// in registers at a time.  By lanes (TREE_LANE_NT threads, S =
// TREE_LANE_SPAN, narrow levels): one add a group of six lanes.
template <int L, bool LANES>
__global__ void __launch_bounds__(LANES ? TREE_LANE_NT : TREE_NT,
                                  LANES ? 1 : TREE_MINB)
tree_up_kernel(const uint32_t* __restrict__ x, long long m,
               uint32_t* __restrict__ o1, uint32_t* __restrict__ o2) {
  constexpr int NT = LANES ? TREE_LANE_NT : TREE_NT;
  constexpr int S = tree_span(L, LANES);
  extern __shared__ uint4 tree_sh[];
  uint32_t* sh = reinterpret_cast<uint32_t*>(tree_sh);
  const long long b = blockIdx.x;
  for (int i = threadIdx.x; i < tree_pieces(S); i += NT)
    up_load(S, x, m, b, i, sh);
  __syncthreads();
  if (!LANES) {
    // phase 1's S / 2 items, then phase 2's S / 4, NT a round; one loop, so
    // that the kernel holds one copy of g1_add's code
    constexpr int R1 = S / 2 / NT, R = L == 2 ? R1 + S / 4 / NT : R1;
#pragma unroll 1
    for (int it = 0; it < R; ++it) {
      const int phase = it < R1 ? 1 : 2;
      const int k = (phase == 1 ? it : it - R1) * NT + threadIdx.x;
      if (up_item_live(S, m, b, phase, k)) up_item(sh, phase, k);
      __syncthreads();
    }
  } else {
#pragma unroll 1
    for (int phase = 1; phase <= L; ++phase) {
      group_items(
          S >> phase, TREE_LANE_GROUPS, sh + 25 * S,
          [&](int k) { return up_item_live(S, m, b, phase, k); },
          [&](int k, G1P* p, G1P* q) {
            up_item_operands(sh, phase, k, p, q);
          },
          [&](int k, const G1P& r) { up_item_store(sh, phase, k, r); });
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < up_store_pieces(L, S); i += NT)
    up_store(S, o1, o2, m, b, i, sh);
}

// H: block b stages what level l's prefixes [S b, S (b + 1)) need, then,
// for L = 2, level l + 1's prefixes and level l's, and writes them out; by
// threads or by lanes as G.
template <int L, bool LANES>
__global__ void __launch_bounds__(LANES ? TREE_LANE_NT : TREE_NT,
                                  LANES ? 1 : TREE_MINB)
tree_down_kernel(const uint32_t* __restrict__ p,
                 const uint32_t* __restrict__ u1,
                 const uint32_t* __restrict__ u0, long long m,
                 uint32_t* __restrict__ out) {
  constexpr int NT = LANES ? TREE_LANE_NT : TREE_NT;
  constexpr int S = tree_span(L, LANES);
  extern __shared__ uint4 tree_sh[];
  uint32_t* sh = reinterpret_cast<uint32_t*>(tree_sh);
  const long long b = blockIdx.x;
  for (int i = threadIdx.x; i < tree_pieces(S); i += NT)
    down_load(L, S, p, u1, u0, m, b, i, sh);
  __syncthreads();
  if (!LANES) {
    // (L = 2) phase 1's S / 4 items, then phase 2's S / 2, NT a round
    constexpr int R1 = L == 2 ? S / 4 / NT : 0, R = R1 + S / 2 / NT;
#pragma unroll 1
    for (int it = 0; it < R; ++it) {
      const int phase = it < R1 ? 1 : 2;
      const int k = (phase == 1 ? it : it - R1) * NT + threadIdx.x;
      if (down_item_live(S, m, b, phase, k)) down_item(sh, phase, k);
      __syncthreads();
    }
  } else {
#pragma unroll 1
    for (int phase = 3 - L; phase <= 2; ++phase) {
      group_items(
          S >> (3 - phase), TREE_LANE_GROUPS, sh + 25 * S,
          [&](int k) { return down_item_live(S, m, b, phase, k); },
          [&](int k, G1P* a, G1P* q) {
            down_item_operands(sh, phase, k, a, q);
          },
          [&](int k, const G1P& r) { down_item_store(sh, phase, k, r); });
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tree_pieces(S); i += NT)
    down_store(S, out, m, b, i, sh);
}

// The fused top: block b sums x's rows [b w, (b + 1) w) up to one point in
// shared memory (level k at top_level's slots).  Tree mode (one block, any
// w <= TREE_TOP): then the down-sweep, and out gets the w prefixes.
// Reduce mode (w a power of two): out[b] gets the sum.  A level's adds go
// one a thread while there are more than TREE_TOP_LANE_MAX, then one a
// group of six lanes (g1_add_lanes), whose latency is ~2 products, not 12.
template <bool TREE>
__global__ void __launch_bounds__(TREE_TOP_NT)
tree_top_kernel(const uint32_t* __restrict__ x, int w,
                uint32_t* __restrict__ out) {
  extern __shared__ uint4 tree_sh[];
  uint32_t* sh = reinterpret_cast<uint32_t*>(tree_sh);
  uint32_t* scratch = sh + PT_WORDS * top_slots(w);
  const int tid = threadIdx.x;
  const uint32_t* src = x + (long long)PT_WORDS * w * blockIdx.x;
  for (int i = tid; i < 6 * w; i += TREE_TOP_NT)
    piece_copy(sh + 4 * i, src + 4 * i);
  __syncthreads();
  // the up-sweep's levels, then (tree mode) the down-sweep's, in one loop
  // with one add a thread and one a group of lanes, so that the kernel
  // holds one copy of each
  const int levels = top_levels(w);
  const int steps = TREE ? 2 * (levels - 1) : levels - 1;
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    const bool up = step < levels - 1;
    int off, s;
    top_level(w, up ? step : 2 * (levels - 1) - 1 - step, &off, &s);
    const int off1 = off + s + (s & 1), n = (s + 1) >> 1;
    auto ops = [&](int j, G1P* p, G1P* q) {
      if (up)
        top_up_operands(sh, off, s, j, p, q);
      else
        top_down_operands(sh, off, off1, j, p, q);
    };
    auto st = [&](int j, const G1P& r) {
      if (up)
        top_up_store(sh, off, s, off1, j, r);
      else
        top_down_store(sh, off, off1, j, r);
    };
    if (n > TREE_TOP_LANE_MAX) {
      for (int j = tid; j < n; j += TREE_TOP_NT) {
        G1P p, q;
        ops(j, &p, &q);
        st(j, g1_add(p, q));
      }
    } else {
      group_items(n, TREE_TOP_GROUPS, scratch, [](int) { return true; }, ops,
                  st);
    }
    __syncthreads();
  }
  if (!TREE) {
    int off, s;
    top_level(w, levels - 1, &off, &s);
    if (tid < 6)
      piece_copy(out + (long long)PT_WORDS * blockIdx.x + 4 * tid,
                 sh + PT_WORDS * off + 4 * tid);
    return;
  }
  for (int i = tid; i < 6 * w; i += TREE_TOP_NT)
    piece_copy(out + 4 * i, sh + 4 * i);
}

__global__ void __launch_bounds__(MSM5_BLOCK)
pt_dbl_kernel(const uint32_t* __restrict__ a, long long n, int k,
              uint32_t* __restrict__ out) {
  long long i = (long long)blockIdx.x * MSM5_BLOCK + threadIdx.x;
  if (i >= n) return;
  G1P p = g1_load(a + 24 * i);
#pragma unroll 1
  for (int j = 0; j < k; ++j) p = g1_dbl(p);
  g1_store(out + 24 * i, p);
}

__global__ void __launch_bounds__(MSM5_BLOCK)
shifted_basis_kernel(const uint32_t* __restrict__ xy,
                     const uint8_t* __restrict__ inf, long long n,
                     long long chunk, int nwin, int wbits,
                     uint32_t* __restrict__ out,
                     uint32_t* __restrict__ scratch) {
  const long long i = (long long)blockIdx.x * MSM5_BLOCK + threadIdx.x;
  if (i < n) shifted_point(xy, inf, i, n, chunk, nwin, wbits, out, scratch);
}

static unsigned blocks(long long n) {
  return (unsigned)((n + MSM5_BLOCK - 1) / MSM5_BLOCK);
}

// a, b, out: (n, 24) words, 16-byte aligned; flags: (n,) bytes or NULL;
// lanes: one add a group of six lanes.  out may not alias a or b.
extern "C" int quill_pt_add(const void* a, const void* b, const void* flags,
                            long long n, int lanes, void* out, void* stream) {
  if (n <= 0) return 0;
  const int S = lanes ? ADD_LANE_SPAN : MSM5_BLOCK;
  const int bytes = 4 * (25 * 2 * S + (lanes ? MSM5_BLOCK / 32 * 6 * 48 : 0));
  const unsigned grid = (unsigned)((n + S - 1) / S);
  if (lanes)
    pt_add_kernel<true><<<grid, MSM5_BLOCK, bytes, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (const uint8_t*)flags, n,
        (uint32_t*)out);
  else
    pt_add_kernel<false><<<grid, MSM5_BLOCK, bytes, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (const uint8_t*)flags, n,
        (uint32_t*)out);
  return (int)cudaGetLastError();
}

// v6's bucket queries: cnt: (nq,) int64 counts; top: (>= max(cnt) >> kmin,
// 24) the top level's prefixes; levels: kmin - 1 device pointers, level k
// (1 <= k < kmin) at levels[k - 1], rows of 24 words; sh: (rows, 16) the
// shifted basis; idx: the sorted leaves' rows of sh; out: (nq, 24)
extern "C" int quill_query_walk(const void* cnt, long long nq, const void* top,
                                const unsigned long long* levels, int kmin,
                                const void* sh, const void* idx, void* out,
                                void* stream) {
  if (nq <= 0) return 0;
  if (kmin < 1 || kmin - 1 > WALK_MAX) return (int)cudaErrorInvalidValue;
  WalkLevels lv;
  for (int k = 0; k < WALK_MAX; ++k)
    lv.p[k] = k < kmin - 1 ? (const uint32_t*)levels[k] : nullptr;
  query_walk_kernel<<<blocks(nq), MSM5_BLOCK, 0, (cudaStream_t)stream>>>(
      (const long long*)cnt, nq, (const uint32_t*)top, lv, kmin,
      (const uint32_t*)sh, (const int*)idx, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// a, out: (n, 24) words, out = 2^k a; out may not alias a
extern "C" int quill_pt_dbl(const void* a, long long n, int k, void* out,
                            void* stream) {
  if (n <= 0) return 0;
  pt_dbl_kernel<<<blocks(n), MSM5_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, n, k, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// xy: (n, 16) affine words, 16-byte aligned; inf: (n,) bytes; out: (n nwin,
// 16) words in chunks of `chunk` points, each window-major; scratch: ((nwin
// - 1) n, 16) words
extern "C" int quill_shifted_basis(const void* xy, const void* inf,
                                   long long n, long long chunk, int nwin,
                                   int wbits, void* out, void* scratch,
                                   void* stream) {
  if (n <= 0) return 0;
  if (chunk <= 0 || nwin < 1 || wbits < 0) return (int)cudaErrorInvalidValue;
  shifted_basis_kernel<<<blocks(n), MSM5_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)xy, (const uint8_t*)inf, n, chunk, nwin, wbits,
      (uint32_t*)out, (uint32_t*)scratch);
  return (int)cudaGetLastError();
}

// Once per kernel: dynamic shared memory above the default 48 KB
template <class K>
static int tree_launch_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int L, bool LANES>
static int tree_up_launch(const void* x, long long m, void* o1, void* o2,
                          void* stream) {
  constexpr int S = tree_span(L, LANES);
  const int bytes = 4 * tree_words(S, LANES);
  static int set = tree_launch_smem(tree_up_kernel<L, LANES>, bytes);
  if (set != 0) return set;
  tree_up_kernel<L, LANES><<<(unsigned)tree_blocks(S, m),
                             LANES ? TREE_LANE_NT : TREE_NT, bytes,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)x, m, (uint32_t*)o1, (uint32_t*)o2);
  return (int)cudaGetLastError();
}

template <int L, bool LANES>
static int tree_down_launch(const void* p, const void* u1, const void* u0,
                            long long m, void* out, void* stream) {
  constexpr int S = tree_span(L, LANES);
  const int bytes = 4 * tree_words(S, LANES);
  static int set = tree_launch_smem(tree_down_kernel<L, LANES>, bytes);
  if (set != 0) return set;
  tree_down_kernel<L, LANES><<<(unsigned)tree_blocks(S, m),
                               LANES ? TREE_LANE_NT : TREE_NT, bytes,
                               (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)u1, (const uint32_t*)u0, m,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

template <bool TREE>
static int tree_top_launch(const void* x, int w, long long blocks, void* out,
                           void* stream) {
  if (blocks <= 0) return 0;
  if (w < 1 || w > TREE_TOP) return (int)cudaErrorInvalidValue;
  const int bytes = top_bytes(w);
  static int set = tree_launch_smem(tree_top_kernel<TREE>,
                                    top_bytes(TREE_TOP));
  if (set != 0) return set;
  tree_top_kernel<TREE><<<(unsigned)blocks, TREE_TOP_NT, bytes,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)x, w, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// F and K: sh: (rows, 16) affine words, 16-byte aligned; idx: (2k,) int32
// rows of sh, each < rows, or NULL for rows 0 .. 2k - 1; out: (k, 24),
// out[j] = sh[idx[2j]] + sh[idx[2j + 1]]
extern "C" int quill_tree_leaf(const void* sh, const void* idx, long long k,
                               void* out, void* stream) {
  if (k <= 0) return 0;
  tree_leaf_kernel<<<(unsigned)((k + LEAF_NT - 1) / LEAF_NT), LEAF_NT, 0,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)sh, (const int*)idx, k, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// G, one level: x: (2k, 24); out: (k, 24)
extern "C" int quill_tree_up(const void* x, long long k, void* out,
                             void* stream) {
  if (k <= 0) return 0;
  return tree_up_launch<1, false>(x, 2 * k, out, nullptr, stream);
}

// G, two levels: x: (m, 24), level l; o1: (ceil(m / 2), 24), level l + 1;
// o2: (ceil(m / 4), 24), level l + 2; odd levels padded with the identity;
// by lanes where tree_lanes(m)
extern "C" int quill_tree_up2(const void* x, long long m, void* o1, void* o2,
                              void* stream) {
  if (m <= 0) return 0;
  return tree_lanes(m) ? tree_up_launch<2, true>(x, m, o1, o2, stream)
                       : tree_up_launch<2, false>(x, m, o1, o2, stream);
}

// H, one level: in: (k, 24) prefixes; u: (2k, 24) the level below; out:
// (2k, 24)
extern "C" int quill_tree_down(const void* in, const void* u, long long k,
                               void* out, void* stream) {
  if (k <= 0) return 0;
  return tree_down_launch<1, false>(in, nullptr, u, 2 * k, out, stream);
}

// H, two levels: p: (>= ceil(m / 4), 24) prefixes of level l + 2; u1:
// (ceil(m / 2), 24) level l + 1; u0: (m, 24) level l; out: (m, 24) level
// l's prefixes
extern "C" int quill_tree_down2(const void* p, const void* u1, const void* u0,
                                long long m, void* out, void* stream) {
  if (m <= 0) return 0;
  return tree_lanes(m)
             ? tree_down_launch<2, true>(p, u1, u0, m, out, stream)
             : tree_down_launch<2, false>(p, u1, u0, m, out, stream);
}

// the fused top, tree mode: x: (w, 24), 1 <= w <= TREE_TOP; out: (w, 24)
// its prefixes
extern "C" int quill_tree_top(const void* x, int w, void* out, void* stream) {
  return tree_top_launch<true>(x, w, 1, out, stream);
}

// the fused top, reduce mode: x: (groups w, 24), w a power of two <=
// TREE_TOP; out: (groups, 24), out[g] the pairwise sum of rows [g w, (g + 1)
// w)
extern "C" int quill_tree_reduce(const void* x, long long groups, int w,
                                 void* out, void* stream) {
  if (w & (w - 1)) return (int)cudaErrorInvalidValue;
  return tree_top_launch<false>(x, w, groups, out, stream);
}
