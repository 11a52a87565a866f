// Kernels C and D: the bucket phase of a signed-digit Pippenger MSM over G1.
//
// Kernel C (bucket sum) replaces quill_tpu/ec/msm7k.py:81 _lvl0s_kernel
// (signed level 0 of the v7 bucket tree: affine leaf pairs, y negated by a
// sign plane) and quill_tpu/ec/msm6k.py:70 _lvl_kernel (the projective
// up-sweep levels).  The TPU build padded every bucket run into a
// power-of-two tree so that each level was one dense (99, h) tile pass.
// From the sorted keys and entries (`torch.sort`) to the dense (16 * 2^15)
// buckets it is four launches, whatever the data, with no readback:
//   fill    every bucket the identity (one plain pass);
//   sum     thread t sums entries [t K, t K + K) of the sorted list,
//           across bucket boundaries (bucket.cuh: run_sums): each entry is
//           one mixed add into its run's sum, the next basis row loaded
//           behind it.  A run that opens and closes in the range is a whole
//           bucket and is written at once; the runs that cross into a
//           neighbour leave an item (flag, tail partial P, head partial V).
//           A block scans its threads' items with the segmented operator
//           (seg_scan.cuh: seg_op; warp shuffles, then the warp totals),
//           closes every head whose bucket opened in the block and leaves
//           one item of its own;
//   fix     the same over the blocks' items, a thread an item;
//   top     one block over the groups' items, ceil(n / MSM_BLOCK) a thread.
// A bucket spanning thousands of threads (scalars in {0, 1, 2}) is joined
// in log2 MSM_BLOCK steps a level, never walked.  Every lane takes the same
// mixed add at every step: the run's first entry adds to the identity
// rather than branching to an affine + affine add, which would make a warp
// run both adds wherever its lanes sit at different places in their runs.
//
// Kernel D (bucket reduce) is the counterpart of the v7 Fenwick query phase
// (quill_tpu/ec/msm7.py:146-160), which the TPU build left to XLA: for each
// window, W = sum_i (i + 1) B_i over its 2^15 buckets.  Two launches:
//   seg     thread j reduces a segment of s buckets by the running sum to
//           a_j = sum_l (l + 1) B_{j s + l} and S_j = sum_l B_{j s + l}
//           (2 s dependent adds); its block then forms
//           X = sum_t a_t + s sum_t t S_t and Y = sum_t S_t over its
//           threads t, where sum_t t S_t = sum_{t >= 1} suf_t, suf_t the
//           suffix sums of S (a shuffle scan), so each thread adds s suf_t
//           to a_t (log2 s doublings) and the block sums the terms;
//   final   one block a window does the same over the window's blocks:
//           W = sum_b X_b + s MSM_BLOCK sum_b b Y_b.
// The dependent chain is 2 s + ~20 adds, then ~30, where a thread walked
// 2 x 128 buckets and a double-and-add by its segment's offset before.
// (The block's terms are summed by a tree in shared memory: warp shuffles
// followed by a loop over the warp sums made nvcc 12.9's cicc crash.)
//
// Bounds on this card: every step is a complete G1 add (bn254.cuh, 11 or 12
// Fq Montgomery products), so both kernels are bound by integer multiply
// throughput; C's gathers move 64-byte rows at random (the row of the next
// entry is in flight during the current add), D reads each bucket once.
// The fix-up's cost is per thread, so K is large: about 2^15 threads of
// 16 to 128 entries (msm.py: entries_a_thread; `python -m
// quill_tpu_torch.probe_msm --sweep` times every K), 16 buckets a D
// thread (msm.py: SEG) and blocks of 64 were the fastest measured on an
// H100 from 2^17 to 2^22 points (PERF.md): blocks of 64 take D from ~2.0
// to ~1.65 ms against 128 and leave C within its noise.  A
// thread's head partial waits in shared memory over the block's scan,
// which keeps the spills of the 168-register bound (384 threads an SM)
// small.
#include <cuda_runtime.h>

#include "bucket.cuh"

using namespace bn254;

#define MSM_BLOCK 64  // threads a block; ec/msm.py: BLOCK mirrors it
#define MSM_WARPS (MSM_BLOCK / 32)
#define MSM_MIN_BLOCKS (384 / MSM_BLOCK)  // at most 170 registers a thread
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ G1P g1_shfl_up(const G1P& a, unsigned d) {
  G1P r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.x.v[i] = __shfl_up_sync(FULL_MASK, a.x.v[i], d);
    r.y.v[i] = __shfl_up_sync(FULL_MASK, a.y.v[i], d);
    r.z.v[i] = __shfl_up_sync(FULL_MASK, a.z.v[i], d);
  }
  return r;
}

__device__ __forceinline__ G1P g1_shfl_down(const G1P& a, unsigned d) {
  G1P r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.x.v[i] = __shfl_down_sync(FULL_MASK, a.x.v[i], d);
    r.y.v[i] = __shfl_down_sync(FULL_MASK, a.y.v[i], d);
    r.z.v[i] = __shfl_down_sync(FULL_MASK, a.z.v[i], d);
  }
  return r;
}

// shared memory of kernel C's block step
struct ItemShared {
  G1P v[MSM_BLOCK];      // the threads' head partials, parked over the scan
  G1P wsum[MSM_WARPS];   // the warps' inclusive scans
  bool wflag[MSM_WARPS];
  int head;              // the key of the block's open head, or -1
};

// Kernel C's block step for a thread's item (f, P, key; its head partial
// V in sh.v[threadIdx.x] where key >= 0): the exclusive segmented scan of
// the threads' (f, P), each head resolved, and the block's item written to
// slot blk of the next level (meta: flag and key; pts: P and V).
__device__ __forceinline__ void block_items(bool f, G1P s, int key,
                                            uint32_t* __restrict__ dense,
                                            long long blk,
                                            int* __restrict__ meta,
                                            uint32_t* __restrict__ pts,
                                            ItemShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {        // inclusive, within the warp
    G1P o = g1_shfl_up(s, d);
    bool of = __shfl_up_sync(FULL_MASK, (int)f, d) != 0;
    if (lane >= d) seg_op(of, o, f, s);
  }
  if (lane == 31) {
    sh.wsum[warp] = s;
    sh.wflag[warp] = f;
  }
  if (tid == 0) sh.head = -1;
  G1P carry = g1_shfl_up(s, 1);             // exclusive
  bool cf = __shfl_up_sync(FULL_MASK, (int)f, 1) != 0;
  if (lane == 0) {
    carry = g1_identity();
    cf = false;
  }
  __syncthreads();
  bool wf = false;                          // the warps before this one
  G1P wt = g1_identity();
  if (warp > 0) {
    wf = sh.wflag[0];
    wt = sh.wsum[0];
#pragma unroll 1
    for (int w = 1; w < warp; ++w) {
      bool fb = sh.wflag[w];
      G1P b = sh.wsum[w];
      seg_op(wf, wt, fb, b);
      wf = fb;
      wt = b;
    }
    seg_op(wf, wt, cf, carry);
  }
  if (key >= 0) {
    const G1P hv = sh.v[tid];
    G1P v;
    if (resolve(key, hv, cf, carry, dense, &v)) {
      sh.head = key;
      g1_store(pts + 48 * blk + 24, v);
    }
  }
  if (tid == MSM_BLOCK - 1) {               // the block's inclusive scan
    bool lf = sh.wflag[MSM_WARPS - 1];
    G1P lp = sh.wsum[MSM_WARPS - 1];
    if (warp > 0) seg_op(wf, wt, lf, lp);
    meta[2 * blk] = lf;
    g1_store(pts + 48 * blk, lp);
  }
  __syncthreads();
  if (tid == 0) meta[2 * blk + 1] = sh.head;
}

__global__ void __launch_bounds__(MSM_BLOCK)
bucket_fill_kernel(uint32_t* __restrict__ dense, long long nb) {
  const long long i = (long long)blockIdx.x * MSM_BLOCK + threadIdx.x;
  if (i < nb) g1_store(dense + 24 * i, g1_identity());
}

__global__ void __launch_bounds__(MSM_BLOCK, MSM_MIN_BLOCKS)
bucket_sum_kernel(const uint32_t* __restrict__ basis,
                  const int* __restrict__ keys,
                  const int* __restrict__ entries, long long n, int k,
                  uint32_t* __restrict__ dense, int* __restrict__ meta,
                  uint32_t* __restrict__ pts) {
  const long long t = (long long)blockIdx.x * MSM_BLOCK + threadIdx.x;
  const long long lo = t * k < n ? t * k : n;
  const long long hi = lo + k < n ? lo + k : n;
  BucketItem it = empty_item();
  if (lo < hi) it = run_sums(basis, keys, entries, n, lo, hi, dense);
  __shared__ ItemShared sh;
  if (it.key >= 0) sh.v[threadIdx.x] = it.V;
  block_items(it.f, it.P, it.key, dense, blockIdx.x, meta, pts, sh);
}

// items [0, n) of a level (meta, pts) -> one item a block (ometa, opts);
// thread t folds items [t r, t r + r)
__global__ void __launch_bounds__(MSM_BLOCK, MSM_MIN_BLOCKS)
bucket_fix_kernel(const int* __restrict__ meta,
                  const uint32_t* __restrict__ pts, long long n, long long r,
                  uint32_t* __restrict__ dense, int* __restrict__ ometa,
                  uint32_t* __restrict__ opts) {
  const long long t = (long long)blockIdx.x * MSM_BLOCK + threadIdx.x;
  const long long lo = t * r < n ? t * r : n;
  const long long hi = lo + r < n ? lo + r : n;
  const BucketItem it = fold_items(meta, pts, lo, hi, dense);
  __shared__ ItemShared sh;
  if (it.key >= 0) sh.v[threadIdx.x] = it.V;
  block_items(it.f, it.P, it.key, dense, blockIdx.x, ometa, opts, sh);
}

// shared memory of kernel D's block step
struct CombineShared {
  G1P wsuf[MSM_WARPS];   // the warps' suffix sums
  G1P x[MSM_BLOCK];      // the threads' terms, summed by a tree
};

// Kernel D's block step: X = sum_t a_t + 2^lg sum_t t S_t and Y = sum_t S_t
// over the block's threads t, written to X and Y (24 words each; Y only
// where it is not NULL).
__device__ __forceinline__ void block_combine(const G1P& a, const G1P& S,
                                              int lg, uint32_t* __restrict__ X,
                                              uint32_t* __restrict__ Y,
                                              CombineShared& sh) {
  G1P* wsuf = sh.wsuf;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  G1P suf = S;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {        // suffix sums within the warp
    G1P o = g1_shfl_down(suf, d);
    if (lane + d < 32) suf = g1_add(suf, o);
  }
  if (lane == 0) wsuf[warp] = suf;
  __syncthreads();
  if (warp + 1 < MSM_WARPS) {               // the warps after this one
    G1P later = wsuf[warp + 1];
#pragma unroll 1
    for (int w = warp + 2; w < MSM_WARPS; ++w) later = g1_add(later, wsuf[w]);
    suf = g1_add(suf, later);
  }
  const G1P x = scaled_add(a, suf, lg);
  sh.x[tid] = tid == 0 ? a : x;
  if (tid == 0 && Y != nullptr) g1_store(Y, suf);
  __syncthreads();
#pragma unroll 1
  for (int h = MSM_BLOCK / 2; h > 0; h >>= 1) {  // the terms' sum
    if (tid < h) sh.x[tid] = g1_add(sh.x[tid], sh.x[tid + h]);
    __syncthreads();
  }
  if (tid == 0) g1_store(X, sh.x[0]);
}

// buckets: (nwin, nb, 24); block b covers segments [b MSM_BLOCK,
// (b + 1) MSM_BLOCK) of s buckets each and writes xy[b] = (X, Y)
__global__ void __launch_bounds__(MSM_BLOCK, MSM_MIN_BLOCKS)
bucket_reduce_seg_kernel(const uint32_t* __restrict__ buckets, int s, int lg,
                         uint32_t* __restrict__ xy) {
  const long long g = (long long)blockIdx.x * MSM_BLOCK + threadIdx.x;
  G1P a, S;
  seg_sums(buckets + 24 * g * s, s, &a, &S);
  __shared__ CombineShared sh;
  block_combine(a, S, lg, xy + 48 * (long long)blockIdx.x,
                xy + 48 * (long long)blockIdx.x + 24, sh);
}

// one block a window over its nblk (<= MSM_BLOCK) block items
__global__ void __launch_bounds__(MSM_BLOCK, MSM_MIN_BLOCKS)
bucket_reduce_final_kernel(const uint32_t* __restrict__ xy, int nblk, int lg,
                           uint32_t* __restrict__ out) {
  const int t = threadIdx.x;
  const uint32_t* item = xy + 48 * ((long long)blockIdx.x * nblk + t);
  G1P a = g1_identity(), S = g1_identity();
  if (t < nblk) {
    a = g1_load(item);
    S = g1_load(item + 24);
  }
  __shared__ CombineShared sh;
  block_combine(a, S, lg, out + 24 * (long long)blockIdx.x, nullptr, sh);
}

static long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// basis (., 16) affine rows; keys, entries: the n sorted entries; dense:
// (nd, 24) out; meta (m, 2) and pts (m, 48) scratch, m = n1 + n2 + 1 with
// n1 = cdiv(cdiv(n, k), MSM_BLOCK) and n2 = cdiv(n1, MSM_BLOCK)
extern "C" int quill_msm_bucket_sums(const void* basis, const void* keys,
                                     const void* entries, long long n, int k,
                                     long long nd, void* dense, void* meta,
                                     void* pts, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t* d = (uint32_t*)dense;
  bucket_fill_kernel<<<(unsigned)cdiv(nd, MSM_BLOCK), MSM_BLOCK, 0, st>>>(d,
                                                                          nd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n == 0) return (int)e;
  const long long n1 = cdiv(cdiv(n, k), MSM_BLOCK), n2 = cdiv(n1, MSM_BLOCK);
  int* m1 = (int*)meta;
  int* m2 = m1 + 2 * n1;
  int* m3 = m2 + 2 * n2;
  uint32_t* p1 = (uint32_t*)pts;
  uint32_t* p2 = p1 + 48 * n1;
  uint32_t* p3 = p2 + 48 * n2;
  bucket_sum_kernel<<<(unsigned)n1, MSM_BLOCK, 0, st>>>(
      (const uint32_t*)basis, (const int*)keys, (const int*)entries, n, k, d,
      m1, p1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bucket_fix_kernel<<<(unsigned)n2, MSM_BLOCK, 0, st>>>(m1, p1, n1, 1, d, m2,
                                                         p2);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bucket_fix_kernel<<<1, MSM_BLOCK, 0, st>>>(m2, p2, n2, cdiv(n2, MSM_BLOCK),
                                             d, m3, p3);
  return (int)cudaGetLastError();
}

// buckets (nwin, nb, 24); s buckets a segment, a power of two with nb a
// multiple of s MSM_BLOCK and nb / (s MSM_BLOCK) <= MSM_BLOCK; xy:
// (nwin nb / (s MSM_BLOCK), 48) scratch; out (nwin, 24)
extern "C" int quill_msm_bucket_reduce(const void* buckets, int nwin, int nb,
                                       int s, void* xy, void* out,
                                       void* stream) {
  if (s < 1 || (s & (s - 1)) != 0 || nb % (s * MSM_BLOCK) != 0 ||
      nb / (s * MSM_BLOCK) > MSM_BLOCK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = nb / (s * MSM_BLOCK);
  int lg = 0;
  while ((1 << lg) < s) ++lg;
  bucket_reduce_seg_kernel<<<nwin * nblk, MSM_BLOCK, 0, st>>>(
      (const uint32_t*)buckets, s, lg, (uint32_t*)xy);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int lgb = 0;
  while ((1 << lgb) < MSM_BLOCK) ++lgb;
  bucket_reduce_final_kernel<<<nwin, MSM_BLOCK, 0, st>>>(
      (const uint32_t*)xy, nblk, lg + lgb, (uint32_t*)out);
  return (int)cudaGetLastError();
}
