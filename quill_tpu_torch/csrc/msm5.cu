// Kernels E to H: the point adds of the small-MSM route (shifted basis +
// prefix tree), quill_tpu_torch/ec/msm5.py.
//
// E  pt_add      replaces quill_tpu/fields/pallas8.py:_stacked_combine_kernel
//                (pt_add_stacked and its flagged mode seg_combine_stacked):
//                out[i] = flags && flags[i] ? b[i] : a[i] + b[i].
//    shifted_basis  replaces E's doubling ladder (quill_tpu/ec/msm3.py:90
//                _shift_doubling, one _stacked_combine_kernel launch a
//                doubling) and the batch normalisation after it: for n
//                points, nwin windows of 2^(wbits w) P_i as affine rows,
//                one launch (below).
//    pt_dbl      k doublings of each point in one launch (v8's triangle,
//                ec/msm8.py, where E added a point to itself k times).
// F  tree_up0    replaces quill_tpu/ec/msm5.py:_up0_kernel: the affine leaf
//                level, out[j] = leaf[2j] + leaf[2j+1] with Z1 = Z2 = 1 (9
//                products instead of 12), projective out.
// G  tree_up     replaces quill_tpu/ec/msm3.py:_up_kernel: one projective
//                up-sweep level, out[j] = x[2j] + x[2j+1]; also the collect's
//                pairwise reduction.
// H  tree_down   replaces quill_tpu/ec/msm3.py:_down_kernel: one down-sweep
//                level, out[2j+1] = i[j], out[2j] = i[j] + (-u[2j+1]),
//                negation being Y -> -Y.
//
// The TPU kernels worked on (S, 3L, M) tiles of 8-bit limbs in f32 so that
// a level was a few large dispatches.  Here a point is 24 uint32 words (X,
// Y, Z, each eight Montgomery limbs, bn254.cuh) and one thread does one
// complete add.  Bound on the card: integer multiply throughput.  A complete
// add is 12 CIOS products (9 for F), each 128 32x32->64-bit multiply-adds
// (a low and a high IMAD) and 8 low products: 3,168 32-bit multiply-adds
// (2,376 for F), against 224 to 384 bytes read and written: 8 to 11
// operations a byte, above the card's ~5 int32
// multiply-adds a byte (132 SMs x 64 a clock against 3.35 TB/s).  Design: the
// arithmetic is bn254.cuh's, kept in registers; nothing is staged in shared
// memory, since every byte is read once.
//
// The shifted basis: one thread a base point, its windows' doublings in
// registers and their normalisation by Montgomery's trick inside the
// thread (csrc/ladder.cuh has the thread body and its design).
#include <cuda_runtime.h>

#include "bn254.cuh"
#include "ladder.cuh"

using namespace bn254;

#define MSM5_BLOCK 128

__global__ void __launch_bounds__(MSM5_BLOCK)
pt_add_kernel(const uint32_t* a, const uint32_t* b,
              const uint8_t* __restrict__ flags, long long n, uint32_t* out) {
  long long i = (long long)blockIdx.x * MSM5_BLOCK + threadIdx.x;
  if (i >= n) return;
  G1P q = g1_load(b + 24 * i);
  if (flags != nullptr && flags[i]) {
    g1_store(out + 24 * i, q);
    return;
  }
  g1_store(out + 24 * i, g1_add(g1_load(a + 24 * i), q));
}

__global__ void __launch_bounds__(MSM5_BLOCK)
tree_up0_kernel(const uint32_t* __restrict__ leaves, long long k,
                uint32_t* __restrict__ out) {
  long long j = (long long)blockIdx.x * MSM5_BLOCK + threadIdx.x;
  if (j >= k) return;
  G1A p = g1a_load(leaves + 32 * j);
  G1A q = g1a_load(leaves + 32 * j + 16);
  g1_store(out + 24 * j, g1_add_affine(p, q));
}

__global__ void __launch_bounds__(MSM5_BLOCK)
tree_up_kernel(const uint32_t* __restrict__ x, long long k,
               uint32_t* __restrict__ out) {
  long long j = (long long)blockIdx.x * MSM5_BLOCK + threadIdx.x;
  if (j >= k) return;
  G1P p = g1_load(x + 48 * j);
  G1P q = g1_load(x + 48 * j + 24);
  g1_store(out + 24 * j, g1_add(p, q));
}

__global__ void __launch_bounds__(MSM5_BLOCK)
tree_down_kernel(const uint32_t* __restrict__ in,
                 const uint32_t* __restrict__ u, long long k,
                 uint32_t* __restrict__ out) {
  long long j = (long long)blockIdx.x * MSM5_BLOCK + threadIdx.x;
  if (j >= k) return;
  G1P p = g1_load(in + 24 * j);
  G1P q = g1_load(u + 48 * j + 24);
  q.y = fe_neg<FqM>(q.y);
  g1_store(out + 48 * j, g1_add(p, q));
  g1_store(out + 48 * j + 24, p);
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

// a, b, out: (n, 24) words; flags: (n,) bytes or NULL.  out may not alias
// a or b.
extern "C" int quill_pt_add(const void* a, const void* b, const void* flags,
                            long long n, void* out, void* stream) {
  if (n <= 0) return 0;
  pt_add_kernel<<<blocks(n), MSM5_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (const uint8_t*)flags, n,
      (uint32_t*)out);
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

// leaves: (2k, 16) affine words; out: (k, 24)
extern "C" int quill_tree_up0(const void* leaves, long long k, void* out,
                              void* stream) {
  if (k <= 0) return 0;
  tree_up0_kernel<<<blocks(k), MSM5_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)leaves, k, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// x: (2k, 24); out: (k, 24)
extern "C" int quill_tree_up(const void* x, long long k, void* out,
                             void* stream) {
  if (k <= 0) return 0;
  tree_up_kernel<<<blocks(k), MSM5_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, k, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// in: (k, 24) prefixes; u: (2k, 24) the level below; out: (2k, 24)
extern "C" int quill_tree_down(const void* in, const void* u, long long k,
                               void* out, void* stream) {
  if (k <= 0) return 0;
  tree_down_kernel<<<blocks(k), MSM5_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (const uint32_t*)u, k, (uint32_t*)out);
  return (int)cudaGetLastError();
}
