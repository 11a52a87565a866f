// Kernel J: fixed-base scalar multiplication for the tau-powers CRS,
// quill_tpu_torch/ec/fixed_base.py.
//
// J  fixed_base  replaces quill_tpu/ec/fixed_base.py:_k_fixed_base_chunk
//                (plain XLA in the TPU build: a 64-step fori_loop of table
//                gathers and complete adds over a 2^16-point chunk):
//                out[i] = sum_w T[w][digit_w(s_i)], T[w][d] = d 2^(4w) G, the
//                64 four-bit digits of the canonical scalar s_i.
//
// Layout: scalars are (n, 8) uint32 canonical limbs (not Montgomery); the
// table is (64, 16) projective points of 24 words (X, Y, Z in Montgomery
// form, bn254.cuh), T[w][0] the identity (0 : 1 : 0), every other entry
// affine with Z = 1; out is (n, 24).  One thread computes one point: 64
// complete projective adds (g1_add handles the identity entries, so there
// is no branch on the digit).  Bound on the card: integer multiply
// throughput, 64 x 12 CIOS products (64 x 3,168 32-bit multiply-adds) per
// point against 32 bytes read and 96 written.  The 98 KB table is read
// through the caches: every thread of a block reads the same window's row
// at the same step.  Design: nothing but bn254.cuh's arithmetic in
// registers; a mixed add (11 products) or a larger window is later work.
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

#define FB_BLOCK 128
#define FB_WINDOW 4
#define FB_DIGITS 16

__global__ void __launch_bounds__(FB_BLOCK)
fixed_base_kernel(const uint32_t* __restrict__ scalars,
                  const uint32_t* __restrict__ table, long long n,
                  uint32_t* __restrict__ out) {
  long long i = (long long)blockIdx.x * FB_BLOCK + threadIdx.x;
  if (i >= n) return;
  G1P acc = g1_identity();
#pragma unroll 1
  for (int k = 0; k < 8; ++k) {
    uint32_t limb = scalars[8 * i + k];
#pragma unroll 1
    for (int j = 0; j < 32 / FB_WINDOW; ++j) {
      int w = k * (32 / FB_WINDOW) + j;
      uint32_t d = (limb >> (FB_WINDOW * j)) & (FB_DIGITS - 1);
      acc = g1_add(acc, g1_load(table + 24 * (FB_DIGITS * w + d)));
    }
  }
  g1_store(out + 24 * i, acc);
}

// scalars: (n, 8) canonical; table: (64 * 16, 24); out: (n, 24)
extern "C" int quill_fixed_base(const void* scalars, const void* table,
                                long long n, void* out, void* stream) {
  if (n <= 0) return 0;
  unsigned blocks = (unsigned)((n + FB_BLOCK - 1) / FB_BLOCK);
  fixed_base_kernel<<<blocks, FB_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)scalars, (const uint32_t*)table, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}
