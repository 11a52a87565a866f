// Kernel K: the affine level 0 of the v6 MSM's tree, quill_tpu_torch/ec/msm6.py.
//
// K  level0   replaces quill_tpu/ec/msm6k.py:_lvl0_kernel (_lvl_call(h,
//             affine=True)): node j of level 1 is the sum of the sorted
//             leaves 2j and 2j + 1, out[j] = sh[idx[2j]] + sh[idx[2j+1]],
//             with the complete affine + affine add (bn254.cuh:
//             g1_add_affine, 9 products, Z1 = Z2 = 1), projective out.
//
// The TPU kernel read the contiguous halves (c, c + h) of a leaf array that
// an XLA gather had first written in bit-reversed sorted order
// (ec/msm6.py:_k_sort_gather, 2^24 leaves x 66 bytes at 2^20 points), because
// a Pallas kernel could not gather.  Here each thread gathers its own two
// leaves from the shifted basis through the sort's row index, so no leaf
// array is ever written, and the tree stays in sorted order.  Padded and
// clamped elements make pairs of equal points; the formula is complete, so
// P + P and P + (-P) need no branch.
//
// Bound on the card: integer multiply throughput, as for kernel F
// (csrc/msm5.cu): 9 CIOS products (2,376 32-bit multiply-adds) a pair against
// 8 bytes of index, 128 bytes gathered and 96 written, ~10 operations a byte
// against the card's ~5.  The gathered rows are whole 64-byte segments, so a
// gather wastes no sector.  Design: one thread a pair, bn254.cuh's arithmetic
// in registers, nothing staged in shared memory (every byte is read once).
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

#define MSM6_BLOCK 128

__global__ void __launch_bounds__(MSM6_BLOCK)
level0_kernel(const uint32_t* __restrict__ sh, const int* __restrict__ idx,
              long long k, uint32_t* __restrict__ out) {
  long long j = (long long)blockIdx.x * MSM6_BLOCK + threadIdx.x;
  if (j >= k) return;
  G1A p = g1a_load(sh + 16LL * idx[2 * j]);
  G1A q = g1a_load(sh + 16LL * idx[2 * j + 1]);
  g1_store(out + 24 * j, g1_add_affine(p, q));
}

// sh: (rows, 16) affine words; idx: (2k,) int32 rows of sh, each < rows;
// out: (k, 24)
extern "C" int quill_msm6_level0(const void* sh, const void* idx, long long k,
                                 void* out, void* stream) {
  if (k <= 0) return 0;
  unsigned blocks = (unsigned)((k + MSM6_BLOCK - 1) / MSM6_BLOCK);
  level0_kernel<<<blocks, MSM6_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sh, (const int*)idx, k, (uint32_t*)out);
  return (int)cudaGetLastError();
}
