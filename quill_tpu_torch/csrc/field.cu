// Kernel L: the elementwise Montgomery product, quill_tpu_torch/fields/vec.py.
//
// L  mont_mul  replaces quill_tpu/fields/pallas8.py:_mul_kernel
//              (mont_mul_vec): out[i] = a[i] b[i] / 2^256 mod p over Fr or
//              Fq, canonical in and out, bn254.cuh's CIOS fe_mul.
//
// The TPU kernel held 33 lazy 8-bit limbs in f32 (R = 2^264) and split the
// product between the vector unit (the limb convolution) and the matrix unit
// (the reduction matmuls).  Here an element is eight uint32 limbs (R = 2^256)
// and one thread does one product with 32x32->64-bit multiply-adds.
//
// Bound on the card: 264 32-bit multiply-adds a product against 96 bytes (two
// operands read, one written), 2.75 operations a byte, below the card's ~5
// (132 SMs x 64 a clock at 1.98 GHz against 3.35 TB/s): memory-bound.  Design:
// each thread moves its 32-byte rows as two 16-byte vector loads and stores,
// so a warp reads 1 KB of contiguous memory per operand.
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

#define FIELD_BLOCK 256

static __device__ __forceinline__ Fe load4(const uint4* p) {
  uint4 lo = p[0], hi = p[1];
  Fe r;
  r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
  r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
  return r;
}

static __device__ __forceinline__ void store4(uint4* p, const Fe& a) {
  p[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  p[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

template <class M>
__global__ void __launch_bounds__(FIELD_BLOCK)
mont_mul_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                long long n, uint4* __restrict__ out) {
  long long i = (long long)blockIdx.x * FIELD_BLOCK + threadIdx.x;
  if (i >= n) return;
  store4(out + 2 * i, fe_mul<M>(load4(a + 2 * i), load4(b + 2 * i)));
}

// a, b, out: (n, 8) words, 16-byte aligned; field 0 = Fr, 1 = Fq.
extern "C" int quill_mont_mul(const void* a, const void* b, long long n,
                              int field, void* out, void* stream) {
  if (n <= 0) return 0;
  if (field != 0 && field != 1) return (int)cudaErrorInvalidValue;
  unsigned blocks = (unsigned)((n + FIELD_BLOCK - 1) / FIELD_BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    mont_mul_kernel<FrM><<<blocks, FIELD_BLOCK, 0, s>>>(
        (const uint4*)a, (const uint4*)b, n, (uint4*)out);
  else
    mont_mul_kernel<FqM><<<blocks, FIELD_BLOCK, 0, s>>>(
        (const uint4*)a, (const uint4*)b, n, (uint4*)out);
  return (int)cudaGetLastError();
}
