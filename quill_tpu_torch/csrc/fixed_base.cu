// Kernel J: fixed-base scalar multiplication for the tau-powers CRS and its
// table, quill_tpu_torch/ec/fixed_base.py.
//
// J  fixed_base  replaces quill_tpu/ec/fixed_base.py:90 _k_fixed_base_chunk
//                (plain XLA in the TPU build: a 64-step fori_loop of table
//                gathers and complete adds over a 2^16-point chunk) and :158
//                _batch_normalize (XLA): out[i] = s_i G as an affine row.
//
// Layout: scalars are (n, 8) uint32 canonical limbs (not Montgomery); the
// table is (nwin, 2^(w-1), 16) affine rows, row (k, |d| - 1) = |d| 2^(w k)
// G; out is (n, 16) affine rows (x, y in Montgomery form); flag one int,
// set to 1 where a point is at infinity.  One launch covers any n: blocks
// of up to FB_SPAN points (fewer where n would not fill the card), each
// normalised by Montgomery's trick with one inversion (csrc/fixed_base.cuh
// has the thread and block bodies and the design).  The CRS takes two launches: the table, over a small table that
// the host makes once, then the CRS over that table.
//
// Bound on the card: integer multiply throughput, (nwin - 1) mixed adds of
// 11 CIOS products and ~5 products of normalisation a point, against 32
// bytes read and 64 written.  Occupancy: 128 threads, 4 blocks an SM (56 KB
// of shared memory a block; ptxas held to 128 registers).
#include <cuda_runtime.h>

#include "bn254.cuh"
#include "fixed_base.cuh"

using namespace bn254;

#define FB_MINB 4
// the rule halves the points a thread while a launch would give an SM fewer
// than FB_FILL blocks: on an H100 (PERF.md, PR 11) a 2^16-point launch
// took 1.00 / 1.04 / 1.09 ms at 1 / 2 / 4 points a thread, the 2^18 +
// 1-point CRS 4.98 / 4.16 / 3.95
#define FB_FILL 2

__global__ void __launch_bounds__(FB_NT, FB_MINB)
fixed_base_kernel(const uint32_t* __restrict__ scalars, long long n,
                  const uint32_t* __restrict__ table, int w, int nwin,
                  int ppt, uint32_t* __restrict__ out,
                  int* __restrict__ flag) {
  extern __shared__ uint4 fb_sh[];
  uint32_t* sh = reinterpret_cast<uint32_t*>(fb_sh);
  const long long b = blockIdx.x;
  const int t = threadIdx.x, span = FB_NT * ppt;
  bool bad = false;
#pragma unroll 1
  for (int j = 0; j < ppt; ++j)
    bad |= fb_compute(scalars, n, table, w, nwin, b, span, j * FB_NT + t, sh);
  if (bad) *flag = 1;
  Fe c[FB_PPT];
  fb_chain(sh, t, ppt, c);
  __syncthreads();
#pragma unroll 1
  for (int lvl = FB_NT / 2; lvl >= 1; lvl >>= 1) {
    if (t < lvl) fb_heap_up(sh, lvl + t);
    __syncthreads();
  }
  if (t == 0) fb_heap_invert(sh);
  __syncthreads();
#pragma unroll 1
  for (int lvl = 1; lvl < FB_NT; lvl <<= 1) {
    if (t < lvl) fb_heap_down(sh, lvl + t);
    __syncthreads();
  }
  fb_back(sh, t, ppt, c);
  __syncthreads();
  for (int i = t; i < 4 * span; i += FB_NT) fb_store(out, n, b, span, i, sh);
}

// scalars: (n, 8) canonical; table: (fb_windows(w) 2^(w-1), 16) affine;
// out: (n, 16) affine; flag: one int, left alone or set to 1
extern "C" int quill_fixed_base(const void* scalars, long long n,
                                const void* table, int w, void* out,
                                void* flag, void* stream) {
  if (n <= 0) return 0;
  if (w < 1 || w > FB_WMAX) return (int)cudaErrorInvalidValue;
  const int bytes = 4 * fb_words();
  static int set = (int)cudaFuncSetAttribute(
      fixed_base_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != 0) return set;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int ppt = fb_ppt(n, sms > 0 ? sms : 1, FB_FILL);
  fixed_base_kernel<<<(unsigned)fb_blocks(n, ppt), FB_NT, bytes,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)scalars, n, (const uint32_t*)table, w, fb_windows(w),
      ppt, (uint32_t*)out, (int*)flag);
  return (int)cudaGetLastError();
}
