// Kernel I: the segmented point scan of the v8 MSM route,
// quill_tpu_torch/ec/msm8.py.
//
// I  seg_scan  replaces quill_tpu/fields/pallas8.py:_seg_scan_kernel
//              (seg_scan): for every lane independently, along its steps,
//              y[0] = x[0] and y[s] = flag[s] ? x[s] : y[s-1] + x[s]
//              (with no flags, a plain inclusive scan).  The route runs it
//              on one CRS chunk's sorted entries (lanes of 256 consecutive
//              entries of one window), on the block totals of each window,
//              and twice over each window's 8192 buckets (the triangle).
//
// Layout: xs and ys are (m, s, 24) uint32, lane-major: a lane's steps are
// consecutive points (X, Y, Z in Montgomery form, bn254.cuh), so the route's
// sorted sequences reshape into lanes without a transpose; flags is (m, s)
// bytes or NULL.  The TPU kernel kept (S, 3L, M) f32 tiles with the step
// axis leading, because its grid walked the steps in order and carried the
// running sum in VMEM scratch.  Here one thread owns one lane and carries
// the running sum in registers through its s steps; lanes run in parallel.
// Bound on the card: integer multiply throughput, one complete add (12 CIOS
// products, 3,168 32-bit multiply-adds) per step against 193 bytes moved.
// But a chunk has only 20 x 256 lanes (the block scan 20, the triangle 640),
// far fewer threads than the card holds, so the scan is bound in practice by
// the latency of 256 dependent adds; one warp per block spreads the few
// warps over as many SMs as possible.  A scan with more lanes (shorter
// blocks and a wider second level) is later work.
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

#define SCAN_BLOCK 32

__global__ void __launch_bounds__(SCAN_BLOCK)
seg_scan_kernel(const uint32_t* __restrict__ xs,
                const uint8_t* __restrict__ flags, long long m, long long s,
                uint32_t* __restrict__ ys) {
  long long lane = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
  if (lane >= m) return;
  const uint32_t* x = xs + lane * s * 24;
  uint32_t* y = ys + lane * s * 24;
  const uint8_t* f = flags == nullptr ? nullptr : flags + lane * s;
  G1P acc = g1_identity();
#pragma unroll 1
  for (long long t = 0; t < s; ++t) {
    G1P p = g1_load(x + 24 * t);
    if (f != nullptr && f[t]) {
      acc = p;
    } else {
      acc = g1_add(acc, p);
    }
    g1_store(y + 24 * t, acc);
  }
}

// xs, ys: (m, s, 24); flags: (m, s) bytes or NULL.  ys may not alias xs.
extern "C" int quill_seg_scan(const void* xs, const void* flags, long long m,
                              long long s, void* ys, void* stream) {
  if (m <= 0 || s <= 0) return 0;
  unsigned blocks = (unsigned)((m + SCAN_BLOCK - 1) / SCAN_BLOCK);
  seg_scan_kernel<<<blocks, SCAN_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)xs, (const uint8_t*)flags, m, s, (uint32_t*)ys);
  return (int)cudaGetLastError();
}
