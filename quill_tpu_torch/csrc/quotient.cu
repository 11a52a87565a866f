// Kernel M: the batched KZG quotient, quill_tpu_torch/engine/quotient.py.
//
// M  quotient  replaces quill_tpu/engine/quotient.py:127 quotient_many_device
//              (XLA in the TPU build: per 2^16-coefficient chunk, a power
//              table product, a Hillis-Steele prefix scan and a combine,
//              with the chunk offsets carried on the device): for each of
//              up to QUOT_MAX_JOBS openings (c, x), y = p(x) and the
//              coefficients of (p - y) / (X - x), by Ruffini's recurrence
//              (quotient.cuh).
//
// Layout: c and out are (n, 8) uint32 Fr elements in Montgomery form
// (bn254.cuh), 16-byte aligned; out gets q_0 .. q_{n-2} and a zero at n - 1.
// The jobs' pointers, lengths, x and x^r travel by value in the launch
// parameters (QuotJobs), so a batch copies nothing to the card.
//
// Three launches a batch (quotient.cuh has the per-thread pieces):
// 1. quot_scan_kernel, one block a tile of QUOT_BLOCK runs of r
//    coefficients: each thread computes its run's map (one product a
//    coefficient), the block scans the maps from the top (warp shuffles,
//    then the warp totals through shared memory) into each run's map from
//    the tile's top and the tile's map;
// 2. quot_tiles_kernel, one block a job: each job's tile maps scanned from
//    the top into each tile's H at its top, and the job's y into ys;
// 3. quot_finish_kernel, the grid of phase 1: each run's H at its top, then
//    the recurrence again, q written once.
// The host reads the jobs' y back once (engine/quotient.py), the batch's
// only synchronisation.
//
// Bound on this card: integer multiply throughput.  The recurrence is two
// Fr products a coefficient (phase 1's and phase 3's), 264 32-bit
// multiply-adds each, no inverse table; the scans add 2 products a
// composition, ~18 a run in the block scan, ~18 / r a coefficient (the
// wrapper picks r from 32 to 128 by the batch's size).  c is read twice
// (phases 1 and 3) and q written once, 96 bytes a coefficient: ~11
// operations a byte, above the card's ~5.  Reading c once would need
// phases 1 and 3 in one launch, each tile waiting for the tiles above it
// with its c held on chip.  The function's least work, which
// chip_smoke.py's bound counts, is Horner's one product a coefficient and
// 64 bytes; run in parallel it takes two.  The CIOS product is kernel L's
// (bn254.cuh fe_mul).
#include <cuda_runtime.h>

#include "quotient.cuh"

using namespace bn254;

#define QUOT_MAX_JOBS 16
#define FULL_MASK 0xffffffffu

struct QuotJobs {
  const uint32_t* c[QUOT_MAX_JOBS];
  uint32_t* out[QUOT_MAX_JOBS];
  long long n[QUOT_MAX_JOBS];
  long long tile0[QUOT_MAX_JOBS + 1];  // first tile of each job; [jobs]: all
  Fe x[QUOT_MAX_JOBS];                 // x, Montgomery form
  Fe xr[QUOT_MAX_JOBS];                // x^r
  int jobs;
};

__device__ __forceinline__ QtMap map_shfl_down(const QtMap& m, unsigned d) {
  QtMap r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.a.v[i] = __shfl_down_sync(FULL_MASK, m.a.v[i], d);
    r.b.v[i] = __shfl_down_sync(FULL_MASK, m.b.v[i], d);
  }
  return r;
}

// exclusive scan of the threads' maps from the top: thread t gets
// m_(t+1) o ... o m_(QUOT_BLOCK-1) (every thread calls it once); *total gets
// m_0 o ... o m_(QUOT_BLOCK-1)
__device__ __forceinline__ QtMap block_scan_from_top(const QtMap& m,
                                                     QtMap* total) {
  __shared__ QtMap wtot[QUOT_BLOCK / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  QtMap s = m;  // inclusive: m_t o ... o m_(end of the warp)
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    const QtMap o = map_shfl_down(s, d);
    if (lane + d < 32) s = qt_compose(s, o);
  }
  QtMap excl = map_shfl_down(s, 1);
  if (lane == 31) excl = qt_identity();
  if (lane == 0) wtot[warp] = s;
  __syncthreads();
  QtMap above = qt_identity();  // the warps above this one
#pragma unroll 1
  for (int w = QUOT_BLOCK / 32 - 1; w > warp; --w)
    above = qt_compose(wtot[w], above);
  if (threadIdx.x == 0) *total = qt_compose(wtot[0], above);
  return qt_compose(excl, above);
}

__device__ __forceinline__ int job_of(const QuotJobs& J, long long tile) {
  int j = 0;
  while (j + 1 < J.jobs && J.tile0[j + 1] <= tile) ++j;
  return j;
}

// this thread's run [lo, hi) of tile g of job j (empty past the job's end)
__device__ __forceinline__ void run_of(const QuotJobs& J, int j, long long g,
                                       long long r, long long* lo,
                                       long long* hi) {
  const long long n = J.n[j];
  long long a = (g - J.tile0[j]) * (QUOT_BLOCK * r) + threadIdx.x * r;
  if (a > n) a = n;
  *lo = a;
  *hi = a + r < n ? a + r : n;
}

__device__ __forceinline__ void map_store(uint32_t* p, const QtMap& m) {
  fe_store16(p, m.a);
  fe_store16(p + 8, m.b);
}

__device__ __forceinline__ QtMap map_load(const uint32_t* p) {
  QtMap m;
  m.a = fe_load16(p);
  m.b = fe_load16(p + 8);
  return m;
}

__global__ void __launch_bounds__(QUOT_BLOCK)
quot_scan_kernel(const __grid_constant__ QuotJobs J, long long r,
                 uint32_t* __restrict__ runc, uint32_t* __restrict__ tilet) {
  const long long g = blockIdx.x;
  const int j = job_of(J, g);
  long long lo, hi;
  run_of(J, j, g, r, &lo, &hi);
  const QtMap m = qt_run_map(J.c[j], J.x[j], J.xr[j], r, lo, hi);
  __shared__ QtMap total;
  const QtMap excl = block_scan_from_top(m, &total);
  map_store(runc + (g * QUOT_BLOCK + threadIdx.x) * 16, excl);
  __syncthreads();
  if (threadIdx.x == 0) map_store(tilet + g * 16, total);
}

// tilet[k]: tile k's map in, its H at the top out (first 8 words)
__global__ void __launch_bounds__(QUOT_BLOCK)
quot_tiles_kernel(const __grid_constant__ QuotJobs J,
                  uint32_t* __restrict__ tilet, uint32_t* __restrict__ ys) {
  const int j = blockIdx.x;
  const long long nt = J.tile0[j + 1] - J.tile0[j];
  const long long per = (nt + QUOT_BLOCK - 1) / QUOT_BLOCK;
  long long lo = threadIdx.x * per;
  if (lo > nt) lo = nt;
  const long long hi = lo + per < nt ? lo + per : nt;
  uint32_t* t = tilet + J.tile0[j] * 16;
  QtMap acc = qt_identity();
#pragma unroll 1
  for (long long k = hi - 1; k >= lo; --k)
    acc = qt_compose(map_load(t + 16 * k), acc);
  __shared__ QtMap total;
  QtMap cur = block_scan_from_top(acc, &total);
#pragma unroll 1
  for (long long k = hi - 1; k >= lo; --k) {
    const QtMap tk = map_load(t + 16 * k);
    fe_store16(t + 16 * k, cur.b);  // H at the tile's top: cur applied to 0
    cur = qt_compose(tk, cur);
  }
  __syncthreads();
  if (threadIdx.x == 0) fe_store16(ys + 8 * j, total.b);
}

__global__ void __launch_bounds__(QUOT_BLOCK)
quot_finish_kernel(const __grid_constant__ QuotJobs J, long long r,
                   const uint32_t* __restrict__ runc,
                   const uint32_t* __restrict__ tilet) {
  const long long g = blockIdx.x;
  const int j = job_of(J, g);
  long long lo, hi;
  run_of(J, j, g, r, &lo, &hi);
  if (lo >= hi) return;
  const QtMap m = map_load(runc + (g * QUOT_BLOCK + threadIdx.x) * 16);
  const Fe h = fe_add<FrM>(m.b, fe_mul<FrM>(m.a, fe_load16(tilet + g * 16)));
  qt_run_finish(J.c[j], J.x[j], lo, hi, J.n[j], h, J.out[j]);
}

// c[j], out[j]: (n[j], 8) words, 16-byte aligned, n[j] >= 1; x, xr: (jobs,
// 8) words on the host, x and x^r in Montgomery form; r: coefficients a run;
// tiles: sum_j ceil(n[j] / (128 r)); runc: (tiles, 128, 16) and tilet:
// (tiles, 16) scratch; ys: (jobs, 8) out.
extern "C" int quill_quotient(const void* const* c, void* const* out,
                              const long long* n, const uint32_t* x,
                              const uint32_t* xr, int jobs, long long r,
                              long long tiles, void* runc, void* tilet,
                              void* ys, void* stream) {
  if (jobs <= 0) return 0;
  if (jobs > QUOT_MAX_JOBS || r <= 0) return (int)cudaErrorInvalidValue;
  QuotJobs J;
  J.jobs = jobs;
  J.tile0[0] = 0;
  for (int j = 0; j < jobs; ++j) {
    if (n[j] <= 0) return (int)cudaErrorInvalidValue;
    J.c[j] = (const uint32_t*)c[j];
    J.out[j] = (uint32_t*)out[j];
    J.n[j] = n[j];
    J.x[j] = fe_load(x + 8 * j);
    J.xr[j] = fe_load(xr + 8 * j);
    J.tile0[j + 1] =
        J.tile0[j] + (n[j] + QUOT_BLOCK * r - 1) / (QUOT_BLOCK * r);
  }
  if (J.tile0[jobs] != tiles) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  quot_scan_kernel<<<(unsigned)tiles, QUOT_BLOCK, 0, s>>>(
      J, r, (uint32_t*)runc, (uint32_t*)tilet);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  quot_tiles_kernel<<<(unsigned)jobs, QUOT_BLOCK, 0, s>>>(
      J, (uint32_t*)tilet, (uint32_t*)ys);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  quot_finish_kernel<<<(unsigned)tiles, QUOT_BLOCK, 0, s>>>(
      J, r, (const uint32_t*)runc, (const uint32_t*)tilet);
  return (int)cudaGetLastError();
}
