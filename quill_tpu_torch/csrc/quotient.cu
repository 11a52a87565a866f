// Kernel M: the batched KZG quotient, quill_tpu_torch/engine/quotient.py.
//
// M  quotient  replaces quill_tpu/engine/quotient.py:127 quotient_many_device
//              (XLA in the TPU build: per 2^16-coefficient chunk, a power
//              table product, a Hillis-Steele prefix scan and a combine,
//              with the chunk offsets carried on the device): for each of
//              up to QUOT_MAX_JOBS openings (c, x), y = p(x) and
//              q_k = (y - P_k) x^-(k+1), P_k = sum_{t <= k} c_t x^t.
//
// Layout: c and out are (n, 8) uint32 Fr elements in Montgomery form
// (bn254.cuh), 16-byte aligned; out gets q_0 .. q_{n-2} and a zero at n - 1.
// pows is (jobs, 2, QUOT_LOG, 8): the tables x^(2^i) and x^-(2^i) of each
// job, made on the host.  The jobs' pointers and lengths travel by value in
// the launch parameters (QuotJobs), so a batch copies only the tables.
//
// Three launches a batch (quotient.cuh has the per-thread pieces):
// 1. quot_scan_kernel, one block a tile of QUOT_BLOCK runs of r
//    coefficients: each thread writes its run's prefix sums of c_t x^t,
//    the block scans the run totals (warp shuffles, then the warp totals
//    through shared memory) into each run's carry and the tile's total;
// 2. quot_tiles_kernel, one block a job: each job's tile totals turned into
//    the tiles' carries, and their sum, y, into ys;
// 3. quot_finish_kernel, the grid of phase 1: carries added, q in place.
// The host reads the jobs' y back once (engine/quotient.py), the batch's
// only synchronisation.
//
// Bound on this card: integer multiply throughput.  This formula does four
// Fr products a coefficient (x^k, c_k x^k, x^-(k+1), (y - P_k) x^-(k+1)),
// 264 32-bit multiply-adds each, and moves 128 bytes (c read, P written, P
// read, q written).  The function needs half of both: Ruffini's recurrence
// q_{k-1} = c_k + x q_k, scanned in runs, takes two products a coefficient
// (the run's serial pass, and carry x^j stepped in the fix-up), no inverse
// table, c read once and q written once; chip_smoke.py's bound counts that,
// ~8 operations a byte, above the card's ~5.  A run also starts its two
// powers from the tables, ~log2(n) / 2 products each, which r = 32 spreads
// over the run.  The CIOS product is kernel L's (bn254.cuh fe_mul).
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
  int jobs;
};

__device__ __forceinline__ Fe fe_shfl_up(const Fe& a, unsigned d) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = __shfl_up_sync(FULL_MASK, a.v[i], d);
  return r;
}

// exclusive prefix sum of v over the block's QUOT_BLOCK threads (every
// thread calls it once); *total gets the block's sum
__device__ __forceinline__ Fe block_excl_scan(const Fe& v, Fe* total) {
  __shared__ Fe wsum[QUOT_BLOCK / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Fe s = v;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    const Fe o = fe_shfl_up(s, d);
    if (lane >= d) s = fe_add<FrM>(o, s);
  }
  if (lane == 31) wsum[warp] = s;
  __syncthreads();
  Fe before = fe_zero<FrM>(), all = fe_zero<FrM>();
#pragma unroll
  for (int w = 0; w < QUOT_BLOCK / 32; ++w) {
    if (w == warp) before = all;
    all = fe_add<FrM>(all, wsum[w]);
  }
  *total = all;
  return fe_add<FrM>(before, fe_sub<FrM>(s, v));
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

__global__ void __launch_bounds__(QUOT_BLOCK)
quot_scan_kernel(const QuotJobs J, const uint32_t* __restrict__ pows,
                 long long r, uint32_t* __restrict__ runc,
                 uint32_t* __restrict__ tilet) {
  const long long g = blockIdx.x;
  const int j = job_of(J, g);
  long long lo, hi;
  run_of(J, j, g, r, &lo, &hi);
  Fe acc = fe_zero<FrM>();
  if (lo < hi)
    acc = qt_run_scan(J.c[j], pows + (long long)j * 2 * QUOT_LOG * 8, lo, hi,
                      J.out[j]);
  Fe total;
  const Fe carry = block_excl_scan(acc, &total);
  fe_store16(runc + (g * QUOT_BLOCK + threadIdx.x) * 8, carry);
  if (threadIdx.x == 0) fe_store16(tilet + g * 8, total);
}

__global__ void __launch_bounds__(QUOT_BLOCK)
quot_tiles_kernel(const QuotJobs J, uint32_t* __restrict__ tilet,
                  uint32_t* __restrict__ ys) {
  const int j = blockIdx.x;
  const long long nt = J.tile0[j + 1] - J.tile0[j];
  const long long per = (nt + QUOT_BLOCK - 1) / QUOT_BLOCK;
  long long lo = threadIdx.x * per;
  if (lo > nt) lo = nt;
  const long long hi = lo + per < nt ? lo + per : nt;
  uint32_t* t = tilet + J.tile0[j] * 8;
  Fe acc = fe_zero<FrM>();
#pragma unroll 1
  for (long long k = lo; k < hi; ++k)
    acc = fe_add<FrM>(acc, fe_load16(t + 8 * k));
  Fe total;
  Fe carry = block_excl_scan(acc, &total);
#pragma unroll 1
  for (long long k = lo; k < hi; ++k) {
    const Fe v = fe_load16(t + 8 * k);
    fe_store16(t + 8 * k, carry);
    carry = fe_add<FrM>(carry, v);
  }
  if (threadIdx.x == 0) fe_store16(ys + 8 * j, total);
}

__global__ void __launch_bounds__(QUOT_BLOCK)
quot_finish_kernel(const QuotJobs J, const uint32_t* __restrict__ pows,
                   long long r, const uint32_t* __restrict__ runc,
                   const uint32_t* __restrict__ tilet,
                   const uint32_t* __restrict__ ys) {
  const long long g = blockIdx.x;
  const int j = job_of(J, g);
  long long lo, hi;
  run_of(J, j, g, r, &lo, &hi);
  if (lo >= hi) return;
  const long long t = g * QUOT_BLOCK + threadIdx.x;
  const Fe carry =
      fe_add<FrM>(fe_load16(tilet + g * 8), fe_load16(runc + t * 8));
  qt_run_finish(J.out[j], pows + ((long long)j * 2 + 1) * QUOT_LOG * 8, lo, hi,
                carry, fe_load16(ys + 8 * j));
}

// c[j], out[j]: (n[j], 8) words, 16-byte aligned, n[j] >= 1; pows: (jobs, 2,
// QUOT_LOG, 8); r: coefficients a run; tiles: sum_j ceil(n[j] / (128 r));
// runc: (tiles, 128, 8) and tilet: (tiles, 8) scratch; ys: (jobs, 8) out.
extern "C" int quill_quotient(const void* const* c, void* const* out,
                              const long long* n, int jobs, const void* pows,
                              long long r, long long tiles, void* runc,
                              void* tilet, void* ys, void* stream) {
  if (jobs <= 0) return 0;
  if (jobs > QUOT_MAX_JOBS || r <= 0) return (int)cudaErrorInvalidValue;
  QuotJobs J;
  J.jobs = jobs;
  J.tile0[0] = 0;
  for (int j = 0; j < jobs; ++j) {
    if (n[j] <= 0 || n[j] >= (1ll << QUOT_LOG))
      return (int)cudaErrorInvalidValue;
    J.c[j] = (const uint32_t*)c[j];
    J.out[j] = (uint32_t*)out[j];
    J.n[j] = n[j];
    J.tile0[j + 1] =
        J.tile0[j] + (n[j] + QUOT_BLOCK * r - 1) / (QUOT_BLOCK * r);
  }
  if (J.tile0[jobs] != tiles) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  quot_scan_kernel<<<(unsigned)tiles, QUOT_BLOCK, 0, s>>>(
      J, (const uint32_t*)pows, r, (uint32_t*)runc, (uint32_t*)tilet);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  quot_tiles_kernel<<<(unsigned)jobs, QUOT_BLOCK, 0, s>>>(
      J, (uint32_t*)tilet, (uint32_t*)ys);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  quot_finish_kernel<<<(unsigned)tiles, QUOT_BLOCK, 0, s>>>(
      J, (const uint32_t*)pows, r, (const uint32_t*)runc,
      (const uint32_t*)tilet, (const uint32_t*)ys);
  return (int)cudaGetLastError();
}
