// Kernel I: the segmented point scan of the v8 MSM route,
// quill_tpu_torch/ec/msm8.py.
//
// I  seg_scan  replaces quill_tpu/fields/pallas8.py:379 _seg_scan_kernel
//              (seg_scan): for every lane independently, along its steps,
//              y[0] = x[0] and y[t] = flag[t] ? x[t] : y[t-1] + x[t]
//              (with no flags, a plain inclusive scan).  The route runs it
//              on one CRS chunk's sorted entries (5,120 lanes of 256), on
//              the block totals of each window (20 lanes of up to 256), and
//              on each window's 8192 buckets (the triangle: 640 lanes of
//              256, then 20 x 32 and 40 x 32).
//
// Layout: xs and ys are (m, s, 24) uint32, lane-major: a lane's steps are
// consecutive points (X, Y, Z in Montgomery form, bn254.cuh); flags is
// (m, s) bytes or NULL; ys may not alias xs.
//
// Bound on this card: integer multiply throughput, one complete add (12 CIOS
// products) a step against 193 bytes moved (0.248 ms of operations against
// 0.076 ms of bytes for a chunk).  The TPU kernel walked the steps in its
// sequential grid, each step one SIMD add over 128 lanes.  One thread a lane
// on this card gave a chunk 5,120 threads (~1.2 warps an SM) and the block
// scan 20, so the scan was bound by the latency of s dependent adds.
//
// Design: T threads share a lane, each owning a run of r = ceil(s / T)
// consecutive steps (seg_scan.cuh).  Phase 1 scans each run from the
// identity and writes it out; phase 2 is a segmented scan of the T run
// totals, by __shfl_up_sync within a warp (log2 min(T, 32) levels) and, for
// T > 32, a shuffle scan of the warp totals passed through shared memory;
// phase 3 adds each run's exclusive carry-in to its steps before its first
// flag.  Those counts differ from run to run (a warp would wait for its
// longest), so the block numbers them by a prefix sum and deals them out
// evenly over its threads.  The dependent chain is about r + log2 T adds
// plus the block's share of fix-ups, instead of s.  A block of SCAN_BLOCK
// = 128 threads holds 128 / T whole lanes; __launch_bounds__(128, 3) keeps
// the kernel at 168 registers, three blocks (12 warps) an SM, where a first
// version with 256-thread blocks took 204 registers, one block (8 warps).
//
// The T rule (`threads_per_lane`): the smallest power of two that makes
// m * T at least one full wave of the card (SMs x the threads an SM keeps
// resident at this kernel's register count, from the occupancy API), and at
// most min(128, s rounded up to a power of two).  On an H100 (a wave of
// 132 x 3 x 128 = 50,688 threads) it gives the chunk scan T = 16, the block
// scan 128 and the triangle's lanes 128.  `python -m
// quill_tpu_torch.probe_seg_scan` times every T at these shapes (PERF.md):
// the chunk, the shape that runs most, is fastest at the rule's T.
//
// Memory: each thread loads and stores its run's points directly (24 words
// a point).  A 256-step lane is 24 KB, so staging a block's lanes in shared
// memory would cap a block at a few lanes and an SM at a few hundred
// threads; the bytes are a third of the operation bound, so filling the SMs
// comes first.
#include <cuda_runtime.h>

#include "seg_scan.cuh"

using namespace bn254;

#define SCAN_THREADS SCAN_BLOCK
#define SCAN_MIN_BLOCKS 3  // at most 65,536 / (128 x 3) = 170 registers
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ G1P g1_shfl_up(const G1P& a, unsigned d,
                                          int width) {
  G1P r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.x.v[i] = __shfl_up_sync(FULL_MASK, a.x.v[i], d, width);
    r.y.v[i] = __shfl_up_sync(FULL_MASK, a.y.v[i], d, width);
    r.z.v[i] = __shfl_up_sync(FULL_MASK, a.z.v[i], d, width);
  }
  return r;
}

__device__ __forceinline__ G1P g1_shfl(const G1P& a, int src) {
  G1P r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.x.v[i] = __shfl_sync(FULL_MASK, a.x.v[i], src);
    r.y.v[i] = __shfl_sync(FULL_MASK, a.y.v[i], src);
    r.z.v[i] = __shfl_sync(FULL_MASK, a.z.v[i], src);
  }
  return r;
}

// inclusive segmented scan of (f, v) over groups of `width` consecutive
// threads of a warp (width a power of two, at most 32); j is the thread's
// index in its group
__device__ __forceinline__ void warp_seg_scan(bool& f, G1P& v, int j,
                                              int width) {
#pragma unroll 1
  for (int d = 1; d < width; d <<= 1) {
    G1P o = g1_shfl_up(v, d, width);
    bool of = __shfl_up_sync(FULL_MASK, (int)f, d, width) != 0;
    if (j >= d) seg_op(of, o, f, v);
  }
}

// T: threads a lane (a power of two, at most SCAN_THREADS); r: steps a run
__global__ void __launch_bounds__(SCAN_THREADS, SCAN_MIN_BLOCKS)
seg_scan_kernel(const uint32_t* __restrict__ xs,
                const uint8_t* __restrict__ flags, long long m, long long s,
                int T, long long r, uint32_t* __restrict__ ys) {
  __shared__ G1P wsum[SCAN_THREADS / 32];
  __shared__ bool wflag[SCAN_THREADS / 32];
  __shared__ G1P csum[SCAN_THREADS];             // carry-ins
  __shared__ long long cfirst[SCAN_THREADS];     // first step of each run
  __shared__ long long coff[SCAN_THREADS];       // offsets of the fix-ups
  __shared__ long long ctot[SCAN_THREADS / 32];
  const int tid = threadIdx.x, warp = tid >> 5, lw = tid & 31;
  const int k = tid & (T - 1);                   // thread in its lane
  const long long lane = (long long)blockIdx.x * (SCAN_THREADS / T) + tid / T;
  // every thread takes part in the shuffles and barriers; a thread past the
  // last lane or past the lane's steps carries the identity, flag 0
  long long lo = lane < m ? k * r : s;
  if (lo > s) lo = s;
  const long long hi = lo + r < s ? lo + r : s;
  const uint32_t* x = xs + lane * s * 24;
  uint32_t* y = ys + lane * s * 24;
  const uint8_t* f = flags == nullptr ? nullptr : flags + lane * s;

  // phase 1
  G1P tot = g1_identity();
  long long first = hi;
  if (lo < hi) tot = run_scan(x, f, lo, hi, y, &first);
  bool fl = first < hi;

  // phase 2: the inclusive scan within the warp, then its exclusive form
  const int width = T < 32 ? T : 32;
  const int j = tid & (width - 1);
  warp_seg_scan(fl, tot, j, width);
  G1P carry = g1_shfl_up(tot, 1, width);
  bool cf = __shfl_up_sync(FULL_MASK, (int)fl, 1, width) != 0;
  if (j == 0) {
    carry = g1_identity();
    cf = false;
  }
  if (T > 32) {
    // the warp totals of each lane, scanned by every warp of the lane
    if (lw == 31) {
      wsum[warp] = tot;
      wflag[warp] = fl;
    }
    // parked in shared memory, so that no third point stays live in
    // registers over the scan below
    csum[tid] = carry;
    __syncthreads();
    const int nw = T >> 5, wk = k >> 5;          // warps a lane, this one's
    const int src = warp - wk + (lw & (nw - 1));
    G1P wt = wsum[src];
    bool wf = wflag[src];
    warp_seg_scan(wf, wt, lw & (nw - 1), nw);
    if (wk > 0) {                                // uniform over the warp
      G1P wc = g1_shfl(wt, wk - 1);
      bool wcf = __shfl_sync(FULL_MASK, (int)wf, wk - 1) != 0;
      carry = csum[tid];
      seg_op(wcf, wc, cf, carry);
    }
  }

  // phase 3: each run's steps before its first flag need its carry-in (a
  // lane's first run has none).  Their counts differ from run to run, so
  // the block deals them out evenly: an exclusive prefix sum of the counts
  // numbers the fix-ups, and thread tid takes fix-ups tid, tid + blockDim...
  const long long cnt = k > 0 && lo < hi ? first - lo : 0;
  long long inc = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    long long v = __shfl_up_sync(FULL_MASK, inc, d);
    if (lw >= d) inc += v;
  }
  if (lw == 31) ctot[warp] = inc;
  csum[tid] = carry;
  cfirst[tid] = lo;
  __syncthreads();
  long long base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < SCAN_THREADS / 32; ++w) {
    if (w < warp) base += ctot[w];
    total += ctot[w];
  }
  coff[tid] = base + inc - cnt;
  __syncthreads();
  const long long lane0 = (long long)blockIdx.x * (SCAN_THREADS / T);
#pragma unroll 1
  for (long long i = tid; i < total; i += SCAN_THREADS)
    block_fixup(i, coff, cfirst, csum, SCAN_THREADS, T, lane0, s, ys);
}

static int g_wave = 0;  // threads in one full wave of the card

static cudaError_t wave_threads(int* wave) {
  if (g_wave == 0) {
    int dev = 0, sms = 0, blocks = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, seg_scan_kernel, SCAN_THREADS, 0);
    if (e != cudaSuccess) return e;
    g_wave = sms * blocks * SCAN_THREADS;
  }
  *wave = g_wave;
  return cudaSuccess;
}

static int threads_per_lane(long long m, long long s, int wave) {
  long long cap = 1;
  while (cap < s && cap < SCAN_THREADS) cap <<= 1;
  long long t = 1;
  while (t < cap && m * t < wave) t <<= 1;
  return (int)t;
}

// The T the kernel takes for m lanes of s steps (m, s >= 1) in *T.
extern "C" int quill_seg_scan_threads(long long m, long long s, int* T) {
  int wave = 0;
  cudaError_t e = wave_threads(&wave);
  if (e == cudaSuccess) *T = threads_per_lane(m, s, wave);
  return (int)e;
}

// xs, ys: (m, s, 24); flags: (m, s) bytes or NULL.  ys may not alias xs.
extern "C" int quill_seg_scan(const void* xs, const void* flags, long long m,
                              long long s, void* ys, void* stream) {
  if (m <= 0 || s <= 0) return 0;
  int T = 0;
  int e = quill_seg_scan_threads(m, s, &T);
  if (e != 0) return e;
  const long long lanes = SCAN_THREADS / T;
  const unsigned blocks = (unsigned)((m + lanes - 1) / lanes);
  seg_scan_kernel<<<blocks, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)xs, (const uint8_t*)flags, m, s, T, (s + T - 1) / T,
      (uint32_t*)ys);
  return (int)cudaGetLastError();
}
