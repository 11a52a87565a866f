// Kernel I: the segmented point scan of the v8 MSM route,
// quill_tpu_torch/ec/msm8.py, kernel E's v8 collect mode and the v8 entries
// kernels that make each chunk's scan input (both below).
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

#include "entries.cuh"
#include "seg_scan.cuh"

using namespace bn254;

#define SCAN_THREADS SCAN_BLOCK
#define SCAN_MIN_BLOCKS 3  // at most 65,536 / (128 x 3) = 170 registers
#define FULL_MASK 0xffffffffu
// The collect's block and __launch_bounds__ minimum: 256 x 2 holds it at 128
// registers with no spills (142 unbounded), the fastest of the block sizes
// timed on the H100 (PERF.md).
#define COLLECT_THREADS 256
#define COLLECT_MIN_BLOCKS 2

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

// Kernel E's v8 collect mode (`ec/msm8.py: collect`), which replaces its
// flagged and plain elementwise modes at the v8 collect (`msm8.py:193-220
// _k_collect8` in the TPU build: one dense pass over every bucket of every
// window).  One thread a (window w, digit d), d in 1 .. nbuck - 1: a binary
// search in the window's sorted digits (2^16 int32, resident in L2) finds
// the digit's last position; an absent digit writes nothing.  Otherwise
// v = wf ? ys : offs[block] + ys, and acc[w, d] = acc[w, d] + v in place, the
// two adds in the order the earlier path's two launches took them, so the
// triples are the same.  No compaction (the earlier path's torch.nonzero
// synchronised with the host every chunk) and no point tensor between the
// operands and acc.  Bound on this card: integer multiply throughput, 12
// products a bucket that occurs and 12 more where its digit's run starts
// inside its block (one v8 chunk of uniform scalars: ~155,600 and ~4,300),
// against ~5 MB of digits and ~200 bytes a bucket.
__global__ void __launch_bounds__(COLLECT_THREADS, COLLECT_MIN_BLOCKS)
v8_collect_kernel(const int32_t* __restrict__ sorted_d, int nwin,
                  long long npad, int nbuck, int bs,
                  const uint32_t* __restrict__ ys,
                  const uint8_t* __restrict__ wf,
                  const uint32_t* __restrict__ offs,
                  uint32_t* __restrict__ acc) {
  const long long i = (long long)blockIdx.x * COLLECT_THREADS + threadIdx.x;
  if (i >= (long long)nwin * (nbuck - 1)) return;
  const int w = (int)(i / (nbuck - 1));
  const int d = (int)(i % (nbuck - 1)) + 1;
  const int32_t* row = sorted_d + w * npad;
  long long a = 0, b = npad;  // -> the first position whose digit exceeds d
  while (a < b) {
    const long long mid = (a + b) >> 1;
    if (row[mid] <= d) a = mid + 1;
    else b = mid;
  }
  if (a == 0 || row[a - 1] != d) return;
  const long long idx = w * npad + a - 1;
  G1P v = g1_load(ys + 24 * idx);
  if (!wf[idx]) v = g1_add(g1_load(offs + 24 * (idx / bs)), v);
  uint32_t* dst = acc + 24 * ((long long)w * nbuck + d);
  g1_store(dst, g1_add(g1_load(dst), v));
}

// ---------------------------------------------------------------------------
// v8's entries: one chunk's Montgomery scalars to its sorted, gathered scan
// input (`ec/msm8.py: chunk_entries`)
// ---------------------------------------------------------------------------
//
// Replaces quill_tpu/ec/msm8.py:117 _k_sort_gather8 (an XLA function over
// msm12._extract_digits: digits, sort_key_val, gathers into the scan
// layout), which the port first ran as plain torch: fd.from_mont over the
// MSM's scalars, then per chunk window_digits' int64 loop, a stable
// torch.sort, an int64 gather of 1.31 M points, a cat and a where, with
// three copies from host memory (each a wait for the card) a chunk.
//
// Bound on this card: bytes.  A chunk of 2^16 scalars writes 1,310,720
// scan entries (96 bytes each, 126 MB), the sorted digits and flags (6.6
// MB) and reads the scalars and points (6 MB): ~0.041 ms at 3.35 TB/s.  The
// sort's own traffic (2.6 MB of digits, 21 MB of segment histograms, 5.2
// MB of packed entries) mostly stays in the 50 MB L2; the 2^16
// conversions out of Montgomery form are 2^16 Fr products (~0.002 ms of
// IMADs).  What the launches take on an H100 is in PERF.md's kernel table.
//
// Design: four launches on the current stream, no host synchronisation, no
// allocation (the wrapper hands every buffer in).  The keys are 13-bit and
// every window has 8192 of them, so a stable counting sort needs no general
// sort:
//  1 v8e_digits_kernel: one block a (segment of `seg` scalars, group of
//    V8E_WGROUP windows); each thread converts its scalars (v8e_canonical)
//    and writes their digits of the group's windows (uint16, window-major);
//    then, window by window, the block counts the segment's digits in
//    shared memory (8192 counters) and writes them out.
//  2 v8e_prefix_kernel: one thread a (window, digit): the digit's counts
//    over the segments become their exclusive prefixes, in place
//    (v8e_column), and its total (digit 0's with the padding) is written.
//  3 v8e_place_kernel: one warp a (window, segment), alone in its block.
//    It copies the segment's digits to shared memory, scans the window's
//    totals (32 digits at a time, by shuffles) into each digit's first
//    sorted position and adds the segment's prefixes: 8192 counters in
//    shared memory, this segment's own.  Then over its scalars in order,
//    32 at a time, __match_any_sync groups the lanes of one digit, the
//    group's first lane reads and advances the digit's counter, and a
//    lane's position is the counter plus the lanes of its group below it.
//    There it stores one word, its digit above its scalar's index
//    (v8e_pack): the scattered stores are most of this kernel's time, and a
//    second array of digits took 0.022 ms more a chunk.  Equal digits keep
//    the order of their scalars, the order of torch.sort(stable=True), so
//    kernel I and the collect see the entries they saw before and the
//    proof's bytes do not change.  Digit 0 is not placed: its entries are
//    all the identity and fill each row's first positions.  (A first
//    version kept the counters in device memory, read and advanced there,
//    with one block scanning each window's totals: place 0.105 and prefix
//    0.043 ms a chunk.)
//  4 v8e_emit_kernel: three threads a sorted position, one a coordinate,
//    gather the point through the entry's index (the chunk's 4 MB of
//    points stay in L2) straight into kernel I's lane-major layout; the
//    first also writes the digit and the flag.
#define V8E_DIGIT_THREADS 1024
#define V8E_WGROUP 5  // windows a block of the digits kernel
#define V8E_PREFIX_THREADS 256
#define V8E_PLACE_SEG 4096  // the most scalars a segment (shared memory)
#define V8E_EMIT_THREADS 256
static_assert(V8E_NWIN % V8E_WGROUP == 0 && V8E_NBUCK % 32 == 0,
              "window groups and the place kernel's rows of 32 digits");

// dig: (NWIN, n) uint16 digits; hist: (NWIN, gridDim.x, NBUCK) counts
__global__ void __launch_bounds__(V8E_DIGIT_THREADS)
v8e_digits_kernel(const uint32_t* __restrict__ scs, long long n,
                  long long seg, uint16_t* __restrict__ dig,
                  int* __restrict__ hist) {
  __shared__ int h[V8E_NBUCK];
  const long long lo = (long long)blockIdx.x * seg;
  const long long hi = lo + seg < n ? lo + seg : n;
  const int w0 = blockIdx.y * V8E_WGROUP;
  for (int d = threadIdx.x; d < V8E_NBUCK; d += V8E_DIGIT_THREADS) h[d] = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += V8E_DIGIT_THREADS) {
    const Fe c = v8e_canonical(scs + 8 * i);
#pragma unroll
    for (int w = 0; w < V8E_NWIN; ++w)  // w constant: c.v in registers
      if (w >= w0 && w < w0 + V8E_WGROUP)
        dig[w * n + i] = (uint16_t)v8e_digit(c, w);
  }
  __syncthreads();
#pragma unroll 1
  for (int w = w0; w < w0 + V8E_WGROUP; ++w) {
    // each thread counts the digits it wrote itself
    for (long long i = lo + threadIdx.x; i < hi; i += V8E_DIGIT_THREADS)
      atomicAdd(&h[dig[w * n + i]], 1);
    __syncthreads();
    int* out = hist + ((long long)w * gridDim.x + blockIdx.x) * V8E_NBUCK;
    for (int d = threadIdx.x; d < V8E_NBUCK; d += V8E_DIGIT_THREADS) {
      out[d] = h[d];
      h[d] = 0;
    }
    __syncthreads();
  }
}

// hist: (NWIN, S, NBUCK) counts -> their exclusive prefixes over the
// segments; tot: (NWIN, NBUCK) each digit's count in the window
__global__ void __launch_bounds__(V8E_PREFIX_THREADS)
v8e_prefix_kernel(int* __restrict__ hist, long long S, int pad,
                  int* __restrict__ tot) {
  const long long t = (long long)blockIdx.x * V8E_PREFIX_THREADS + threadIdx.x;
  if (t >= (long long)V8E_NWIN * V8E_NBUCK) return;
  const long long w = t / V8E_NBUCK;
  const int d = (int)(t - w * V8E_NBUCK);
  tot[t] = v8e_column(hist + w * S * V8E_NBUCK + d, S, V8E_NBUCK) +
           (d == 0 ? pad : 0);
}

// One warp a (window, segment): the segment's nonzero digits placed in
// ent (NWIN, npad), from the row's first nonzero digit on, packed with
// their scalars' indices.  seg is at most V8E_PLACE_SEG.
__global__ void __launch_bounds__(32)
v8e_place_kernel(const uint16_t* __restrict__ dig, long long n,
                 long long seg, long long S, const int* __restrict__ pre,
                 const int* __restrict__ tot, long long npad,
                 int32_t* __restrict__ ent) {
  __shared__ int cnt[V8E_NBUCK];
  __shared__ uint16_t sdig[V8E_PLACE_SEG];
  const int lane = threadIdx.x;
  const long long gw = blockIdx.x;  // w * S + s
  const int w = (int)(gw / S);
  const long long lo = (gw - (long long)w * S) * seg;
  const long long hi = lo + seg < n ? lo + seg : n;
  const uint16_t* dw = dig + w * n;
  for (long long i = lo + lane; i < hi; i += 32) sdig[i - lo] = dw[i];
  // each digit's first position in the window (the exclusive scan of the
  // window's totals, 32 digits at a time), plus the counts of the
  // segments before this one
  const int* tw = tot + (long long)w * V8E_NBUCK;
  const int* pw = pre + gw * V8E_NBUCK;
  int carry = 0;
#pragma unroll 8
  for (int c = 0; c < V8E_NBUCK; c += 32) {
    const int t = tw[c + lane];
    int inc = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, inc, o);
      if (lane >= o) inc += v;
    }
    cnt[c + lane] = carry + inc - t + pw[c + lane];
    carry += __shfl_sync(FULL_MASK, inc, 31);
  }
  __syncwarp();
  int32_t* er = ent + w * npad;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll 1
  for (long long b = lo; b < hi; b += 32) {
    const long long i = b + lane;
    const int d = i < hi ? sdig[i - lo] : 0;
    // lanes of digit 0 or past the segment: a key of their own
    const unsigned peers =
        __match_any_sync(FULL_MASK, d > 0 ? (unsigned)d : 0x10000u + lane);
    const int leader = __ffs(peers) - 1;
    int o = 0;
    if (d > 0 && lane == leader) {
      o = cnt[d];
      cnt[d] = o + __popc(peers);
    }
    o = __shfl_sync(FULL_MASK, o, leader);
    if (d > 0) {
      er[o + __popc(peers & below)] = v8e_pack(d, i);
    }
    __syncwarp();  // the counters' stores before the next round's loads
  }
}

// Three threads a sorted position (a coordinate each): pts (NWIN * npad,
// 24); the first also the digit sd and the flag (NWIN * npad), digit 0 in
// each row's first tot[w][0] positions (digit 0's and the padding)
__global__ void __launch_bounds__(V8E_EMIT_THREADS)
v8e_emit_kernel(const int32_t* __restrict__ ent,
                const uint32_t* __restrict__ xy,
                const uint8_t* __restrict__ inf,
                const int* __restrict__ tot, long long npad,
                int32_t* __restrict__ sd, uint32_t* __restrict__ pts,
                uint8_t* __restrict__ flags) {
  const long long t = (long long)blockIdx.x * V8E_EMIT_THREADS + threadIdx.x;
  if (t >= 3LL * V8E_NWIN * npad) return;
  const long long q = t / 3;
  const int k = (int)(t - 3 * q);
  const int w = (int)(q / npad);
  const long long p = q - w * npad;
  const int z = tot[(long long)w * V8E_NBUCK];
  v8e_emit(q, k, p, z, ent, xy, inf, pts);
  if (k == 0) {
    flags[q] = v8e_flag(q, p, z, ent);
    sd[q] = p < z ? 0 : v8e_entry_digit(ent[q]);
  }
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

// sorted_d: (nwin, npad) int32, each row sorted; ys: (nwin * npad, 24) and
// wf: (nwin * npad) bytes, the chunk's within-block scans and flag prefixes;
// offs: (nwin * npad / bs, 24) block offsets; acc: (nwin * nbuck, 24), added
// into in place.
extern "C" int quill_v8_collect(const void* sorted_d, int nwin,
                                long long npad, int nbuck, int bs,
                                const void* ys, const void* wf,
                                const void* offs, void* acc, void* stream) {
  const long long n = (long long)nwin * (nbuck - 1);
  if (n <= 0 || npad <= 0) return 0;
  if (bs <= 0 || npad % bs != 0) return (int)cudaErrorInvalidValue;
  v8_collect_kernel<<<(unsigned)((n + COLLECT_THREADS - 1) / COLLECT_THREADS),
                      COLLECT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)sorted_d, nwin, npad, nbuck, bs, (const uint32_t*)ys,
      (const uint8_t*)wf, (const uint32_t*)offs, (uint32_t*)acc);
  return (int)cudaGetLastError();
}

// One chunk of n Montgomery Fr scalars (n, 8) against its (n, 2, 8) affine
// points and (n,) infinity bytes -> sorted_d (NWIN, npad) int32, pts (NWIN *
// npad, 24) and flags (NWIN * npad) bytes, npad >= n the row length with
// its padding (digit 0), n at most V8E_MAX_N.  Scratch: dig (NWIN, n)
// uint16, hist (NWIN, S, NBUCK), tot (NWIN, NBUCK) and ent (NWIN, npad)
// int32, with S = ceil(n / seg) segments of seg scalars.  Four launches.
extern "C" int quill_v8_entries(const void* scs, const void* xy,
                                const void* inf, long long n, long long npad,
                                long long seg, void* dig, void* hist,
                                void* tot, void* ent, void* sorted_d,
                                void* pts, void* flags, void* stream) {
  if (n <= 0 || n > V8E_MAX_N || seg <= 0 || seg > V8E_PLACE_SEG ||
      npad < n || npad - n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long S = (n + seg - 1) / seg;
  v8e_digits_kernel<<<dim3((unsigned)S, V8E_NWIN / V8E_WGROUP),
                      V8E_DIGIT_THREADS, 0, st>>>(
      (const uint32_t*)scs, n, seg, (uint16_t*)dig, (int*)hist);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  v8e_prefix_kernel<<<V8E_NWIN * V8E_NBUCK / V8E_PREFIX_THREADS,
                      V8E_PREFIX_THREADS, 0, st>>>(
      (int*)hist, S, (int)(npad - n), (int*)tot);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  v8e_place_kernel<<<(unsigned)(V8E_NWIN * S), 32, 0, st>>>(
      (const uint16_t*)dig, n, seg, S, (const int*)hist, (const int*)tot,
      npad, (int32_t*)ent);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long threads = 3LL * V8E_NWIN * npad;
  v8e_emit_kernel<<<(unsigned)((threads + V8E_EMIT_THREADS - 1) /
                               V8E_EMIT_THREADS),
                    V8E_EMIT_THREADS, 0, st>>>(
      (const int32_t*)ent, (const uint32_t*)xy, (const uint8_t*)inf,
      (const int*)tot, npad, (int32_t*)sorted_d, (uint32_t*)pts,
      (uint8_t*)flags);
  return (int)cudaGetLastError();
}
