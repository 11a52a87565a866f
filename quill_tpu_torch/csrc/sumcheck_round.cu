// Kernel A: one fused sumcheck round over Fr.
//
// Replaces the TPU kernels quill_tpu/engine/sumcheck8.py:_round8_kernel (the
// fused fold + round-message kernel) and :_entry_kernel (the even/odd split
// that built its stacked state).  On the TPU the tables were restacked into
// even/odd streams so a grid step could read aligned (8, 128) tiles; here a
// thread reads its pairs straight from the natural-order tables, so there is
// no entry pass and no stacked state.
//
// LSB binding, as in the reference: a table T of length n folds at r to
// f[p] = T[2p] + r (T[2p+1] - T[2p]), and the round message at t = 0..deg is
// sum_m h(lo_m + t (hi_m - lo_m)) over the pairs (lo_m, hi_m) = (f[2m],
// f[2m+1]).  h is a postfix program (engine/expr.py) run by every thread,
// so one build serves every expression; sumcheck.cuh has the per-thread
// pieces.
//
// Bound on this card: integer multiply throughput.  A pair costs 2 fold
// products a table and deg + 1 runs of the program (~150-264 IMADs a
// product) against 192 bytes a table (4 rows read, 2 written).
//
// Design:
// - the round's arguments (tables, r, program, constants) are one ScParams
//   passed by value, read from the constant bank (__grid_constant__): the
//   wrapper copies nothing to the card;
// - a thread's values, differences and stack live in shared memory slots,
//   each slot two 16-byte halves in planes of SC_BLOCK (half h of slot s
//   of thread x at uint4 [(2 s + h) SC_BLOCK + x], so a warp's accesses
//   are conflict-free); the stack's top and the NT accumulators are in
//   registers (NT is a template argument, 1 to 8), so no array is indexed
//   at run time in local memory;
// - each block strides over the pairs a warp at a time, with as many
//   blocks as fill the card (occupancy for the round's shared memory);
// - the fold's rows go out through a 2 KB staging area a warp, each warp
//   store 512 contiguous bytes;
// - the NT sums are reduced by warp shuffles, then over the block's four
//   warps, into one partial a block; a second launch sums the partials.
#include <cuda_runtime.h>

#include "sumcheck.cuh"

using namespace bn254;

#define SC_BLOCK 128
#define SC_MIN_BLOCKS 4                   // up to 128 registers a thread
#define SC_MAX_GRID 2048                  // partials the wrapper provides
#define SC_STAGE_BYTES (SC_BLOCK * 64)    // a warp's 32 pairs of rows
#define FULL_MASK 0xffffffffu

struct SmemSlots {
  uint4* sm;  // the block's slots; this thread's column is x
  int x;
  __device__ __forceinline__ Fe get(int s) const {
    const uint4 lo = sm[2 * s * SC_BLOCK + x];
    const uint4 hi = sm[(2 * s + 1) * SC_BLOCK + x];
    Fe r;
    r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
    r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
    return r;
  }
  __device__ __forceinline__ void set(int s, const Fe& a) const {
    sm[2 * s * SC_BLOCK + x] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
    sm[(2 * s + 1) * SC_BLOCK + x] =
        make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
  }
};

__device__ __forceinline__ Fe fe_shfl_xor(const Fe& a, int d) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = __shfl_xor_sync(FULL_MASK, a.v[i], d);
  return r;
}

template <int NT>
__global__ void __launch_bounds__(SC_BLOCK, SC_MIN_BLOCKS)
sc_round_kernel(const __grid_constant__ ScParams p,
                uint32_t* __restrict__ partials) {
  extern __shared__ uint4 smem[];
  __shared__ Fe wsum[SC_BLOCK / 32][NT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4* stage = smem + warp * (SC_STAGE_BYTES / 16 / (SC_BLOCK / 32));
  SmemSlots sl{smem + SC_STAGE_BYTES / 16, (int)threadIdx.x};
  Fe acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t] = fe_zero<FrM>();
  const Fe r = fe_load(p.r);
  const long long stride = (long long)gridDim.x * SC_BLOCK;
  for (long long m0 = (long long)blockIdx.x * SC_BLOCK + 32 * warp;
       m0 < p.n_pairs; m0 += stride) {
    const long long m = m0 + lane;
    const bool live = m < p.n_pairs;
    if (live) sc_load_pair(p, m, r, sl);
    if (p.fold) {
      for (int i = 0; i < p.k; ++i) {
        if (live) {
          const Fe lo = sl.get(i), hi = fe_add<FrM>(lo, sl.get(p.k + i));
          stage[4 * lane] = make_uint4(lo.v[0], lo.v[1], lo.v[2], lo.v[3]);
          stage[4 * lane + 1] = make_uint4(lo.v[4], lo.v[5], lo.v[6], lo.v[7]);
          stage[4 * lane + 2] = make_uint4(hi.v[0], hi.v[1], hi.v[2], hi.v[3]);
          stage[4 * lane + 3] = make_uint4(hi.v[4], hi.v[5], hi.v[6], hi.v[7]);
        }
        __syncwarp();
        uint4* out = reinterpret_cast<uint4*>(p.out[i]) + 4 * m0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = lane + 32 * j;
          if (m0 + (u >> 2) < p.n_pairs) out[u] = stage[u];
        }
        __syncwarp();
      }
    }
    if (live) sc_accumulate<NT>(p, sl, acc);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    Fe v = acc[t];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = fe_add<FrM>(v, fe_shfl_xor(v, d));
    if (lane == 0) wsum[warp][t] = v;
  }
  __syncthreads();
  if (threadIdx.x < NT) {
    Fe s = wsum[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < SC_BLOCK / 32; ++w)
      s = fe_add<FrM>(s, wsum[w][threadIdx.x]);
    fe_store16(partials + 8 * ((long long)blockIdx.x * NT + threadIdx.x), s);
  }
}

// second pass: out[t] = sum over blocks of partials[block][t]
__global__ void __launch_bounds__(SC_BLOCK)
sc_partials_kernel(const uint32_t* __restrict__ partials, int nblocks, int nt,
                   uint32_t* __restrict__ out) {
  __shared__ Fe sh[SC_BLOCK];
  const int t = blockIdx.x;
  Fe acc = fe_zero<FrM>();
  for (int b = threadIdx.x; b < nblocks; b += SC_BLOCK)
    acc = fe_add<FrM>(acc, fe_load16(partials + 8 * ((long long)b * nt + t)));
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = SC_BLOCK / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s)
      sh[threadIdx.x] = fe_add<FrM>(sh[threadIdx.x], sh[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) fe_store16(out + 8 * t, sh[0]);
}

template <int NT>
static int sc_launch(const ScParams& p, int slots, uint32_t* partials,
                     uint32_t* out, cudaStream_t s) {
  static int sms = 0;
  static bool configured = false;
  const size_t smem = SC_STAGE_BYTES + (size_t)slots * 32 * SC_BLOCK;
  if (!configured) {
    const int most = SC_STAGE_BYTES +
                     sc_slots(SC_MAX_TABLES, SC_MAX_STACK) * 32 * SC_BLOCK;
    cudaError_t e = cudaFuncSetAttribute(
        sc_round_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most);
    if (e == cudaSuccess) {
      int dev = 0;
      e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sc_round_kernel<NT>, SC_BLOCK, smem);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (p.n_pairs + SC_BLOCK - 1) / SC_BLOCK;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  if (blocks > SC_MAX_GRID) blocks = SC_MAX_GRID;
  if (blocks < 1) blocks = 1;
  sc_round_kernel<NT><<<(unsigned)blocks, SC_BLOCK, smem, s>>>(p, partials);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sc_partials_kernel<<<NT, SC_BLOCK, 0, s>>>(partials, (int)blocks, NT, out);
  return (int)cudaGetLastError();
}

extern "C" int quill_sumcheck_limits(int* out) {
  out[0] = SC_MAX_TABLES;
  out[1] = SC_MAX_T;
  out[2] = SC_MAX_STACK;
  out[3] = SC_MAX_OPS;
  out[4] = SC_MAX_CONSTS;
  out[5] = SC_MAX_GRID;
  out[6] = (int)sizeof(ScParams);
  return 0;
}

// params: one ScParams in host memory (copied into the launch); nt = deg
// + 1 points; slots = sc_slots(k, depth); partials: (SC_MAX_GRID, nt, 8)
// scratch; out: (nt, 8), the messages in Montgomery form.
extern "C" int quill_sumcheck_round(const void* params, int nt, int slots,
                                    void* partials, void* out, void* stream) {
  const ScParams& p = *(const ScParams*)params;
  if (p.k < 1 || p.k > SC_MAX_TABLES || p.prog_len < 1 ||
      p.prog_len > SC_MAX_OPS || slots > sc_slots(SC_MAX_TABLES, SC_MAX_STACK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* pt = (uint32_t*)partials;
  uint32_t* o = (uint32_t*)out;
  switch (nt) {
    case 1: return sc_launch<1>(p, slots, pt, o, s);
    case 2: return sc_launch<2>(p, slots, pt, o, s);
    case 3: return sc_launch<3>(p, slots, pt, o, s);
    case 4: return sc_launch<4>(p, slots, pt, o, s);
    case 5: return sc_launch<5>(p, slots, pt, o, s);
    case 6: return sc_launch<6>(p, slots, pt, o, s);
    case 7: return sc_launch<7>(p, slots, pt, o, s);
    case 8: return sc_launch<8>(p, slots, pt, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
