// Kernel B: the NTT product over Fr (poly/ntt.py: poly_mul), in tile passes
// through shared memory.
//
// Replaces the TPU kernel quill_tpu/poly/ntt8.py:_ntt_body (a 2^16-point
// four-step NTT whose DFT-256 passes were 33 bf16 matmuls into int32
// columns plus one REDC, shaped for the TPU's matrix unit) and the XLA
// steps around it in quill_tpu/poly/ntt.py: ntt_chunks and poly_mul_ntt
// (the chunk-level butterflies, the step-2 twiddles, the pointwise product
// and the 1/N scale).  256-bit products run on this card's integer units,
// so the port runs radix-2 butterflies; as in the JAX package, the forward
// transform leaves a fixed internal order (bit-reversed, ntt.cuh) that the
// inverse consumes, and no pass permutes.
//
// Launches (ntt.cuh has the tile geometry and the butterflies):
// - ntt_pass_kernel, one block a tile of up to 2^NTT_TILE_LOG elements held
//   in shared memory: loads the tile with 16-byte loads (rows of 256 bytes
//   or more), runs its forward stages (bits high to low), multiplies each
//   element by y[i] and by a constant if asked, runs its inverse stages
//   (bits low to high) and stores the tile.  A forward transform of 2^23
//   points is three passes (bits 17-22, 11-16, 0-10), of 2^19 two.  The
//   product  a * b  is: a's forward passes; b's forward passes but the last;
//   one pass with b's last forward stages, the product by a's transform
//   and by 1/n, and the inverse's first stages; the inverse's other passes.
//   The first pass of a chain reads its unpadded input (rows at or past
//   `valid` load as zero); the others run in place.
// - ntt_twiddles_kernel, once per table size: the twiddle table, one entry
//   a thread (ntt.cuh: ntt_twiddle), from the 2^m-th roots of unity passed
//   by value.
// - ntt_s_fold_kernel: the IPA S polynomial's fold of the product h,
//   S[k] = h[m + k] + h[m - 2 - k] (engine/device.py: s_polynomial).  Its
//   two rows lie in different tiles of the inverse's last pass, so it is a
//   launch of its own, bound by bytes.
//
// Bound on this card: integer multiply throughput.  A stage is one CIOS
// product (264 32-bit multiply-adds) a butterfly against 128 bytes through
// shared memory, and a pass moves each element through device memory once
// each way for 6 to 11 stages, so passes are bound by the products.
// Twiddles come from the table (no product spent on them); a butterfly
// reads its entry from L2 or device memory, neighbouring columns
// neighbouring entries.  The tile keeps each element's two 16-byte halves
// in two planes of shared memory 4 entries apart, so a warp's 16-byte
// accesses to consecutive elements fall in distinct banks.
#include <cuda_runtime.h>

#include "ntt.cuh"

using namespace bn254;

#define NTT_PLANE ((1 << NTT_TILE_LOG) + 4)  // uint4s from half 0 to half 1
#define NTT_SMEM (2 * NTT_PLANE * 16)        // 65,664 bytes a block
#define NTT_MAX_ROOT 28                      // Fr's two-adicity
#define NTT_FOLD_BLOCK 256

struct SmemTile {
  uint4* sm;
  __device__ __forceinline__ Fe get(int e) const {
    const uint4 lo = sm[e], hi = sm[NTT_PLANE + e];
    Fe r;
    r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
    r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
    return r;
  }
  __device__ __forceinline__ void set(int e, const Fe& a) const {
    sm[e] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
    sm[NTT_PLANE + e] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
  }
};

struct NttArgs {
  const uint32_t* src;  // rows below `valid` are read, the rest are zero
  uint32_t* dst;        // may be src
  long long valid;
  const uint32_t* y;    // NULL, or the product's other transform
  const uint32_t* tw;
  NttPass p;
  int dif, dit, scaled;
  Fe scale;
};

struct NttRoots {
  Fe w[NTT_MAX_ROOT + 1];
  __device__ __forceinline__ const Fe& operator[](int m) const { return w[m]; }
};

__global__ void __launch_bounds__(NTT_THREADS)
ntt_pass_kernel(const __grid_constant__ NttArgs a) {
  extern __shared__ uint4 sm[];
  SmemTile t{sm};
  const long long g = blockIdx.x;
  const int tile = ntt_tile_size(a.p);
  const int nb = tile >> 1;
  const uint4* src = reinterpret_cast<const uint4*>(a.src);
  // consecutive threads, consecutive 16-byte words of a row
  for (int q = threadIdx.x; q < 2 * tile; q += NTT_THREADS) {
    const int e = q >> 1, h = q & 1;
    const long long i = ntt_global(a.p, g, e);
    sm[h * NTT_PLANE + e] =
        i < a.valid ? src[2 * i + h] : make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  if (a.dif) {
    for (int q = a.p.s - 1; q >= 0; --q) {
      for (int k = threadIdx.x; k < nb; k += NTT_THREADS)
        ntt_bfly_dif(t, a.p, a.tw, g, q, k);
      __syncthreads();
    }
  }
  if (a.y != nullptr || a.scaled) {
    for (int e = threadIdx.x; e < tile; e += NTT_THREADS) {
      Fe v = t.get(e);
      if (a.y != nullptr)
        v = fe_mul<FrM>(v, fe_load16(a.y + 8 * ntt_global(a.p, g, e)));
      if (a.scaled) v = fe_mul<FrM>(v, a.scale);
      t.set(e, v);
    }
    __syncthreads();
  }
  if (a.dit) {
    for (int q = 0; q < a.p.s; ++q) {
      for (int k = threadIdx.x; k < nb; k += NTT_THREADS)
        ntt_bfly_dit(t, a.p, a.tw, g, q, k);
      __syncthreads();
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(a.dst);
  for (int q = threadIdx.x; q < 2 * tile; q += NTT_THREADS) {
    const int e = q >> 1, h = q & 1;
    dst[2 * ntt_global(a.p, g, e) + h] = sm[h * NTT_PLANE + e];
  }
}

__global__ void __launch_bounds__(NTT_THREADS)
ntt_twiddles_kernel(uint32_t* __restrict__ tw, long long total,
                    const __grid_constant__ NttRoots roots) {
  const long long idx = (long long)blockIdx.x * NTT_THREADS + threadIdx.x;
  if (idx >= total) return;
  const int b = ntt_tw_row_of(idx);
  fe_store16(tw + 8 * idx, ntt_twiddle(roots, b, idx - ntt_tw_row(b)));
}

__global__ void __launch_bounds__(NTT_FOLD_BLOCK)
ntt_s_fold_kernel(const uint32_t* __restrict__ h, uint32_t* __restrict__ out,
                  long long m) {
  const long long k = (long long)blockIdx.x * NTT_FOLD_BLOCK + threadIdx.x;
  if (k >= m - 1) return;
  fe_store16(out + 8 * k, fe_add<FrM>(fe_load16(h + 8 * (m + k)),
                                      fe_load16(h + 8 * (m - 2 - k))));
}

// One pass over the n = 2^logn rows of dst (see NttArgs); scale: 8 words
// (Montgomery form) in host memory, or NULL for none.
extern "C" int quill_ntt_pass(const void* src, void* dst, long long valid,
                              const void* y, const void* tw, int logn, int b0,
                              int s, int logc, int dif, int dit,
                              const void* scale, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        NTT_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  if (s + logc > NTT_TILE_LOG || logc > b0 || b0 + s > logn)
    return (int)cudaErrorInvalidValue;
  NttArgs a;
  a.src = (const uint32_t*)src;
  a.dst = (uint32_t*)dst;
  a.valid = valid;
  a.y = (const uint32_t*)y;
  a.tw = (const uint32_t*)tw;
  a.p = NttPass{logn, b0, s, logc};
  a.dif = dif;
  a.dit = dit;
  a.scaled = scale != nullptr;
  a.scale = scale != nullptr ? fe_load((const uint32_t*)scale)
                             : fe_zero<FrM>();
  ntt_pass_kernel<<<(unsigned)ntt_tiles(a.p), NTT_THREADS, NTT_SMEM,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The table's rows b < logn into tw (ntt_tw_row(logn) rows of 8 words);
// roots: (NTT_MAX_ROOT + 1) x 8 words in host memory.
extern "C" int quill_ntt_twiddles(void* tw, int logn, const void* roots,
                                  void* stream) {
  if (logn > NTT_MAX_ROOT) return (int)cudaErrorInvalidValue;
  const long long total = ntt_tw_row(logn);
  if (total == 0) return 0;
  NttRoots r;
  for (int m = 0; m <= NTT_MAX_ROOT; ++m)
    r.w[m] = fe_load((const uint32_t*)roots + 8 * m);
  ntt_twiddles_kernel<<<(unsigned)((total + NTT_THREADS - 1) / NTT_THREADS),
                        NTT_THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)tw, total, r);
  return (int)cudaGetLastError();
}

// out[k] = h[m + k] + h[m - 2 - k], k < m - 1; h has at least 2m - 1 rows.
extern "C" int quill_ntt_s_fold(const void* h, void* out, long long m,
                                void* stream) {
  if (m < 2) return 0;
  ntt_s_fold_kernel<<<(unsigned)((m - 1 + NTT_FOLD_BLOCK - 1) /
                                 NTT_FOLD_BLOCK),
                      NTT_FOLD_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)h, (uint32_t*)out, m);
  return (int)cudaGetLastError();
}
