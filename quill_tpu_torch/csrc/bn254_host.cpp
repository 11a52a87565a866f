// C interface to bn254.cuh compiled for the CPU with g++, so that the tests
// check the field and curve arithmetic every CUDA kernel shares before it
// reaches the card.  Buffers are row-major uint32 limbs (Montgomery form):
// field elements 8 words, affine points 16, projective points 24.
//
// Build: g++ -x c++ -std=c++17 -O2 -shared -fPIC -o libbn254_host.so
//        bn254_host.cpp
#include <memory>

#include "bn254.cuh"
#include "seg_scan.cuh"

using namespace bn254;

// The inclusive segmented scan of n entries (a power of two) level by level,
// each level reading the previous one's values as the kernel's shuffles do.
static void seg_scan_levels(bool* f, G1P* v, long n) {
  for (long d = 1; d < n; d <<= 1)
    for (long j = n - 1; j >= d; --j) seg_op(f[j - d], v[j - d], f[j], v[j]);
}

extern "C" {

void q_fq_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    fe_store(out + 8 * i, fe_mul<FqM>(fe_load(a + 8 * i), fe_load(b + 8 * i)));
}

void q_fr_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    fe_store(out + 8 * i, fe_mul<FrM>(fe_load(a + 8 * i), fe_load(b + 8 * i)));
}

void q_fr_add(const uint32_t* a, const uint32_t* b, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    fe_store(out + 8 * i, fe_add<FrM>(fe_load(a + 8 * i), fe_load(b + 8 * i)));
}

void q_fr_sub(const uint32_t* a, const uint32_t* b, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    fe_store(out + 8 * i, fe_sub<FrM>(fe_load(a + 8 * i), fe_load(b + 8 * i)));
}

void q_fq_add(const uint32_t* a, const uint32_t* b, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    fe_store(out + 8 * i, fe_add<FqM>(fe_load(a + 8 * i), fe_load(b + 8 * i)));
}

void q_fq_sub(const uint32_t* a, const uint32_t* b, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    fe_store(out + 8 * i, fe_sub<FqM>(fe_load(a + 8 * i), fe_load(b + 8 * i)));
}

void q_g1_add(const uint32_t* p, const uint32_t* q, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    g1_store(out + 24 * i, g1_add(g1_load(p + 24 * i), g1_load(q + 24 * i)));
}

void q_g1_add_mixed(const uint32_t* p, const uint32_t* q, uint32_t* out,
                    long n) {
  for (long i = 0; i < n; ++i)
    g1_store(out + 24 * i,
             g1_add_mixed(g1_load(p + 24 * i), g1a_load(q + 16 * i)));
}

void q_g1_add_affine(const uint32_t* p, const uint32_t* q, uint32_t* out,
                     long n) {
  for (long i = 0; i < n; ++i)
    g1_store(out + 24 * i,
             g1_add_affine(g1a_load(p + 16 * i), g1a_load(q + 16 * i)));
}

// Kernel I (csrc/msm8.cu) emulated: blocks of max(SCAN_BLOCK, T) threads,
// T (a power of two) to a lane.  Each thread runs phase 1 of seg_scan.cuh on
// its run, phase 2 combines the run totals in the kernel's order (groups of
// min(T, 32) threads, then for T > 32 the warp totals), and phase 3 deals
// the block's fix-ups out as the kernel does, taken here in order.  xs, ys:
// (m, s, 24); flags: (m, s) bytes or NULL.
void q_seg_scan_blocked(const uint32_t* xs, const uint8_t* flags, long m,
                        long s, long T, uint32_t* ys) {
  const long r = (s + T - 1) / T, w = T < 32 ? T : 32, nw = T / 32;
  const long nb = T > SCAN_BLOCK ? T : SCAN_BLOCK, lanes = nb / T;
  std::unique_ptr<G1P[]> tot(new G1P[nb]), carry(new G1P[nb]);
  std::unique_ptr<G1P[]> wt(new G1P[nw > 0 ? nw : 1]);
  std::unique_ptr<bool[]> fl(new bool[nb]), cf(new bool[nb]);
  std::unique_ptr<bool[]> wf(new bool[nw > 0 ? nw : 1]);
  std::unique_ptr<long long[]> lo(new long long[nb]), off(new long long[nb]);
  for (long lane0 = 0; lane0 < m; lane0 += lanes) {
    long long total = 0;
    for (long b = 0; b < nb; b += T) {  // one lane of the block
      const long lane = lane0 + b / T;
      for (long k = 0; k < T; ++k) {
        long long a = lane < m && k * r < s ? k * r : s;
        long long hi = a + r < s ? a + r : s, first = hi;
        tot[b + k] = g1_identity();
        if (a < hi)
          tot[b + k] = run_scan(xs + lane * s * 24,
                                flags == nullptr ? nullptr : flags + lane * s,
                                a, hi, ys + lane * s * 24, &first);
        fl[b + k] = first < hi;
        lo[b + k] = a;
        off[b + k] = k > 0 ? first - a : 0;  // the run's fix-ups, for now
      }
      for (long g = b; g < b + T; g += w) seg_scan_levels(&fl[g], &tot[g], w);
      for (long k = 0; k < T; ++k) {
        carry[b + k] = k % w == 0 ? g1_identity() : tot[b + k - 1];
        cf[b + k] = k % w == 0 ? false : fl[b + k - 1];
      }
      if (T > 32) {
        for (long i = 0; i < nw; ++i) {
          wt[i] = tot[b + 32 * i + 31];
          wf[i] = fl[b + 32 * i + 31];
        }
        seg_scan_levels(wf.get(), wt.get(), nw);
        for (long k = 32; k < T; ++k)
          seg_op(wf[k / 32 - 1], wt[k / 32 - 1], cf[b + k], carry[b + k]);
      }
    }
    for (long t = 0; t < nb; ++t) {  // counts -> exclusive offsets
      const long long c = off[t];
      off[t] = total;
      total += c;
    }
    for (long long i = 0; i < total; ++i)
      block_fixup(i, off.get(), lo.get(), carry.get(), (int)nb, (int)T,
                  lane0, s, ys);
  }
}

}  // extern "C"
