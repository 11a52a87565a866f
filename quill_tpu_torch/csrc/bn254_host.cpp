// C interface to bn254.cuh compiled for the CPU with g++, so that the tests
// check the field and curve arithmetic every CUDA kernel shares before it
// reaches the card.  Buffers are row-major uint32 limbs (Montgomery form):
// field elements 8 words, affine points 16, projective points 24.
//
// Build: g++ -x c++ -std=c++17 -O2 -shared -fPIC -o libbn254_host.so
//        bn254_host.cpp
#include <algorithm>
#include <memory>
#include <vector>

#include "bn254.cuh"
#include "bucket.cuh"
#include "entries.cuh"
#include "fixed_base.cuh"
#include "ladder.cuh"
#include "ntt.cuh"
#include "query.cuh"
#include "quotient.cuh"
#include "seg_scan.cuh"
#include "sumcheck.cuh"
#include "tree.cuh"

using namespace bn254;

// The inclusive segmented scan of n entries (a power of two) level by level,
// each level reading the previous one's values as the kernel's shuffles do.
static void seg_scan_levels(bool* f, G1P* v, long n) {
  for (long d = 1; d < n; d <<= 1)
    for (long j = n - 1; j >= d; --j) seg_op(f[j - d], v[j - d], f[j], v[j]);
}

// Kernel C's block step (csrc/msm.cu: block_items) for the nb items of one
// block: the exclusive segmented scan of their (f, P) -- groups of
// min(nb, 32) levels as the warps do, then the group totals in order --
// each head resolved, and the block's item written to meta[0..1], pts[0..47].
static void block_items_host(const BucketItem* it, long nb, uint32_t* dense,
                             int* meta, uint32_t* pts) {
  const long w = nb < 32 ? nb : 32;
  std::unique_ptr<bool[]> f(new bool[nb]), cf(new bool[nb]);
  std::unique_ptr<G1P[]> s(new G1P[nb]), carry(new G1P[nb]);
  for (long t = 0; t < nb; ++t) {
    f[t] = it[t].f;
    s[t] = it[t].P;
  }
  for (long g = 0; g < nb; g += w) seg_scan_levels(&f[g], &s[g], w);
  for (long t = 0; t < nb; ++t) {
    cf[t] = t % w ? f[t - 1] : false;
    carry[t] = t % w ? s[t - 1] : g1_identity();
    if (t >= w) {  // the groups before this one
      bool wf = f[w - 1];
      G1P wt = s[w - 1];
      for (long g = 1; g < t / w; ++g) {
        bool fb = f[g * w + w - 1];
        G1P b = s[g * w + w - 1];
        seg_op(wf, wt, fb, b);
        wf = fb;
        wt = b;
      }
      seg_op(wf, wt, cf[t], carry[t]);
    }
  }
  int head = -1;
  for (long t = 0; t < nb; ++t) {
    G1P v;
    if (it[t].key >= 0 &&
        resolve(it[t].key, it[t].V, cf[t], carry[t], dense, &v)) {
      head = it[t].key;
      g1_store(pts + 24, v);
    }
  }
  bool lf = f[nb - 1];  // the last group's total after the groups before it
  G1P lp = s[nb - 1];
  if (nb > w) {
    bool wf = f[w - 1];
    G1P wt = s[w - 1];
    for (long g = 1; g < nb / w - 1; ++g) {
      bool fb = f[g * w + w - 1];
      G1P b = s[g * w + w - 1];
      seg_op(wf, wt, fb, b);
      wf = fb;
      wt = b;
    }
    seg_op(wf, wt, lf, lp);
  }
  meta[0] = lf;
  meta[1] = head;
  g1_store(pts, lp);
}

// One fix-up level of kernel C: n items (meta, pts), blocks of blk threads
// folding r items each -> ceil(n / (blk r)) items (ometa, opts).
static void fix_level_host(const int* meta, const uint32_t* pts, long n,
                           long r, long blk, uint32_t* dense, int* ometa,
                           uint32_t* opts) {
  std::vector<BucketItem> it(blk);
  const long nout = (n + blk * r - 1) / (blk * r);
  for (long b = 0; b < nout; ++b) {
    for (long t = 0; t < blk; ++t) {
      const long g = b * blk + t;
      const long lo = g * r < n ? g * r : n, hi = lo + r < n ? lo + r : n;
      it[t] = fold_items(meta, pts, lo, hi, dense);
    }
    block_items_host(it.data(), blk, dense, ometa + 2 * b, opts + 48 * b);
  }
}

// Kernel D's block step (csrc/msm.cu: block_combine) over nb threads' (a,
// S): suffix sums of S in groups of min(nb, 32) by levels, plus the later
// groups' totals; terms a_t + 2^lg suf_t (a_0 alone), summed by a tree over
// the block.
static void block_combine_host(const G1P* a, const G1P* S, long nb, int lg,
                               uint32_t* X, uint32_t* Y) {
  const long w = nb < 32 ? nb : 32;
  std::vector<G1P> suf(S, S + nb), x(nb), wsuf(nb / w);
  for (long d = 1; d < w; d <<= 1) {
    const std::vector<G1P> o(suf);
    for (long t = 0; t < nb; ++t)
      if (t % w + d < w) suf[t] = g1_add(o[t], o[t + d]);
  }
  for (long g = 0; g < nb / w; ++g) wsuf[g] = suf[g * w];
  for (long t = 0; t < nb; ++t) {
    const long g = t / w;
    if (g + 1 < nb / w) {
      G1P later = wsuf[g + 1];
      for (long h = g + 2; h < nb / w; ++h) later = g1_add(later, wsuf[h]);
      suf[t] = g1_add(suf[t], later);
    }
    x[t] = t == 0 ? a[0] : scaled_add(a[t], suf[t], lg);
  }
  for (long h = nb / 2; h > 0; h >>= 1)
    for (long t = 0; t < h; ++t) x[t] = g1_add(x[t], x[t + h]);
  g1_store(X, x[0]);
  if (Y != nullptr) g1_store(Y, suf[0]);
}

// a tile or a thread's slots as one array (the kernels keep them in shared
// memory)
struct HostFes {
  Fe* v;
  Fe get(int e) const { return v[e]; }
  void set(int e, const Fe& a) const { v[e] = a; }
};

// Kernel A's threads for NT points: thread x of block b strides over the
// pairs a warp at a time, as sc_round_kernel does; acc gets each thread's
// NT sums.
template <int NT>
void sc_threads(const ScParams& p, int slots, long blocks, long block,
                std::vector<Fe>& acc) {
  const Fe r = fe_load(p.r);
  std::vector<Fe> sv(slots > 0 ? slots : 1);
  HostFes sl{sv.data()};
  acc.assign(blocks * block * NT, fe_zero<FrM>());
  for (long b = 0; b < blocks; ++b)
    for (long x = 0; x < block; ++x) {
      Fe* a = &acc[(b * block + x) * NT];
      for (long long m = b * block + x; m < p.n_pairs; m += blocks * block) {
        sc_load_pair(p, m, r, sl);
        if (p.fold)
          for (int i = 0; i < p.k; ++i) {
            fe_store(p.out[i] + 8 * (2 * m), sl.get(i));
            fe_store(p.out[i] + 8 * (2 * m + 1),
                     fe_add<FrM>(sl.get(i), sl.get(p.k + i)));
          }
        sc_accumulate<NT>(p, sl, a);
      }
    }
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

void q_g1_dbl(const uint32_t* p, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    g1_store(out + 24 * i, g1_dbl(g1_load(p + 24 * i)));
}

// Kernel E's shifted basis (csrc/msm5.cu: shifted_basis_kernel) emulated:
// the thread body of ladder.cuh for every point.  xy: (n, 16); inf: (n,)
// bytes; out: (n nwin, 16), chunks of `chunk` points each window-major.
void q_shifted_basis(const uint32_t* xy, const uint8_t* inf, long n,
                     long chunk, int nwin, int wbits, uint32_t* out) {
  std::vector<uint32_t> scratch(16 * (nwin > 1 ? nwin - 1 : 1) * n);
  for (long i = 0; i < n; ++i)
    shifted_point(xy, inf, i, n, chunk, nwin, wbits, out, scratch.data());
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

// Kernel M (csrc/quotient.cu) emulated for one job: tiles of blk runs of r
// coefficients, each run's map by phase 1 of quotient.cuh, each run's map
// from the tile's top composed in thread order from the top and the tile's
// map, then the tiles' H at their tops (phase 2) and phase 3 on every run.
// Composition is associative and exact, so any bracketing of the kernel's
// scans gives these values.  c, out: (n, 8); x: 8 words, Montgomery; y: 8
// words, p(x) Montgomery.
void q_quotient_blocked(const uint32_t* c, long n, const uint32_t* x,
                        long blk, long r, uint32_t* out, uint32_t* y) {
  const long tile = blk * r, nt = (n + tile - 1) / tile;
  const Fe xv = fe_load(x), xr = qt_pow(xv, r);
  std::vector<QtMap> runc(nt * blk), tilet(nt);
  std::vector<long> lo(nt * blk), hi(nt * blk);
  for (long g = 0; g < nt; ++g) {
    std::vector<QtMap> m(blk);
    for (long t = 0; t < blk; ++t) {
      const long a = g * tile + t * r < n ? g * tile + t * r : n;
      lo[g * blk + t] = a;
      hi[g * blk + t] = a + r < n ? a + r : n;
      m[t] = qt_run_map(c, xv, xr, r, a, hi[g * blk + t]);
    }
    QtMap above = qt_identity();
    for (long t = blk - 1; t >= 0; --t) {
      runc[g * blk + t] = above;
      above = qt_compose(m[t], above);
    }
    tilet[g] = above;
  }
  std::vector<Fe> top(nt);
  QtMap above = qt_identity();
  for (long g = nt - 1; g >= 0; --g) {
    top[g] = above.b;
    above = qt_compose(tilet[g], above);
  }
  fe_store(y, above.b);
  for (long k = 0; k < nt * blk; ++k) {
    if (lo[k] >= hi[k]) continue;
    const QtMap& m = runc[k];
    qt_run_finish(c, xv, lo[k], hi[k], n,
                  fe_add<FrM>(m.b, fe_mul<FrM>(m.a, top[k / blk])), out);
  }
}

// Kernel C (csrc/msm.cu) emulated: the identity fill, then threads of k
// entries in blocks of blk (run_sums of bucket.cuh, then the block step),
// the blocks' items folded one a thread, and the top level in one block.
// basis (., 16); keys, entries: the n sorted entries; dense: (nd, 24).
void q_bucket_sums_blocked(const uint32_t* basis, const int* keys,
                           const int* entries, long n, long k, long blk,
                           long nd, uint32_t* dense) {
  for (long i = 0; i < nd; ++i) g1_store(dense + 24 * i, g1_identity());
  if (n == 0) return;
  const long nt = (n + k - 1) / k, n1 = (nt + blk - 1) / blk;
  const long n2 = (n1 + blk - 1) / blk;
  std::vector<int> m1(2 * n1), m2(2 * n2), m3(2);
  std::vector<uint32_t> p1(48 * n1), p2(48 * n2), p3(48);
  std::vector<BucketItem> it(blk);
  for (long b = 0; b < n1; ++b) {
    for (long t = 0; t < blk; ++t) {
      const long g = b * blk + t;
      const long lo = g * k < n ? g * k : n, hi = lo + k < n ? lo + k : n;
      it[t] = lo < hi ? run_sums(basis, keys, entries, n, lo, hi, dense)
                      : empty_item();
    }
    block_items_host(it.data(), blk, dense, &m1[2 * b], &p1[48 * b]);
  }
  fix_level_host(m1.data(), p1.data(), n1, 1, blk, dense, m2.data(),
                 p2.data());
  fix_level_host(m2.data(), p2.data(), n2, (n2 + blk - 1) / blk, blk, dense,
                 m3.data(), p3.data());
}

// Kernel D (csrc/msm.cu) emulated: buckets (nwin, nb, 24), segments of s
// buckets (seg_sums of bucket.cuh) in blocks of blk (a power of two), each
// block combined, then one block a window over its nb / (s blk) <= blk
// block items; out (nwin, 24).  Returns -1 on shapes the kernel refuses.
int q_bucket_reduce_blocked(const uint32_t* buckets, long nwin, long nb,
                            long s, long blk, uint32_t* out) {
  if (nb % (s * blk) != 0 || nb / (s * blk) > blk) return -1;
  int lg = 0, lgb = 0;
  while ((1L << lg) < s) ++lg;
  while ((1L << lgb) < blk) ++lgb;
  const long nblk = nb / (s * blk);
  std::vector<uint32_t> xy(48 * nwin * nblk);
  std::vector<G1P> a(blk), S(blk);
  for (long b = 0; b < nwin * nblk; ++b) {
    for (long t = 0; t < blk; ++t)
      seg_sums(buckets + 24 * (b * blk + t) * s, (int)s, &a[t], &S[t]);
    block_combine_host(a.data(), S.data(), blk, lg, &xy[48 * b],
                       &xy[48 * b + 24]);
  }
  for (long w = 0; w < nwin; ++w) {
    for (long t = 0; t < blk; ++t) {
      a[t] = t < nblk ? g1_load(&xy[48 * (w * nblk + t)]) : g1_identity();
      S[t] = t < nblk ? g1_load(&xy[48 * (w * nblk + t) + 24]) : g1_identity();
    }
    block_combine_host(a.data(), S.data(), blk, lg + lgb, out + 24 * w,
                       nullptr);
  }
  return 0;
}

// Kernel B's pass (csrc/ntt.cu: ntt_pass_kernel) emulated tile by tile:
// load (rows at or past `valid` are zero), the forward stages of ntt.cuh on
// bits b0 + s - 1 down to b0, the products by y[i] and by scale (either may
// be NULL), the inverse stages up, store.  dst may be src.
void q_ntt_pass_blocked(const uint32_t* src, uint32_t* dst, long valid,
                        const uint32_t* y, const uint32_t* tw, int logn,
                        int b0, int s, int logc, int dif, int dit,
                        const uint32_t* scale) {
  const NttPass p{logn, b0, s, logc};
  const int tile = ntt_tile_size(p);
  std::vector<Fe> buf(tile);
  HostFes t{buf.data()};
  for (long long g = 0; g < ntt_tiles(p); ++g) {
    for (int e = 0; e < tile; ++e) {
      const long long i = ntt_global(p, g, e);
      buf[e] = i < valid ? fe_load(src + 8 * i) : fe_zero<FrM>();
    }
    if (dif)
      for (int q = s - 1; q >= 0; --q)
        for (int k = 0; k < tile / 2; ++k) ntt_bfly_dif(t, p, tw, g, q, k);
    for (int e = 0; e < tile; ++e) {
      if (y != nullptr)
        buf[e] = fe_mul<FrM>(buf[e], fe_load(y + 8 * ntt_global(p, g, e)));
      if (scale != nullptr) buf[e] = fe_mul<FrM>(buf[e], fe_load(scale));
    }
    if (dit)
      for (int q = 0; q < s; ++q)
        for (int k = 0; k < tile / 2; ++k) ntt_bfly_dit(t, p, tw, g, q, k);
    for (int e = 0; e < tile; ++e)
      fe_store(dst + 8 * ntt_global(p, g, e), buf[e]);
  }
}

// Kernel B's twiddle table (ntt_twiddles_kernel): rows b < logn from roots
// (29 x 8 words, roots[m] of order 2^m).
void q_ntt_twiddles(uint32_t* tw, int logn, const uint32_t* roots) {
  std::vector<Fe> w(29);
  for (int m = 0; m < 29; ++m) w[m] = fe_load(roots + 8 * m);
  const Fe* rt = w.data();
  for (long long idx = 0; idx < ntt_tw_row(logn); ++idx) {
    const int b = ntt_tw_row_of(idx);
    fe_store(tw + 8 * idx, ntt_twiddle(rt, b, idx - ntt_tw_row(b)));
  }
}

// Kernel A (csrc/sumcheck_round.cu) emulated: `blocks` blocks of `block`
// threads (a multiple of 32) over the pairs (sc_threads); each warp's NT
// sums by the xor tree of its shuffles, the warps in order, then the
// partials launch (thread x sums blocks x, x + 128, ..., then a tree over
// 128 threads).  out: (nt, 8) Montgomery sums; the folded rows go to
// p->out.  Returns -1 outside the kernel's limits.
int q_sumcheck_round_blocked(const ScParams* p, int nt, int slots,
                             long blocks, long block, uint32_t* out) {
  if (nt < 1 || nt > SC_MAX_T || block % 32 != 0 || p->k > SC_MAX_TABLES ||
      slots > sc_slots(SC_MAX_TABLES, SC_MAX_STACK))
    return -1;
  std::vector<Fe> acc;
  switch (nt) {
    case 1: sc_threads<1>(*p, slots, blocks, block, acc); break;
    case 2: sc_threads<2>(*p, slots, blocks, block, acc); break;
    case 3: sc_threads<3>(*p, slots, blocks, block, acc); break;
    case 4: sc_threads<4>(*p, slots, blocks, block, acc); break;
    case 5: sc_threads<5>(*p, slots, blocks, block, acc); break;
    case 6: sc_threads<6>(*p, slots, blocks, block, acc); break;
    case 7: sc_threads<7>(*p, slots, blocks, block, acc); break;
    default: sc_threads<8>(*p, slots, blocks, block, acc); break;
  }
  for (int t = 0; t < nt; ++t) {
    std::vector<Fe> part(blocks), sh(128, fe_zero<FrM>());
    for (long b = 0; b < blocks; ++b) {
      Fe total = fe_zero<FrM>();
      for (long w = 0; w < block / 32; ++w) {
        Fe v[32];
        for (int l = 0; l < 32; ++l)
          v[l] = acc[(b * block + 32 * w + l) * nt + t];
        for (int d = 16; d > 0; d >>= 1) {
          Fe nv[32];
          for (int l = 0; l < 32; ++l) nv[l] = fe_add<FrM>(v[l], v[l ^ d]);
          for (int l = 0; l < 32; ++l) v[l] = nv[l];
        }
        total = w == 0 ? v[0] : fe_add<FrM>(total, v[0]);
      }
      part[b] = total;
    }
    for (long b = 0; b < blocks; ++b)
      sh[b % 128] = fe_add<FrM>(sh[b % 128], part[b]);
    for (int s = 64; s > 0; s >>= 1)
      for (int x = 0; x < s; ++x) sh[x] = fe_add<FrM>(sh[x], sh[x + s]);
    fe_store(out + 8 * t, sh[0]);
  }
  return 0;
}

long q_sumcheck_params_size() { return (long)sizeof(ScParams); }

// Kernel G (csrc/msm5.cu: tree_up_kernel<L, lanes>) emulated block by
// block: the staging maps and work items of tree.cuh, each phase's items in
// order, added by g1_add (an add a thread) or g1_add_split (the six lanes'
// steps).  x: (m, 24); o1, o2 as quill_tree_up2 (L = 2) or quill_tree_up (L
// = 1, m even, o2 unused).
void q_tree_up_blocked(int L, int lanes, const uint32_t* x, long m,
                       uint32_t* o1, uint32_t* o2) {
  const int S = tree_span(L, lanes);
  std::vector<uint32_t> sh(tree_words(S, false));
  for (long long b = 0; b < tree_blocks(S, m); ++b) {
    for (int i = 0; i < tree_pieces(S); ++i) up_load(S, x, m, b, i, sh.data());
    for (int phase = 1; phase <= L; ++phase)
      for (int k = 0; k < S >> phase; ++k) {
        if (!up_item_live(S, m, b, phase, k)) continue;
        G1P p, q;
        up_item_operands(sh.data(), phase, k, &p, &q);
        up_item_store(sh.data(), phase, k,
                      lanes ? g1_add_split(p, q) : g1_add(p, q));
      }
    for (int i = 0; i < up_store_pieces(L, S); ++i)
      up_store(S, o1, o2, m, b, i, sh.data());
  }
}

// Kernel H (tree_down_kernel<L, lanes>) emulated: p, u1, u0, m, out as
// quill_tree_down2 (L = 2) or quill_tree_down (L = 1: u1 unused, u0 the
// level below, m = 2k).
void q_tree_down_blocked(int L, int lanes, const uint32_t* p,
                         const uint32_t* u1, const uint32_t* u0, long m,
                         uint32_t* out) {
  const int S = tree_span(L, lanes);
  std::vector<uint32_t> sh(tree_words(S, false));
  for (long long b = 0; b < tree_blocks(S, m); ++b) {
    for (int i = 0; i < tree_pieces(S); ++i)
      down_load(L, S, p, u1, u0, m, b, i, sh.data());
    for (int phase = 3 - L; phase <= 2; ++phase)
      for (int k = 0; k < S >> (3 - phase); ++k) {
        if (!down_item_live(S, m, b, phase, k)) continue;
        G1P a, q;
        down_item_operands(sh.data(), phase, k, &a, &q);
        down_item_store(sh.data(), phase, k,
                        lanes ? g1_add_split(a, q) : g1_add(a, q));
      }
    for (int i = 0; i < tree_pieces(S); ++i)
      down_store(S, out, m, b, i, sh.data());
  }
}

// Kernels F and K (csrc/msm5.cu: tree_leaf_kernel) emulated block by
// block: the gather, each live pair's add in turn, the stores.  sh: (rows,
// 16); idx: (2k,) rows or NULL; out: (k, 24).
void q_tree_leaf_blocked(const uint32_t* sh, const int* idx, long k,
                         uint32_t* out) {
  std::vector<uint32_t> s(leaf_words());
  for (long long b = 0; b < (k + LEAF_NT - 1) / LEAF_NT; ++b) {
    for (int i = 0; i < 8 * LEAF_NT; ++i)
      leaf_load(sh, idx, k, b, i, s.data());
    for (int j = 0; j < LEAF_NT && b * LEAF_NT + j < k; ++j)
      leaf_pair(s.data(), j);
    for (int i = 0; i < 6 * LEAF_NT; ++i) leaf_store(out, k, b, i, s.data());
  }
}

int q_leaf_nt() { return LEAF_NT; }

// 1 where a two-level launch over m points goes by lanes
int q_tree_lanes(long m) { return tree_lanes(m); }

// tree.cuh's TREE_NT, TREE_TOP and TREE_LANE_LEVEL, which the Python side
// keeps as copies
int q_tree_nt() { return TREE_NT; }
int q_tree_top_width() { return TREE_TOP; }
long q_tree_lane_level() { return TREE_LANE_LEVEL; }

// The fused top (tree_top_kernel) emulated: `blocks` blocks of w rows, each
// level's items in order, by g1_add where the kernel gives an add a thread
// and by g1_add_split (the six lanes' steps) where it gives one a group.
// tree != 0: one block, out (w, 24) the prefixes; else out (blocks, 24)
// the spans' sums.  Returns -1 outside the kernel's limits.
int q_tree_top(const uint32_t* x, int w, long blocks, int tree,
               uint32_t* out) {
  if (w < 1 || w > TREE_TOP || (!tree && (w & (w - 1))) ||
      (tree && blocks != 1))
    return -1;
  std::vector<uint32_t> sh(PT_WORDS * top_slots(w));
  auto add = [](int n, const G1P& p, const G1P& q) {
    return n > TREE_TOP_LANE_MAX ? g1_add(p, q) : g1_add_split(p, q);
  };
  for (long b = 0; b < blocks; ++b) {
    const uint32_t* src = x + (long long)PT_WORDS * w * b;
    for (int i = 0; i < 6 * w; ++i) piece_copy(&sh[4 * i], src + 4 * i);
    int off = 0, s = w, levels = 1;
    while (s > 1) {
      const int off1 = off + s + (s & 1), n = (s + 1) >> 1;
      for (int j = 0; j < n; ++j) {
        G1P p, q;
        top_up_operands(sh.data(), off, s, j, &p, &q);
        top_up_store(sh.data(), off, s, off1, j, add(n, p, q));
      }
      off = off1;
      s = n;
      ++levels;
    }
    if (!tree) {
      for (int c = 0; c < 6; ++c)
        piece_copy(out + PT_WORDS * b + 4 * c, &sh[PT_WORDS * off + 4 * c]);
      continue;
    }
    for (int k = levels - 2; k >= 0; --k) {
      int o, sz;
      top_level(w, k, &o, &sz);
      const int o1 = o + sz + (sz & 1), n = (sz + 1) >> 1;
      for (int j = 0; j < n; ++j) {
        G1P p, q;
        top_down_operands(sh.data(), o, o1, j, &p, &q);
        top_down_store(sh.data(), o, o1, j, add(n, p, q));
      }
    }
    for (int i = 0; i < 6 * w; ++i) piece_copy(out + 4 * i, &sh[4 * i]);
  }
  return 0;
}

// Kernel J (csrc/fixed_base.cu: fixed_base_kernel) emulated block by block:
// each phase of fixed_base.cuh for the FB_NT threads in turn, every thread's
// running products c kept for it, as the kernel's threads keep theirs.
// scalars: (n, 8) canonical; table: (fb_windows(w) 2^(w-1), 16) affine;
// out: (n, 16) affine; *flag set to 1 for a point at infinity; ppt points
// a thread (1 .. FB_PPT; the launch takes fb_ppt's).
void q_fixed_base_blocked(const uint32_t* scalars, long n, const uint32_t* table,
                          int w, int ppt, uint32_t* out, int* flag) {
  std::vector<uint32_t> sh(fb_words());
  std::vector<Fe> c((size_t)FB_NT * FB_PPT);
  const int nwin = fb_windows(w), span = FB_NT * ppt;
  for (long long b = 0; b < fb_blocks(n, ppt); ++b) {
    for (int t = 0; t < FB_NT; ++t)
      for (int j = 0; j < ppt; ++j)
        if (fb_compute(scalars, n, table, w, nwin, b, span, j * FB_NT + t,
                       sh.data()))
          *flag = 1;
    for (int t = 0; t < FB_NT; ++t)
      fb_chain(sh.data(), t, ppt, &c[FB_PPT * t]);
    for (int lvl = FB_NT / 2; lvl >= 1; lvl >>= 1)
      for (int t = 0; t < lvl; ++t) fb_heap_up(sh.data(), lvl + t);
    fb_heap_invert(sh.data());
    for (int lvl = 1; lvl < FB_NT; lvl <<= 1)
      for (int t = 0; t < lvl; ++t) fb_heap_down(sh.data(), lvl + t);
    for (int t = 0; t < FB_NT; ++t)
      fb_back(sh.data(), t, ppt, &c[FB_PPT * t]);
    for (int i = 0; i < 4 * span; ++i) fb_store(out, n, b, span, i, sh.data());
  }
}

// fixed_base.cuh's widest block span, window count and points a thread for
// a launch
int q_fb_span() { return FB_SPAN; }
int q_fb_ppt(long n, int sms, int minb) { return fb_ppt(n, sms, minb); }
int q_fb_windows(int w) { return fb_windows(w); }

// One bucket's signed digits (fb_digit) for a test: out[k], k < nwin
void q_fb_digits(const uint32_t* s, int w, int* out) {
  uint32_t carry = 0u;
  for (int k = 0; k < fb_windows(w); ++k) out[k] = fb_digit(s, w, k, &carry);
}

// Kernel E's walk mode (csrc/msm5.cu: query_walk_kernel) emulated: walk_query
// for each bucket.  cnt: (nq,) int64; levels: kmin - 1 host pointers.
void q_query_walk(const long long* cnt, long nq, const uint32_t* top,
                  const unsigned long long* levels, int kmin,
                  const uint32_t* sh, const int* idx, uint32_t* out) {
  WalkLevels lv;
  for (int k = 0; k < WALK_MAX; ++k)
    lv.p[k] = k < kmin - 1 ? (const uint32_t*)levels[k] : nullptr;
  for (long i = 0; i < nq; ++i)
    g1_store(out + PT_WORDS * i, walk_query(cnt[i], kmin, top, lv, sh, idx));
}

// Kernel E's add (pt_add_kernel) emulated block by block: tree.cuh's
// staging maps, an add a thread (S = 128, g1_add) or a group
// (S = ADD_LANE_SPAN, g1_add_split).  flags may be NULL.
void q_pt_add_blocked(const uint32_t* a, const uint32_t* b,
                      const uint8_t* flags, long n, int lanes, uint32_t* out) {
  const int S = lanes ? ADD_LANE_SPAN : 128;
  std::vector<uint32_t> sh(25 * 2 * S);
  for (long long r0 = 0; r0 < n; r0 += S) {
    for (int i = 0; i < 12 * S; ++i) add_load(a, b, n, r0, S, i, sh.data());
    for (int k = 0; k < S; ++k) {
      if (r0 + k >= n || (flags != nullptr && flags[r0 + k])) continue;
      const G1P p = pt_ld(tree_slot(sh.data(), k));
      const G1P q = pt_ld(tree_slot(sh.data(), S + k));
      pt_st(tree_slot(sh.data(), k), lanes ? g1_add_split(p, q) : g1_add(p, q));
    }
    for (int i = 0; i < 6 * S; ++i)
      add_store(flags, n, r0, S, i, sh.data(), out);
  }
}

// v8's entries kernels (csrc/msm8.cu: v8e_*) on one chunk, launch by
// launch in order, from the same pieces (entries.cuh): the digits and each
// segment's histograms, their prefixes over the segments and the windows'
// totals, each digit's first position, the place kernel's warps one round
// of 32 lanes at a time (__match_any_sync's groups found by comparing the
// lanes' digits, each group's first lane advancing its counter), then every
// position's coordinates, digit and flag.  sd (NWIN, npad) int32, pts
// (NWIN * npad, 24) and flags (NWIN * npad) as quill_v8_entries writes
// them.
void q_v8_entries_blocked(const uint32_t* scs, const uint32_t* xy,
                          const uint8_t* inf, long n, long npad, long seg,
                          int32_t* sd, uint32_t* pts, uint8_t* flags) {
  const long S = (n + seg - 1) / seg, NB = V8E_NBUCK, W = V8E_NWIN;
  std::vector<uint16_t> dig(W * n);
  std::vector<int> hist(W * S * NB, 0), tot(W * NB), start(W * NB);
  std::vector<int32_t> ent(W * npad, -1);
  for (long i = 0; i < n; ++i) {
    const Fe c = v8e_canonical(scs + 8 * i);
    for (int w = 0; w < W; ++w) dig[w * n + i] = (uint16_t)v8e_digit(c, w);
  }
  for (long w = 0; w < W; ++w)
    for (long i = 0; i < n; ++i) ++hist[(w * S + i / seg) * NB + dig[w * n + i]];
  for (long w = 0; w < W; ++w) {
    int run = 0;
    for (long d = 0; d < NB; ++d) {
      tot[w * NB + d] = v8e_column(&hist[(w * S) * NB + d], S, NB) +
                        (d == 0 ? (int)(npad - n) : 0);
      start[w * NB + d] = run;
      run += tot[w * NB + d];
    }
  }
  for (long w = 0; w < W; ++w)
    for (long s = 0; s < S; ++s) {
      int* c = &hist[(w * S + s) * NB];
      const long lo = s * seg, hi = std::min(n, lo + seg);
      for (long base = lo; base < hi; base += 32) {
        int d[32], o[32];
        for (int l = 0; l < 32; ++l)
          d[l] = base + l < hi ? dig[w * n + base + l] : 0;
        for (int l = 0; l < 32; ++l) {
          if (d[l] == 0) continue;
          int leader = 0, rank = 0, size = 0;
          while (d[leader] != d[l]) ++leader;
          for (int j = 0; j < 32; ++j) {
            size += d[j] == d[l];
            rank += j < l && d[j] == d[l];
          }
          if (l == leader) {
            o[l] = start[w * NB + d[l]] + c[d[l]];
            c[d[l]] += size;
          }
          ent[w * npad + o[leader] + rank] = v8e_pack(d[l], base + l);
        }
      }
    }
  for (long q = 0; q < W * npad; ++q) {
    const long w = q / npad, p = q - w * npad;
    const int z = tot[w * NB];
    for (int k = 0; k < 3; ++k) v8e_emit(q, k, p, z, ent.data(), xy, inf, pts);
    flags[q] = v8e_flag(q, p, z, ent.data());
    sd[q] = p < z ? 0 : v8e_entry_digit(ent[q]);
  }
}

}  // extern "C"
