// BN254 field and G1 arithmetic shared by every kernel of quill_tpu_torch.
//
// Counterpart of the in-kernel bodies of the TPU build:
//   quill_tpu/fields/device8.py  mont_mul (8-bit limb Montgomery product),
//   quill_tpu/fields/pallas8.py  emit_pt_add (complete projective add),
//   quill_tpu/ec/msm5.py         emit_pt_add_aff (affine + affine add).
//
// Layout: an element is eight uint32 limbs, little-endian, in Montgomery form
// with R = 2^256, canonical (< modulus) -- the same bits as the port's
// (n, 8) int32 torch tensors.  Multiplication is CIOS (coarsely integrated
// operand scanning) on 32x32->64-bit products, which nvcc lowers to
// mul.wide / mad.wide.u32; the same source compiles with g++ (the CUDA
// qualifiers are defined away below), which is how the CPU tests check it.
//
// G1 formulas: Renes-Costello-Batina 2015 (eprint 2015/1060), a = 0,
// b3 = 3b = 9: algorithm 7 (projective + projective, 12 mults), algorithm 8
// (projective + affine, 11 mults), algorithm 8 with Z1 = 1 (affine +
// affine, 9 mults) and algorithm 9 (doubling, 8 mults).  All four are
// complete: no branch on the inputs.  The identity is (0 : 1 : 0); an
// affine operand is never the identity.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define QHD __host__ __device__ __forceinline__
#else
#define QHD inline
#endif

namespace bn254 {

struct Fe {
  uint32_t v[8];
};

struct FqM {
  QHD static uint32_t p(int i) {
    const uint32_t m[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return m[i];
  }
  QHD static uint32_t one(int i) {
    const uint32_t m[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                           0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return m[i];
  }
  QHD static uint32_t b3(int i) {  // 9 in Montgomery form
    const uint32_t m[8] = {0x410d7ff7u, 0xf60647ceu, 0xd31bd011u, 0x2f3d6f4du,
                           0x3940c6d1u, 0x2943337eu, 0xa7e39857u, 0x1d9598e8u};
    return m[i];
  }
  static constexpr uint32_t inv = 0xe4866389u;  // -p^-1 mod 2^32
};

struct FrM {
  QHD static uint32_t p(int i) {
    const uint32_t m[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return m[i];
  }
  QHD static uint32_t one(int i) {
    const uint32_t m[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                           0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return m[i];
  }
  static constexpr uint32_t inv = 0xefffffffu;
};

template <class M>
QHD Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = 0u;
  return r;
}

template <class M>
QHD Fe fe_one() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = M::one(i);
  return r;
}

QHD bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.v[i];
  return acc == 0u;
}

// r = a - p if a >= p else a  (a < 2p, no 257th bit)
template <class M>
QHD Fe fe_reduce_once(const Fe& a) {
  Fe d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)a.v[i] - M::p(i) - borrow;
    d.v[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  return borrow ? a : d;
}

template <class M>
QHD Fe fe_add(const Fe& a, const Fe& b) {
  Fe s;
  uint32_t carry = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)a.v[i] + b.v[i] + carry;
    s.v[i] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  return fe_reduce_once<M>(s);  // a + b < 2p < 2^255: no carry out
}

template <class M>
QHD Fe fe_sub(const Fe& a, const Fe& b) {
  Fe d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  if (borrow) {
    uint32_t carry = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t t = (uint64_t)d.v[i] + M::p(i) + carry;
      d.v[i] = (uint32_t)t;
      carry = (uint32_t)(t >> 32);
    }
  }
  return d;
}

template <class M>
QHD Fe fe_neg(const Fe& a) {
  return fe_sub<M>(fe_zero<M>(), a);
}

// Montgomery product a * b / 2^256 mod p (CIOS, 8 x 32-bit limbs).
template <class M>
QHD Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t carry = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + carry;
      t[j] = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
    }
    uint64_t s = (uint64_t)t[8] + carry;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * M::inv;
    s = (uint64_t)m * M::p(0) + t[0];
    carry = (uint32_t)(s >> 32);
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)m * M::p(j) + t[j] + carry;
      t[j - 1] = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
    }
    s = (uint64_t)t[8] + carry;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = t[i];
  return fe_reduce_once<M>(r);  // result < 2p; t[8] is 0 for p < 2^254
}

// a^(p - 2) = a^-1 for a != 0 (Fermat): square and multiply over the
// exponent's bits from the top, 256 squarings and 110 products for Fq.  The
// words are unrolled so that each is a constant (no array indexed at run
// time), the bits are not.
template <class M>
QHD Fe fe_inv(const Fe& a) {
  Fe r = fe_one<M>();
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    const uint32_t e = M::p(i) - (i == 0 ? 2u : 0u);  // p's low word > 2
#pragma unroll 1
    for (int b = 31; b >= 0; --b) {
      r = fe_mul<M>(r, r);
      if ((e >> b) & 1u) r = fe_mul<M>(r, a);
    }
  }
  return r;
}

// 9 a = 8 a + a
QHD Fe fq_mul_b3(const Fe& a) {
  Fe d = fe_add<FqM>(a, a);
  d = fe_add<FqM>(d, d);
  d = fe_add<FqM>(d, d);
  return fe_add<FqM>(d, a);
}

// ---------------------------------------------------------------------------
// G1
// ---------------------------------------------------------------------------

struct G1P {  // homogeneous projective (X : Y : Z)
  Fe x, y, z;
};

struct G1A {  // affine, never the identity
  Fe x, y;
};

QHD G1P g1_identity() {
  G1P r;
  r.x = fe_zero<FqM>();
  r.y = fe_one<FqM>();
  r.z = fe_zero<FqM>();
  return r;
}

QHD G1P g1_from_affine(const G1A& a) {
  G1P r;
  r.x = a.x;
  r.y = a.y;
  r.z = fe_one<FqM>();
  return r;
}

// shared tail of algorithms 7 and 8 (t0 already tripled, t1 = t1 - b3 t2,
// y3 = b3 y3, z3 = t1 + b3 t2)
QHD G1P g1_finish(const Fe& t0, const Fe& t1, const Fe& t3, const Fe& t4,
                  const Fe& y3, const Fe& z3) {
  G1P r;
  Fe a = fe_mul<FqM>(t4, y3);
  Fe b = fe_mul<FqM>(t3, t1);
  r.x = fe_sub<FqM>(b, a);
  Fe c = fe_mul<FqM>(y3, t0);
  Fe d = fe_mul<FqM>(t1, z3);
  r.y = fe_add<FqM>(d, c);
  Fe e = fe_mul<FqM>(t0, t3);
  Fe f = fe_mul<FqM>(z3, t4);
  r.z = fe_add<FqM>(f, e);
  return r;
}

// algorithm 7: complete projective + projective
QHD G1P g1_add(const G1P& p, const G1P& q) {
  Fe t0 = fe_mul<FqM>(p.x, q.x);
  Fe t1 = fe_mul<FqM>(p.y, q.y);
  Fe t2 = fe_mul<FqM>(p.z, q.z);
  Fe t3 = fe_mul<FqM>(fe_add<FqM>(p.x, p.y), fe_add<FqM>(q.x, q.y));
  t3 = fe_sub<FqM>(t3, fe_add<FqM>(t0, t1));
  Fe t4 = fe_mul<FqM>(fe_add<FqM>(p.y, p.z), fe_add<FqM>(q.y, q.z));
  t4 = fe_sub<FqM>(t4, fe_add<FqM>(t1, t2));
  Fe y3 = fe_mul<FqM>(fe_add<FqM>(p.x, p.z), fe_add<FqM>(q.x, q.z));
  y3 = fe_sub<FqM>(y3, fe_add<FqM>(t0, t2));
  t0 = fe_add<FqM>(fe_add<FqM>(t0, t0), t0);
  t2 = fq_mul_b3(t2);
  Fe z3 = fe_add<FqM>(t1, t2);
  t1 = fe_sub<FqM>(t1, t2);
  y3 = fq_mul_b3(y3);
  return g1_finish(t0, t1, t3, t4, y3, z3);
}

// algorithm 8: complete projective + affine
QHD G1P g1_add_mixed(const G1P& p, const G1A& q) {
  Fe t0 = fe_mul<FqM>(p.x, q.x);
  Fe t1 = fe_mul<FqM>(p.y, q.y);
  Fe t3 = fe_mul<FqM>(fe_add<FqM>(q.x, q.y), fe_add<FqM>(p.x, p.y));
  t3 = fe_sub<FqM>(t3, fe_add<FqM>(t0, t1));
  Fe t4 = fe_add<FqM>(fe_mul<FqM>(q.y, p.z), p.y);
  Fe y3 = fe_add<FqM>(fe_mul<FqM>(q.x, p.z), p.x);
  t0 = fe_add<FqM>(fe_add<FqM>(t0, t0), t0);
  Fe t2 = fq_mul_b3(p.z);
  Fe z3 = fe_add<FqM>(t1, t2);
  t1 = fe_sub<FqM>(t1, t2);
  y3 = fq_mul_b3(y3);
  return g1_finish(t0, t1, t3, t4, y3, z3);
}

// algorithm 8 with Z1 = 1: complete affine + affine
QHD G1P g1_add_affine(const G1A& p, const G1A& q) {
  Fe t0 = fe_mul<FqM>(p.x, q.x);
  Fe t1 = fe_mul<FqM>(p.y, q.y);
  Fe t3 = fe_mul<FqM>(fe_add<FqM>(q.x, q.y), fe_add<FqM>(p.x, p.y));
  t3 = fe_sub<FqM>(t3, fe_add<FqM>(t0, t1));
  Fe t4 = fe_add<FqM>(q.y, p.y);
  Fe y3 = fe_add<FqM>(q.x, p.x);
  t0 = fe_add<FqM>(fe_add<FqM>(t0, t0), t0);
  Fe t2;
#pragma unroll
  for (int i = 0; i < 8; ++i) t2.v[i] = FqM::b3(i);
  Fe z3 = fe_add<FqM>(t1, t2);
  t1 = fe_sub<FqM>(t1, t2);
  y3 = fq_mul_b3(y3);
  return g1_finish(t0, t1, t3, t4, y3, z3);
}

// algorithm 9: complete projective doubling, a = 0.  6 products and 2
// squarings (b3 t2 by adds), against g1_add(p, p)'s 12; the identity
// doubles to itself.  Jacobian dbl-2009-l takes 2 products and 5
// squarings, 7 in all, but its points need Z^-2 and Z^-3 when normalised
// (2 more products a window point) and a conversion to and from this
// projective form wherever the other adds read them: on the small route's
// ladder (247 doublings, 19 window ends) it would save ~10% of the
// products, at the price of a second representation and its own plain
// twin.  This one keeps a single form for every kernel.
QHD G1P g1_dbl(const G1P& p) {
  const Fe t0 = fe_mul<FqM>(p.y, p.y);
  Fe z3 = fe_add<FqM>(t0, t0);
  z3 = fe_add<FqM>(z3, z3);
  z3 = fe_add<FqM>(z3, z3);
  const Fe t1 = fe_mul<FqM>(p.y, p.z);
  const Fe t2 = fq_mul_b3(fe_mul<FqM>(p.z, p.z));
  G1P r;
  r.x = fe_mul<FqM>(t2, z3);
  Fe y3 = fe_add<FqM>(t0, t2);
  r.z = fe_mul<FqM>(t1, z3);
  const Fe u = fe_sub<FqM>(t0, fe_add<FqM>(fe_add<FqM>(t2, t2), t2));
  r.y = fe_add<FqM>(r.x, fe_mul<FqM>(u, y3));
  r.x = fe_mul<FqM>(u, fe_mul<FqM>(p.x, p.y));
  r.x = fe_add<FqM>(r.x, r.x);
  return r;
}

// ---------------------------------------------------------------------------
// loads and stores (row-major (n, 8) uint32 coordinates)
// ---------------------------------------------------------------------------

QHD Fe fe_load(const uint32_t* p) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = p[i];
  return r;
}

QHD void fe_store(uint32_t* p, const Fe& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = a.v[i];
}

// one field element as two 16-byte accesses on the card (rows are 32 bytes
// and the buffers 16-byte aligned); plain words on the host
QHD Fe fe_load16(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  const uint4 lo = reinterpret_cast<const uint4*>(p)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(p)[1];
  Fe r;
  r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
  r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
  return r;
#else
  return fe_load(p);
#endif
}

QHD void fe_store16(uint32_t* p, const Fe& a) {
#ifdef __CUDA_ARCH__
  reinterpret_cast<uint4*>(p)[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
#else
  fe_store(p, a);
#endif
}

QHD G1P g1_load(const uint32_t* p) {  // 24 words: x, y, z
  G1P r;
  r.x = fe_load(p);
  r.y = fe_load(p + 8);
  r.z = fe_load(p + 16);
  return r;
}

QHD void g1_store(uint32_t* p, const G1P& a) {
  fe_store(p, a.x);
  fe_store(p + 8, a.y);
  fe_store(p + 16, a.z);
}

QHD G1A g1a_load(const uint32_t* p) {  // 16 words: x, y
  G1A r;
  r.x = fe_load(p);
  r.y = fe_load(p + 8);
  return r;
}

}  // namespace bn254
