// The per-thread pieces of kernel A (csrc/sumcheck_round.cu), shared by the
// kernel and its host emulation (bn254_host.cpp: q_sumcheck_round_blocked).
//
// A round's arguments travel by value in the launch (ScParams): the tables'
// pointers, the fold's challenge r, the expression's postfix program
// (engine/expr.py) and its constants, so a round copies nothing to the
// card.  A thread keeps its pair's state in "slots" that the kernel holds
// in shared memory: slot i < k the value of table i at the current point,
// slot k + i its difference hi - lo, slots 2k .. the program's stack below
// its top, which stays in registers (sc_program).  Every slot index is the
// same across a warp at each step (one program for all threads), so the
// kernel's slots are uniform addresses into a conflict-free layout.
#pragma once

#include "bn254.cuh"

namespace bn254 {

constexpr int SC_MAX_TABLES = 16;
constexpr int SC_MAX_T = 8;        // evaluation points: degree <= 7
constexpr int SC_MAX_STACK = 16;
constexpr int SC_MAX_OPS = 512;
constexpr int SC_MAX_CONSTS = 64;  // an op's argument fits in 6 bits

enum { OP_IN = 0, OP_CONST = 1, OP_ADD = 2, OP_MUL = 3 };

struct ScParams {
  const uint32_t* in[SC_MAX_TABLES];
  uint32_t* out[SC_MAX_TABLES];  // the folded tables (fold only)
  uint32_t r[8];                 // the fold's challenge, Montgomery form
  uint32_t consts[SC_MAX_CONSTS][8];
  uint8_t ops[SC_MAX_OPS];       // (arg << 2) | code
  long long n_pairs;
  int k, prog_len, fold, unused;
};

// slots a thread needs for k tables and a program of stack depth `depth`
QHD int sc_slots(int k, int depth) {
  return 2 * k + (depth > 1 ? depth - 1 : 0);
}

// h at the thread's current values (slots 0 .. k-1)
template <class Slots>
QHD Fe sc_program(const ScParams& p, Slots& sl) {
  const int base = 2 * p.k;
  Fe top = fe_zero<FrM>();
  int sp = 0;
  for (int pc = 0; pc < p.prog_len; ++pc) {
    const int op = p.ops[pc], code = op & 3, arg = op >> 2;
    if (code == OP_IN || code == OP_CONST) {
      if (pc > 0) sl.set(base + sp++, top);
      top = code == OP_IN ? sl.get(arg) : fe_load(p.consts[arg]);
    } else {
      const Fe below = sl.get(base + --sp);
      top = code == OP_ADD ? fe_add<FrM>(below, top)
                           : fe_mul<FrM>(below, top);
    }
  }
  return top;
}

// pair m of every table into the slots: with fold, lo = f[2m] and hi =
// f[2m+1] of the table folded at r, f[p] = T[2p] + r (T[2p+1] - T[2p]);
// without, lo = T[2m], hi = T[2m+1].  Slot k + i gets hi - lo.
template <class Slots>
QHD void sc_load_pair(const ScParams& p, long long m, const Fe& r,
                      Slots& sl) {
  for (int i = 0; i < p.k; ++i) {
    const uint32_t* T = p.in[i];
    Fe lo, hi;
    if (p.fold) {
      const uint32_t* q = T + 8 * (4 * m);
      const Fe t0 = fe_load16(q), t1 = fe_load16(q + 8);
      const Fe t2 = fe_load16(q + 16), t3 = fe_load16(q + 24);
      lo = fe_add<FrM>(t0, fe_mul<FrM>(r, fe_sub<FrM>(t1, t0)));
      hi = fe_add<FrM>(t2, fe_mul<FrM>(r, fe_sub<FrM>(t3, t2)));
    } else {
      lo = fe_load16(T + 8 * (2 * m));
      hi = fe_load16(T + 8 * (2 * m + 1));
    }
    sl.set(i, lo);
    sl.set(p.k + i, fe_sub<FrM>(hi, lo));
  }
}

// acc[t] += h(lo + t (hi - lo)) for t < NT; leaves slots 0 .. k-1 at the
// last point
template <int NT, class Slots>
QHD void sc_accumulate(const ScParams& p, Slots& sl, Fe* acc) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    acc[t] = fe_add<FrM>(acc[t], sc_program(p, sl));
    if (t + 1 < NT)
      for (int i = 0; i < p.k; ++i)
        sl.set(i, fe_add<FrM>(sl.get(i), sl.get(p.k + i)));
  }
}

}  // namespace bn254
