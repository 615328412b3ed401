// Field layer on PTX carry chains for Hopper (sm_90a): 256-bit
// Montgomery multiplies (R = 2^256), one value per thread, operands and
// results in registers.
//
//   mul_p, sqr_p       mod P-256's p.  The 64 limb products go through
//                      carry chains (mad.lo.cc / madc.lo.cc / mad.hi.cc /
//                      madc.hi.cc / addc) into a 512-bit product; the
//                      reduction uses p's special form with adds only:
//                      p's limbs are 0, 1 and 2^32 - 1 and -p^-1 = 1 mod
//                      2^32, so with q = t_i, t + q p 2^(32 i) adds q at
//                      word i + 3, q at i + 6 and q (2^32 - 1) at i + 7
//                      and i + 8, and zeroes word i.  (KF2's `min`,
//                      field_chain_variants.cu, is the same product and
//                      reduction with a lazy end.)
//   mul_25519          mod p25519 = 2^255 - 19, R = 2^256 (KE5, KE6).  The
//                      same product; each reduction step takes
//                      q = t_i 19^-1 mod 2^32 and adds (t_i + q p) / 2^32 =
//                      q 2^223 - floor(19 q / 2^32), eight words formed
//                      from q with two multiplies and a few ALU ops, in one
//                      carry chain: no q p rows.
//   mont_mul_ptx<M>    a generic CIOS for a modulus with no special form
//                      (P-256's n; BN254's p has its limbs here too): each
//                      step's a_i b row and q m row, q = t_0 (-m^-1), is
//                      one asm statement.
//
// All end fully reduced in [0, m): one conditional subtraction of m from
// the 257-bit result, which lies in [0, 2m).  Preconditions, as for
// p256_field.cuh's mont_mul: a < 2^256 (to_mont is given unreduced words)
// and b < m, so that a b < m 2^256.  r may alias a or b: r is written
// only after every read.  sqr_p is mul_p(a, a), so its a must be < p.
//
// Every carry chain lives whole inside one asm statement: the carry flag
// does not survive between statements.  tests/test_torch_field_ptx.py
// runs the PTX text of each statement below through an instruction-level
// model of these carry semantics and holds the routines against Python
// ints; a change to any asm statement here is checked there.
//
// Operands stay in registers.  The arithmetic is forced inline; the
// point layer's policy PtxField (KP2's and KP3's field) reaches the
// multiply mod p through mul_p_call, a real call whose operands and
// result are 8-word structs passed by value, which the CUDA ABI keeps in
// registers (KE5's and KE6's point layer calls mul_25519_call the same
// way).  KP2 has ~50 multiply sites in source, more once its point
// routines are inlined: with mul_p inlined at each, the kernel's code no
// longer fits the instruction cache, and KP2 ran 1.5x slower than with
// the call (tools/kp2_ab.py on an H100, PERF.md).  The multiplies mod n
// (the Fermat chain's loop, and a few more) stay inline.

#pragma once
#include <stdint.h>

#include "p256_field.cuh"

namespace p256 {

// mul_p's row of the 512-bit product: t[0..8] += ai * b[0..7], the low
// halves into t[0..7] with the carry into t[8] (t[8] <= 1 before, so it
// cannot overflow), then the high halves into t[1..8].  No carry leaves
// t[8]: after row i the product so far is < 2^(32 (i + 1)) 2^256.
__device__ __forceinline__ void ptx_mul_row(uint32_t* t, uint32_t ai,
                                            const uint32_t b[8]) {
  asm("mad.lo.cc.u32  %0, %9, %10, %0;\n\t"
      "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
      "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
      "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
      "addc.u32       %8, %8, 0;\n\t"
      "mad.hi.cc.u32  %1, %9, %10, %1;\n\t"
      "madc.hi.cc.u32 %2, %9, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.hi.cc.u32 %4, %9, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %14, %5;\n\t"
      "madc.hi.cc.u32 %6, %9, %15, %6;\n\t"
      "madc.hi.cc.u32 %7, %9, %16, %7;\n\t"
      "madc.hi.u32    %8, %9, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(ai), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]),
        "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// the CIOS row: t[0..8] += ai * b[0..7] as ptx_mul_row, with the carry
// out of t[8] written to t[9] (t < 2m before, so t + ai b < 2^289)
__device__ __forceinline__ void ptx_row(uint32_t* t, uint32_t ai,
                                        const uint32_t b[8]) {
  asm("mad.lo.cc.u32  %0, %10, %11, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.lo.cc.u32 %3, %10, %14, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %15, %4;\n\t"
      "madc.lo.cc.u32 %5, %10, %16, %5;\n\t"
      "madc.lo.cc.u32 %6, %10, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %10, %18, %7;\n\t"
      "addc.u32       %8, %8, 0;\n\t"
      "mad.hi.cc.u32  %1, %10, %11, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.hi.cc.u32 %4, %10, %14, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %15, %5;\n\t"
      "madc.hi.cc.u32 %6, %10, %16, %6;\n\t"
      "madc.hi.cc.u32 %7, %10, %17, %7;\n\t"
      "madc.hi.cc.u32 %8, %10, %18, %8;\n\t"
      "addc.u32       %9, 0, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "=r"(t[9])
      : "r"(ai), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]),
        "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// r = (hi 2^256 + t) mod m for a value in [0, 2m), hi <= 1: d = t - m
// through a borrow chain, whose last word bw = hi - borrow is 0 when
// the value is >= m and all ones when it is not
__device__ __forceinline__ void ptx_reduce(uint32_t r[8], const uint32_t t[8],
                                           uint32_t hi, const uint32_t m[8]) {
  uint32_t d[8], bw = hi;
#pragma unroll
  for (int j = 0; j < 8; ++j) d[j] = t[j];
  asm("sub.cc.u32  %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32    %8, %8, 0;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(bw)
      : "r"(m[0]), "r"(m[1]), "r"(m[2]), "r"(m[3]), "r"(m[4]), "r"(m[5]),
        "r"(m[6]), "r"(m[7]));
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = bw ? t[j] : d[j];
}

// ---------------------------------------------------------------------------
// mod p
// ---------------------------------------------------------------------------

// one reduction step at word i (t points at t_i, q = t_i): t[3] += q,
// t[6] += q, t[7..8] += q (2^32 - 1) + c_in 2^32; returns the carry out
// of t[8], which belongs at t[9] and rides the next step's high word
// (q (2^32 - 1) has high word q - 1 <= 2^32 - 2, so adding c_in is exact)
__device__ __forceinline__ uint32_t ptx_red_p(uint32_t* t, uint32_t c_in) {
  const uint32_t q = t[0];
  const uint32_t lo = 0u - q;
  const uint32_t hi = q - (q != 0u) + c_in;
  uint32_t c;
  asm("add.cc.u32  %0, %0, %7;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, %7;\n\t"
      "addc.cc.u32 %4, %4, %8;\n\t"
      "addc.cc.u32 %5, %5, %9;\n\t"
      "addc.u32    %6, 0, 0;"
      : "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8]), "=r"(c)
      : "r"(q), "r"(lo), "r"(hi));
  return c;
}

// r = a * b * 2^-256 mod p in [0, p); a < 2^256, b < p; r may alias a, b
__device__ __forceinline__ void mul_p(uint32_t r[8], const uint32_t a[8],
                                      const uint32_t b[8]) {
  const uint32_t pw[8] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0u,
                          0u,          0u,          1u,          0xFFFFFFFFu};
  uint32_t t[17];
#pragma unroll
  for (int j = 0; j < 17; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) ptx_mul_row(t + i, a[i], b);
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) c = ptx_red_p(t + i, c);
  // the product is < 2^512, so t[16] is 0; (c, t[8..15]) < 2p
  ptx_reduce(r, t + 8, c, pw);
}

// (PtxField::sqr is this square through mul_p_call)
__device__ __forceinline__ void sqr_p(uint32_t r[8], const uint32_t a[8]) {
  mul_p(r, a, a);
}

// ---------------------------------------------------------------------------
// mod p25519 = 2^255 - 19
// ---------------------------------------------------------------------------

// one reduction step at word i (t points at t_i): q = t_i 19^-1 mod 2^32
// (F25519_MINV = -p^-1 mod 2^32), so 19 q = uh 2^32 + t_i and
// t_i + q p = q 2^255 - uh 2^32.  The step adds the 8 words of
// W = q 2^223 - uh, which is >= 0 (uh > 0 only when q >= 2^32 / 19), into
// t[1..8] in one carry chain: w0 = -uh, then uh's borrow as all-ones
// words wm, then v = q 2^31 - [uh > 0] at words 6 and 7 (q << 31 and
// q >> 1 with that borrow), with c_in on top.  t_i becomes 0 and is not
// written.  Returns the carry out of t[8], which belongs at t[9] and rides
// the next step's top word (v's high word is < 2^31, so adding c_in is
// exact).
__device__ __forceinline__ uint32_t ptx_red_25519(uint32_t* t, uint32_t c_in) {
  const uint32_t q = t[0] * F25519_MINV;
  const uint32_t uh = __umulhi(q, 19u);
  const uint32_t b = uh != 0u ? 1u : 0u;
  const uint32_t w0 = 0u - uh;
  const uint32_t wm = 0u - b;
  const uint64_t v = ((uint64_t)q << 31) - b;
  const uint32_t w6 = (uint32_t)v;
  const uint32_t w7 = (uint32_t)(v >> 32) + c_in;
  uint32_t c;
  asm("add.cc.u32  %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %10;\n\t"
      "addc.cc.u32 %4, %4, %10;\n\t"
      "addc.cc.u32 %5, %5, %10;\n\t"
      "addc.cc.u32 %6, %6, %11;\n\t"
      "addc.cc.u32 %7, %7, %12;\n\t"
      "addc.u32    %8, 0, 0;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
        "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "=r"(c)
      : "r"(w0), "r"(wm), "r"(w6), "r"(w7));
  return c;
}

// r = a * b * 2^-256 mod p25519 in [0, p); a < 2^256, b < p; r may alias
// a, b.  The product as mul_p's, 8 reduction steps of ptx_red_25519 (no
// q p rows), one conditional subtraction: (c, t[8..15]) < 2p.
__device__ __forceinline__ void mul_25519(uint32_t r[8], const uint32_t a[8],
                                          const uint32_t b[8]) {
  const uint32_t pw[8] = {0xFFFFFFEDu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                          0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu};
  uint32_t t[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) ptx_mul_row(t + i, a[i], b);
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) c = ptx_red_25519(t + i, c);
  ptx_reduce(r, t + 8, c, pw);
}

// ---------------------------------------------------------------------------
// a generic modulus: P-256's n, BN254's p
// ---------------------------------------------------------------------------

// m's little-endian limbs as compile-time constants (p256_field.cuh's
// C_N and C_BN254), so that they are immediates, not loads
template <int M>
__device__ __forceinline__ uint32_t ptx_mword(int j) {
  static_assert(M == MOD_N || M == MOD_BN254,
                "mont_mul_ptx: P-256's n or BN254's p");
  if (M == MOD_N)
    return j == 0 ? 0xFC632551u : j == 1 ? 0xF3B9CAC2u
         : j == 2 ? 0xA7179E84u : j == 3 ? 0xBCE6FAADu
         : j == 4 ? 0xFFFFFFFFu : j == 5 ? 0xFFFFFFFFu
         : j == 6 ? 0x00000000u : 0xFFFFFFFFu;
  return j == 0 ? 0x00000013u : j == 1 ? 0xA7000000u
       : j == 2 ? 0x00000013u : j == 3 ? 0x61210000u
       : j == 4 ? 0x00000008u : j == 5 ? 0xBA344D80u
       : j == 6 ? 0x40000001u : 0x25236482u;
}

// t[0..9] += q * m[0..7] (t[0] becomes 0): the low halves into t[0..7]
// with the carry through t[8] into t[9], then the high halves into
// t[1..8] with the carry into t[9]
__device__ __forceinline__ void ptx_red_row(uint32_t* t, uint32_t q,
                                            const uint32_t m[8]) {
  asm("mad.lo.cc.u32  %0, %10, %11, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.lo.cc.u32 %3, %10, %14, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %15, %4;\n\t"
      "madc.lo.cc.u32 %5, %10, %16, %5;\n\t"
      "madc.lo.cc.u32 %6, %10, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %10, %18, %7;\n\t"
      "addc.cc.u32    %8, %8, 0;\n\t"
      "addc.u32       %9, %9, 0;\n\t"
      "mad.hi.cc.u32  %1, %10, %11, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.hi.cc.u32 %4, %10, %14, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %15, %5;\n\t"
      "madc.hi.cc.u32 %6, %10, %16, %6;\n\t"
      "madc.hi.cc.u32 %7, %10, %17, %7;\n\t"
      "madc.hi.cc.u32 %8, %10, %18, %8;\n\t"
      "addc.u32       %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(q), "r"(m[0]), "r"(m[1]), "r"(m[2]), "r"(m[3]), "r"(m[4]),
        "r"(m[5]), "r"(m[6]), "r"(m[7]));
}

// CIOS: r = a * b * 2^-256 mod m in [0, m); a < 2^256, b < m; r may
// alias a, b.  Each step keeps t < 2m (t[8] <= 1): (t + a_i b + q m) /
// 2^32 < (2m + (2^32 - 1) 2m) / 2^32.
template <int M>
__device__ __forceinline__ void mont_mul_ptx(uint32_t r[8],
                                             const uint32_t a[8],
                                             const uint32_t b[8]) {
  uint32_t m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = ptx_mword<M>(j);
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ptx_row(t, a[i], b);
    ptx_red_row(t, t[0] * minv<M>(), m);
#pragma unroll
    for (int j = 0; j < 9; ++j) t[j] = t[j + 1];
  }
  ptx_reduce(r, t, t[8], m);
}

// r = a^(m-2) for Montgomery a (Fermat; inv(0) = 0), p256_field.cuh's
// mont_inv on mont_mul_ptx
template <int M>
__device__ __forceinline__ void mont_inv_ptx(uint32_t r[8],
                                             const uint32_t a[8]) {
  uint32_t acc[8], x[8];
  fe_copy(x, a);
  fe_copy(acc, a);
#pragma unroll 1
  for (int i = M == MOD_BN254 ? 252 : 254; i >= 0; --i) {
    mont_mul_ptx<M>(acc, acc, acc);
    const uint32_t w = ptx_mword<M>(i >> 5) - (i < 32 ? 2u : 0u);
    if ((w >> (i & 31)) & 1u) mont_mul_ptx<M>(acc, acc, x);
  }
  fe_copy(r, acc);
}

// a value as a call's operand or result
struct fe8 {
  uint32_t w[8];
};

// mul_p as a real call, operands and result by value (in registers)
__device__ __noinline__ fe8 mul_p_call(fe8 a, fe8 b) {
  fe8 r;
  mul_p(r.w, a.w, b.w);
  return r;
}

// mul_25519 as a real call, operands and result by value (KE5's and
// KE6's one multiply: edwards_point.cuh)
__device__ __noinline__ fe8 mul_25519_call(fe8 a, fe8 b) {
  fe8 r;
  mul_25519(r.w, a.w, b.w);
  return r;
}

// The point layer's field policy (p256_point.cuh) on these routines.
struct PtxField {
  static __device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a,
                                             const uint32_t* b) {
    fe8 x, y;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x.w[j] = a[j];
      y.w[j] = b[j];
    }
    const fe8 z = mul_p_call(x, y);
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = z.w[j];
  }
  static __device__ __forceinline__ void sqr(uint32_t* r, const uint32_t* a) {
    mul(r, a, a);
  }
  static __device__ __forceinline__ void p_to_mont(uint32_t* r,
                                                   const uint32_t* a) {
    uint32_t r2[8];
    fe_copy(r2, C_P_R2);
    mul(r, a, r2);
  }
  static __device__ __forceinline__ void n_to_mont(uint32_t* r,
                                                   const uint32_t* a) {
    uint32_t r2[8];
    fe_copy(r2, C_N_R2);
    mont_mul_ptx<MOD_N>(r, a, r2);
  }
  static __device__ __forceinline__ void n_mul(uint32_t* r, const uint32_t* a,
                                               const uint32_t* b) {
    mont_mul_ptx<MOD_N>(r, a, b);
  }
  static __device__ __forceinline__ void n_inv(uint32_t* r,
                                               const uint32_t* a) {
    mont_inv_ptx<MOD_N>(r, a);
  }
};

}  // namespace p256
