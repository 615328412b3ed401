// BN254 tower arithmetic for Hopper (sm_90a), one value per thread:
// Fp2 = Fp[i]/(i^2 + 1), Fp12 = Fp2[w]/(w^6 - xi) with xi = 1 + i, an
// Fp12 element being six Fp2 coefficients of w^k, as in
// fabric_tpu_torch/idemix/bn254.py.  Fp12 is also g + h w over Fp6 =
// Fp2[v]/(v^3 - xi), v = w^2, g = (c0, c2, c4), h = (c1, c3, c5), and
// a + b w + c w^2 over Fp4 = Fp2[s]/(s^2 - xi), s = w^3.
//
// Replaces: the tower of fabric_tpu/ops/bn254_batch.py (f2_mul,
// f2_mul_xi, f12_mul, f12_sqr, f12_mul_sparse013, final_exp), which
// works on (22, B) int32 planes of 12-bit limbs with R = 2^264 and lazy
// bounds, and the host's split final exponentiation
// (fabric_tpu/idemix/bn254.py: f12_inv, f12_frobenius, final_exp_hard,
// _final_exp), which the reference's device program replaces by a
// square-and-multiply over the 2,786-bit exponent.  Here every Fp value
// is 8 little-endian 32-bit limbs in Montgomery form with R = 2^256,
// fully reduced, on the shared CIOS of p256_field.cuh (MOD_BN254).
//
// Design: the least-work tower, each routine the same field element as
// its plain counterpart in ops/bn254.py (named in brackets).  Fp2
// products are Karatsuba (3 Fp multiplies), Fp2 squares 2; Fp12
// products Karatsuba over Fp6 (3 Fp6 products, 54) [f12_mul_karatsuba];
// the Miller loop's squares complex squaring over Fp6 (2 Fp6 products,
// 36) [f12_sqr_complex]; squares in the cyclotomic subgroup (the
// |u|-powers and the hard part) Granger-Scott's, three Fp4 squares of 3
// Fp2 squares (18) [f12_cyc_sqr]; a Miller step multiplies its two
// sparse lines together first (18) [lines_product] and f by that
// product in one Karatsuba with a sparse half (51) [f12_mul_by_lines];
// the Frobenius maps skip c_0's constant 1 and multiply by a constant in
// Fp as a scalar.  The easy part inverts through the tower (Fp12 -> Fp6
// -> Fp2 -> one Fermat inversion in Fp); the hard part is the
// Devegili-Scott-Dominguez chain with three |u|-powers.  The routines
// are real (non-inlined) calls on operands in local memory, which keeps
// the code, its registers and the build small; at one thread a check
// they and the additions add ~14% to the multiply's own latency
// (PERF.md).
// Still left: Karabina's compressed squares (12 Fp multiplies, with a
// decompression that needs an inversion), a batched inversion, a PTX
// carry-chain multiply for BN254's p.

#pragma once
#include <stdint.h>

#include "p256_field.cuh"

namespace bn {

using namespace p256;
constexpr int M = MOD_BN254;

struct fp2 {
  uint32_t c0[8];
  uint32_t c1[8];
};

struct fp12 {
  fp2 c[6];
};

// GAMMA[power - 1][k] = xi^(k (p^power - 1) / 6), power 1..3, Montgomery
// form: c_k of a^(p^power) is conj^power(c_k) * GAMMA[power - 1][k]
static __constant__ uint32_t C_GAMMA[3][6][2][8] = {
    0xFFFFFF8Eu, 0x15FFFFFFu, 0xFFFFFF8Au, 0xB939FFFFu, 0xFFFFFFCDu, 0xA2C62EFFu, 0x7FFFFFF5u, 0x212BA4F2u,  // GAMMA[1][0].c0
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,  // GAMMA[1][0].c1
    0x75E94F74u, 0x27283800u, 0xC79B1F6Bu, 0x144F87F9u, 0xD2C92F70u, 0xD5910FFEu, 0xE92ACF9Fu, 0x1830373Eu,  // GAMMA[1][1].c0
    0x8A16B09Fu, 0x7FD7C7FFu, 0x3864E0A8u, 0x4CD17806u, 0x2D36D098u, 0xE4A33D81u, 0x56D53061u, 0x0CF32D43u,  // GAMMA[1][1].c1
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,  // GAMMA[1][2].c0
    0xE869FD55u, 0x056EFC68u, 0x38D7BA61u, 0x1C922091u, 0x594D6466u, 0xC0651CD3u, 0xBFFFFFEFu, 0x22A87DEBu,  // GAMMA[1][2].c1
    0x71674777u, 0xFD55C5DCu, 0x56D9569Cu, 0xC45A8B4Eu, 0x2CAE2274u, 0x5F011647u, 0x1D115E0Au, 0x1AA6D99Bu,  // GAMMA[1][3].c0
    0x71674777u, 0xFD55C5DCu, 0x56D9569Cu, 0xC45A8B4Eu, 0x2CAE2274u, 0x5F011647u, 0x1D115E0Au, 0x1AA6D99Bu,  // GAMMA[1][3].c1
    0xE869FCD0u, 0x746EFC68u, 0x38D7B9D7u, 0x74AB2091u, 0x594D642Bu, 0xA8F6FE53u, 0xFFFFFFE3u, 0x1EB0BE5Bu,  // GAMMA[1][4].c0
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,  // GAMMA[1][4].c1
    0xE75096D8u, 0x7D7DFDDCu, 0x1E7475F4u, 0x77891348u, 0xFF7751DCu, 0x7A5DD8C5u, 0xC63C2DA8u, 0x0DB3AC57u,  // GAMMA[1][5].c0
    0x18AF693Bu, 0x29820223u, 0xE18B8A1Fu, 0xE997ECB7u, 0x0088AE2Bu, 0x3FD674BAu, 0x79C3D259u, 0x176FB82Au,  // GAMMA[1][5].c1
    0xFFFFFF8Eu, 0x15FFFFFFu, 0xFFFFFF8Au, 0xB939FFFFu, 0xFFFFFFCDu, 0xA2C62EFFu, 0x7FFFFFF5u, 0x212BA4F2u,  // GAMMA[2][0].c0
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,  // GAMMA[2][0].c1
    0x179602BEu, 0xA1910397u, 0xC72845B2u, 0x448EDF6Eu, 0xA6B29BA2u, 0xF9CF30ACu, 0x80000011u, 0x027AE696u,  // GAMMA[2][1].c0
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,  // GAMMA[2][1].c1
    0x17960343u, 0x32910397u, 0xC728463Cu, 0xEC75DF6Eu, 0xA6B29BDCu, 0x113D4F2Cu, 0x4000001Eu, 0x0672A626u,  // GAMMA[2][2].c0
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,  // GAMMA[2][2].c1
    0x00000085u, 0x91000000u, 0x00000089u, 0xA7E70000u, 0x0000003Au, 0x176E1E80u, 0xC000000Cu, 0x03F7BF8Fu,  // GAMMA[2][3].c0
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,  // GAMMA[2][3].c1
    0xE869FD55u, 0x056EFC68u, 0x38D7BA61u, 0x1C922091u, 0x594D6466u, 0xC0651CD3u, 0xBFFFFFEFu, 0x22A87DEBu,  // GAMMA[2][4].c0
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,  // GAMMA[2][4].c1
    0xE869FCD0u, 0x746EFC68u, 0x38D7B9D7u, 0x74AB2091u, 0x594D642Bu, 0xA8F6FE53u, 0xFFFFFFE3u, 0x1EB0BE5Bu,  // GAMMA[2][5].c0
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,  // GAMMA[2][5].c1
    0xFFFFFF8Eu, 0x15FFFFFFu, 0xFFFFFF8Au, 0xB939FFFFu, 0xFFFFFFCDu, 0xA2C62EFFu, 0x7FFFFFF5u, 0x212BA4F2u,  // GAMMA[3][0].c0
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,  // GAMMA[3][0].c1
    0x8E98B89Cu, 0xA9AA3A23u, 0xA926A976u, 0x9CC674B1u, 0xD351DD93u, 0x5B333738u, 0x22EEA1F7u, 0x0A7C8AE7u,  // GAMMA[3][1].c0
    0x71674777u, 0xFD55C5DCu, 0x56D9569Cu, 0xC45A8B4Eu, 0x2CAE2274u, 0x5F011647u, 0x1D115E0Au, 0x1AA6D99Bu,  // GAMMA[3][1].c1
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,  // GAMMA[3][2].c0
    0xFFFFFF8Eu, 0x15FFFFFFu, 0xFFFFFF8Au, 0xB939FFFFu, 0xFFFFFFCDu, 0xA2C62EFFu, 0x7FFFFFF5u, 0x212BA4F2u,  // GAMMA[3][2].c1
    0x8E98B89Cu, 0xA9AA3A23u, 0xA926A976u, 0x9CC674B1u, 0xD351DD93u, 0x5B333738u, 0x22EEA1F7u, 0x0A7C8AE7u,  // GAMMA[3][3].c0
    0x8E98B89Cu, 0xA9AA3A23u, 0xA926A976u, 0x9CC674B1u, 0xD351DD93u, 0x5B333738u, 0x22EEA1F7u, 0x0A7C8AE7u,  // GAMMA[3][3].c1
    0x00000085u, 0x91000000u, 0x00000089u, 0xA7E70000u, 0x0000003Au, 0x176E1E80u, 0xC000000Cu, 0x03F7BF8Fu,  // GAMMA[3][4].c0
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,  // GAMMA[3][4].c1
    0x71674777u, 0xFD55C5DCu, 0x56D9569Cu, 0xC45A8B4Eu, 0x2CAE2274u, 0x5F011647u, 0x1D115E0Au, 0x1AA6D99Bu,  // GAMMA[3][5].c0
    0x8E98B89Cu, 0xA9AA3A23u, 0xA926A976u, 0x9CC674B1u, 0xD351DD93u, 0x5B333738u, 0x22EEA1F7u, 0x0A7C8AE7u    // GAMMA[3][5].c1
};

// |u| = 2^62 + 2^55 + 1, the BN parameter's magnitude (u < 0)
#define BN_ABS_U 0x4080000000000001ull

// -- Fp2 ----------------------------------------------------------------------

__device__ __forceinline__ void fp2_add(fp2* r, const fp2* a, const fp2* b) {
  mod_add<M>(r->c0, a->c0, b->c0);
  mod_add<M>(r->c1, a->c1, b->c1);
}

__device__ __forceinline__ void fp2_sub(fp2* r, const fp2* a, const fp2* b) {
  mod_sub<M>(r->c0, a->c0, b->c0);
  mod_sub<M>(r->c1, a->c1, b->c1);
}

__device__ __forceinline__ void fp2_neg(fp2* r, const fp2* a) {
  const uint32_t z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  mod_sub<M>(r->c0, z, a->c0);
  mod_sub<M>(r->c1, z, a->c1);
}

__device__ __forceinline__ void fp2_zero(fp2* r) {
#pragma unroll
  for (int j = 0; j < 8; ++j) r->c0[j] = r->c1[j] = 0;
}

// r = a * (1 + i) = (c0 - c1) + (c0 + c1) i; r may alias a
__device__ __forceinline__ void fp2_mul_xi(fp2* r, const fp2* a) {
  uint32_t t[8];
  mod_sub<M>(t, a->c0, a->c1);
  mod_add<M>(r->c1, a->c0, a->c1);
  fe_copy(r->c0, t);
}

// Karatsuba; r may alias a or b
__device__ __noinline__ void fp2_mul(fp2* r, const fp2* a, const fp2* b) {
  uint32_t t0[8], t1[8], t2[8], sa[8], sb[8];
  mont_mul<M>(t0, a->c0, b->c0);
  mont_mul<M>(t1, a->c1, b->c1);
  mod_add<M>(sa, a->c0, a->c1);
  mod_add<M>(sb, b->c0, b->c1);
  mont_mul<M>(t2, sa, sb);
  mod_sub<M>(r->c0, t0, t1);
  mod_sub<M>(t2, t2, t0);
  mod_sub<M>(r->c1, t2, t1);
}

// (a0 + a1)(a0 - a1) + 2 a0 a1 i, 2 Fp multiplies [f2_sqr]; r may alias a
__device__ __noinline__ void fp2_sqr(fp2* r, const fp2* a) {
  uint32_t s[8], d[8], t[8];
  mod_add<M>(s, a->c0, a->c1);
  mod_sub<M>(d, a->c0, a->c1);
  mont_mul<M>(t, a->c0, a->c1);
  mont_mul<M>(r->c0, s, d);
  mod_add<M>(r->c1, t, t);
}

// r = a * s for s in Fp; r may alias a
__device__ __forceinline__ void fp2_mul_fp(fp2* r, const fp2* a,
                                           const uint32_t* s) {
  mont_mul<M>(r->c0, a->c0, s);
  mont_mul<M>(r->c1, a->c1, s);
}

// (a0 - a1 i) / (a0^2 + a1^2): one Fermat inversion (inv(0) = 0)
__device__ __noinline__ void fp2_inv(fp2* r, const fp2* a) {
  uint32_t t0[8], t1[8];
  mont_mul<M>(t0, a->c0, a->c0);
  mont_mul<M>(t1, a->c1, a->c1);
  mod_add<M>(t0, t0, t1);
  mont_inv<M>(t1, t0);
  fp2 b;
  mont_mul<M>(b.c0, a->c0, t1);
  mont_mul<M>(t0, a->c1, t1);
  const uint32_t z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  mod_sub<M>(b.c1, z, t0);
  *r = b;
}

// -- Fp6 = Fp2[v]/(v^3 - xi), v = w^2 -----------------------------------------

// c = a * b, Karatsuba (6 Fp2 products); c may alias a or b
// (idemix/bn254.py f6_mul)
__device__ __noinline__ void fp6_mul(fp2 c[3], const fp2 a[3],
                                     const fp2 b[3]) {
  fp2 t0, t1, t2, s, u, r0, r1;
  fp2_mul(&t0, &a[0], &b[0]);
  fp2_mul(&t1, &a[1], &b[1]);
  fp2_mul(&t2, &a[2], &b[2]);
  fp2_add(&s, &a[1], &a[2]);
  fp2_add(&u, &b[1], &b[2]);
  fp2_mul(&s, &s, &u);
  fp2_sub(&s, &s, &t1);
  fp2_sub(&s, &s, &t2);
  fp2_mul_xi(&s, &s);
  fp2_add(&r0, &t0, &s);                    // c0
  fp2_add(&s, &a[0], &a[1]);
  fp2_add(&u, &b[0], &b[1]);
  fp2_mul(&s, &s, &u);
  fp2_sub(&s, &s, &t0);
  fp2_sub(&s, &s, &t1);
  fp2_mul_xi(&u, &t2);
  fp2_add(&r1, &s, &u);                     // c1
  fp2_add(&s, &a[0], &a[2]);
  fp2_add(&u, &b[0], &b[2]);
  fp2_mul(&s, &s, &u);
  fp2_sub(&s, &s, &t0);
  fp2_sub(&s, &s, &t2);
  fp2_add(&c[2], &s, &t1);                  // c2
  c[0] = r0;
  c[1] = r1;
}

// c = a * (b0 + b1 v), b's v^2 coefficient 0 (5 Fp2 products): c0 =
// a0 b0 + xi a2 b1, c1 = a0 b1 + a1 b0, c2 = a1 b1 + a2 b0; c may alias a
__device__ __noinline__ void fp6_mul_01(fp2 c[3], const fp2 a[3],
                                        const fp2* b0, const fp2* b1) {
  fp2 t0, t1, s, u, r0, r1;
  fp2_mul(&t0, &a[0], b0);
  fp2_mul(&t1, &a[1], b1);
  fp2_add(&s, &a[1], &a[2]);
  fp2_mul(&s, &s, b1);
  fp2_sub(&s, &s, &t1);
  fp2_mul_xi(&s, &s);
  fp2_add(&r0, &s, &t0);                    // c0
  fp2_add(&s, &a[0], &a[1]);
  fp2_add(&u, b0, b1);
  fp2_mul(&s, &s, &u);
  fp2_sub(&s, &s, &t0);
  fp2_sub(&r1, &s, &t1);                    // c1
  fp2_add(&s, &a[0], &a[2]);
  fp2_mul(&s, &s, b0);
  fp2_sub(&s, &s, &t0);
  fp2_add(&c[2], &s, &t1);                  // c2
  c[0] = r0;
  c[1] = r1;
}

// r = a^-1 (idemix/bn254.py f6_inv); r may alias a
__device__ __noinline__ void fp6_inv(fp2 r[3], const fp2 a[3]) {
  fp2 t0, t1, t2, s, n;
  fp2_mul(&t0, &a[0], &a[0]);
  fp2_mul(&s, &a[1], &a[2]);
  fp2_mul_xi(&s, &s);
  fp2_sub(&t0, &t0, &s);                    // a0^2 - xi a1 a2
  fp2_mul(&t1, &a[2], &a[2]);
  fp2_mul_xi(&t1, &t1);
  fp2_mul(&s, &a[0], &a[1]);
  fp2_sub(&t1, &t1, &s);                    // xi a2^2 - a0 a1
  fp2_mul(&t2, &a[1], &a[1]);
  fp2_mul(&s, &a[0], &a[2]);
  fp2_sub(&t2, &t2, &s);                    // a1^2 - a0 a2
  fp2_mul(&n, &a[2], &t1);
  fp2_mul(&s, &a[1], &t2);
  fp2_add(&n, &n, &s);
  fp2_mul_xi(&n, &n);
  fp2_mul(&s, &a[0], &t0);
  fp2_add(&n, &n, &s);                      // the norm
  fp2_inv(&n, &n);
  fp2_mul(&r[0], &t0, &n);
  fp2_mul(&r[1], &t1, &n);
  fp2_mul(&r[2], &t2, &n);
}

// -- Fp12 ---------------------------------------------------------------------

__device__ __forceinline__ void fp12_one(fp12* r) {
#pragma unroll 1
  for (int k = 0; k < 6; ++k) fp2_zero(&r->c[k]);
  fe_copy(r->c[0].c0, C_BN254_ONE);
}

// r = gg + v hh + (ss - gg - hh) w, the end of a Karatsuba product over
// Fp6 whose three products are gg, hh and ss
__device__ __forceinline__ void fp12_karatsuba_out(fp12* r, const fp2 gg[3],
                                                   const fp2 hh[3],
                                                   const fp2 ss[3]) {
  fp2 t;
#pragma unroll 1
  for (int i = 0; i < 3; ++i) {
    fp2_sub(&t, &ss[i], &gg[i]);
    fp2_sub(&r->c[2 * i + 1], &t, &hh[i]);
  }
  fp2_mul_xi(&t, &hh[2]);
  fp2_add(&r->c[0], &gg[0], &t);
  fp2_add(&r->c[2], &gg[1], &hh[0]);
  fp2_add(&r->c[4], &gg[2], &hh[1]);
}

// Karatsuba over Fp6 (54 Fp multiplies) [f12_mul_karatsuba]; r may
// alias a or b
__device__ __noinline__ void fp12_mul(fp12* r, const fp12* a, const fp12* b) {
  fp2 g[3], h[3], s[3], u[3];
#pragma unroll 1
  for (int i = 0; i < 3; ++i) {
    g[i] = a->c[2 * i];
    h[i] = a->c[2 * i + 1];
    fp2_add(&s[i], &g[i], &h[i]);
    fp2_add(&u[i], &b->c[2 * i], &b->c[2 * i + 1]);
  }
  fp6_mul(s, s, u);                         // (g1 + h1)(g2 + h2)
#pragma unroll 1
  for (int i = 0; i < 3; ++i) u[i] = b->c[2 * i];
  fp6_mul(g, g, u);                         // g1 g2
#pragma unroll 1
  for (int i = 0; i < 3; ++i) u[i] = b->c[2 * i + 1];
  fp6_mul(h, h, u);                         // h1 h2
  fp12_karatsuba_out(r, g, h, s);
}

// complex squaring: with t = g h, a^2 = (g + h)(g + v h) - t - v t +
// 2 t w (36 Fp multiplies) [f12_sqr_complex]; r may alias a
__device__ __noinline__ void fp12_sqr(fp12* r, const fp12* a) {
  fp2 g[3], h[3], s[3], t[3], u;
#pragma unroll 1
  for (int i = 0; i < 3; ++i) {
    g[i] = a->c[2 * i];
    h[i] = a->c[2 * i + 1];
    fp2_add(&s[i], &g[i], &h[i]);
  }
  fp6_mul(t, g, h);                         // t = g h
  fp2_mul_xi(&u, &h[2]);                    // g <- g + v h
  fp2_add(&g[0], &g[0], &u);
  fp2_add(&g[1], &g[1], &h[0]);
  fp2_add(&g[2], &g[2], &h[1]);
  fp6_mul(s, s, g);                         // (g + h)(g + v h)
  fp2_mul_xi(&u, &t[2]);                    // v t = (xi t2, t0, t1)
  fp2_sub(&r->c[0], &s[0], &t[0]);
  fp2_sub(&r->c[0], &r->c[0], &u);
  fp2_sub(&r->c[2], &s[1], &t[1]);
  fp2_sub(&r->c[2], &r->c[2], &t[0]);
  fp2_sub(&r->c[4], &s[2], &t[2]);
  fp2_sub(&r->c[4], &r->c[4], &t[1]);
#pragma unroll 1
  for (int i = 0; i < 3; ++i) fp2_add(&r->c[2 * i + 1], &t[i], &t[i]);
}

// (x0 + x1 s)^2 over Fp4: x0^2 + xi x1^2 and 2 x0 x1, 3 Fp2 squares
__device__ __forceinline__ void fp4_sqr(fp2* r0, fp2* r1, const fp2* x0,
                                        const fp2* x1) {
  fp2 t0, t1, t2;
  fp2_sqr(&t0, x0);
  fp2_sqr(&t1, x1);
  fp2_add(&t2, x0, x1);
  fp2_sqr(&t2, &t2);
  fp2_sub(&t2, &t2, &t0);
  fp2_sub(r1, &t2, &t1);
  fp2_mul_xi(&t1, &t1);
  fp2_add(r0, &t0, &t1);
}

// Granger-Scott square in the cyclotomic subgroup (18 Fp multiplies)
// [f12_cyc_sqr]: with a = c0 + c3 s, b = c1 + c4 s, c = c2 + c5 s,
// z^2 = (3 a^2 - 2 conj a) + (3 s c^2 + 2 conj b) w + (3 b^2 - 2 conj c)
// w^2, conj the p^6-power (s -> -s): coefficient k is 3 x_k - 2 c_k for
// even k and 3 x_k + 2 c_k for odd k.  Wrong outside the subgroup; r may
// alias a
__device__ __noinline__ void fp12_cyc_sqr(fp12* r, const fp12* a) {
  fp2 e[3], o[3], t;
#pragma unroll 1
  for (int k = 0; k < 3; ++k) fp4_sqr(&e[k], &o[k], &a->c[k], &a->c[k + 3]);
  fp2_mul_xi(&o[2], &o[2]);                 // s c^2 at s^0
  const fp2* x[6] = {&e[0], &o[2], &e[1], &o[0], &e[2], &o[1]};
#pragma unroll 1
  for (int k = 0; k < 6; ++k) {
    if (k & 1)
      fp2_add(&t, x[k], &a->c[k]);
    else
      fp2_sub(&t, x[k], &a->c[k]);
    fp2_add(&t, &t, &t);
    fp2_add(&r->c[k], &t, x[k]);
  }
}

// l = (y1 + a1 w + b1 w^3)(y2 + a2 w + b2 w^3) for y in Fp: y1 y2 + xi b1
// b2, y1 a2 + y2 a1, a1 a2, y1 b2 + y2 b1, a1 b2 + a2 b1 (Karatsuba), 0
// (18 Fp multiplies) [lines_product]; l aliases none of the inputs
__device__ __noinline__ void lines_product(fp12* l, const uint32_t* y1,
                                           const fp2* a1, const fp2* b1,
                                           const uint32_t* y2,
                                           const fp2* a2, const fp2* b2) {
  fp2 t, u, pb;
  fp2_mul(&l->c[2], a1, a2);
  fp2_mul(&pb, b1, b2);
  fp2_add(&t, a1, b1);
  fp2_add(&u, a2, b2);
  fp2_mul(&t, &t, &u);
  fp2_sub(&t, &t, &l->c[2]);
  fp2_sub(&l->c[4], &t, &pb);
  fp2_mul_xi(&pb, &pb);
  mont_mul<M>(t.c0, y1, y2);
  mod_add<M>(l->c[0].c0, pb.c0, t.c0);
  fe_copy(l->c[0].c1, pb.c1);
  fp2_mul_fp(&t, a2, y1);
  fp2_mul_fp(&u, a1, y2);
  fp2_add(&l->c[1], &t, &u);
  fp2_mul_fp(&t, b2, y1);
  fp2_mul_fp(&u, b1, y2);
  fp2_add(&l->c[3], &t, &u);
  fp2_zero(&l->c[5]);
}

// f times a product of lines l (c5 = 0): Karatsuba over Fp6 with l's
// h = (c1, c3, 0) sparse, 6 + 5 + 6 Fp2 products (51 Fp multiplies)
// [f12_mul_by_lines]; f updated in place
__device__ __noinline__ void fp12_mul_by_lines(fp12* f, const fp12* l) {
  fp2 g[3], h[3], s[3], u[3];
#pragma unroll 1
  for (int i = 0; i < 3; ++i) {
    g[i] = f->c[2 * i];
    h[i] = f->c[2 * i + 1];
    fp2_add(&s[i], &g[i], &h[i]);
    u[i] = l->c[2 * i];
  }
  fp2_add(&u[0], &u[0], &l->c[1]);
  fp2_add(&u[1], &u[1], &l->c[3]);
  fp6_mul(s, s, u);                         // (g + h)(lg + lh)
#pragma unroll 1
  for (int i = 0; i < 3; ++i) u[i] = l->c[2 * i];
  fp6_mul(g, g, u);                         // g lg
  fp6_mul_01(h, h, &l->c[1], &l->c[3]);     // h lh
  fp12_karatsuba_out(f, g, h, s);
}

// a^(p^6): the odd powers of w negated; r may alias a
__device__ __forceinline__ void fp12_conj(fp12* r, const fp12* a) {
#pragma unroll 1
  for (int k = 0; k < 6; ++k) {
    if (k & 1)
      fp2_neg(&r->c[k], &a->c[k]);
    else
      r->c[k] = a->c[k];
  }
}

// a^(p^power), power 1..3: c_k -> conj^power(c_k) * GAMMA[k]; GAMMA[0]
// is 1, and a constant in Fp (c1 = 0: all of p^2's, p and p^3's at
// k = 4) multiplies as a scalar [f12_frobenius]; r may alias a
__device__ __noinline__ void fp12_frobenius(fp12* r, const fp12* a,
                                            int power) {
#pragma unroll 1
  for (int k = 0; k < 6; ++k) {
    fp2 c = a->c[k], g;
    if (power & 1) {
      const uint32_t z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      mod_sub<M>(c.c1, z, c.c1);
    }
    if (k == 0) {
      r->c[0] = c;
      continue;
    }
    fe_copy(g.c0, C_GAMMA[power - 1][k][0]);
    fe_copy(g.c1, C_GAMMA[power - 1][k][1]);
    if (fe_is_zero(g.c1))
      fp2_mul_fp(&r->c[k], &c, g.c0);
    else
      fp2_mul(&r->c[k], &c, &g);
  }
}

// tower inversion: a = g + h w with g, h in Fp6; (g + h w)^-1 =
// (g - h w) / (g^2 - h^2 v) (idemix/bn254.py f12_inv); r may alias a
__device__ __noinline__ void fp12_inv(fp12* r, const fp12* a) {
  fp2 g[3], h[3], d[3], hh[3];
#pragma unroll 1
  for (int i = 0; i < 3; ++i) {
    g[i] = a->c[2 * i];
    h[i] = a->c[2 * i + 1];
  }
  fp6_mul(d, g, g);
  fp6_mul(hh, h, h);
  fp2_mul_xi(&hh[2], &hh[2]);               // v * h^2 = (xi h2, h0, h1)
  fp2_sub(&d[0], &d[0], &hh[2]);
  fp2_sub(&d[1], &d[1], &hh[0]);
  fp2_sub(&d[2], &d[2], &hh[1]);
  fp6_inv(d, d);
  fp6_mul(g, g, d);
  fp6_mul(h, h, d);
#pragma unroll 1
  for (int i = 0; i < 3; ++i) {
    r->c[2 * i] = g[i];
    fp2_neg(&r->c[2 * i + 1], &h[i]);
  }
}

// r = a^u (u < 0) for a in the cyclotomic subgroup: a^|u| by
// left-to-right square-and-multiply with cyclotomic squares, then the
// conjugate, which inverts there; r may alias a
__device__ __noinline__ void fp12_pow_u(fp12* r, const fp12* a) {
  fp12 acc = *a;
#pragma unroll 1
  for (int i = 61; i >= 0; --i) {
    fp12_cyc_sqr(&acc, &acc);
    if ((BN_ABS_U >> i) & 1ull) fp12_mul(&acc, &acc, a);
  }
  fp12_conj(r, &acc);
}

// f <- f^((p^12 - 1) / r): the easy part conj(f) * f^-1 and the Frobenius
// p^2 + 1, then the Devegili-Scott-Dominguez hard part, its squares
// cyclotomic (idemix/bn254.py _final_exp, final_exp_hard)
__device__ __noinline__ void final_exp(fp12* f) {
  fp12 m, t;
  fp12_inv(&t, f);
  fp12_conj(&m, f);
  fp12_mul(&m, &m, &t);
  fp12_frobenius(&t, &m, 2);
  fp12_mul(&m, &t, &m);
  fp12 f1, f2, f3, y0, y3, y4, y6;
  fp12_pow_u(&f1, &m);
  fp12_pow_u(&f2, &f1);
  fp12_pow_u(&f3, &f2);
  fp12_frobenius(&y0, &m, 1);
  fp12_frobenius(&t, &m, 2);
  fp12_mul(&y0, &y0, &t);
  fp12_frobenius(&t, &m, 3);
  fp12_mul(&y0, &y0, &t);                   // y0
  fp12_frobenius(&y3, &f1, 1);
  fp12_conj(&y3, &y3);                      // y3
  fp12_frobenius(&t, &f2, 1);
  fp12_mul(&y4, &f1, &t);
  fp12_conj(&y4, &y4);                      // y4
  fp12_frobenius(&t, &f3, 1);
  fp12_mul(&y6, &f3, &t);
  fp12_conj(&y6, &y6);                      // y6
  fp12_conj(&f1, &f2);                      // f1 <- y5 = conj(f2)
  fp12_frobenius(&f2, &f2, 2);              // f2 <- y2
  fp12_conj(&f3, &m);                       // f3 <- y1
  fp12 t0, t1;
  fp12_cyc_sqr(&t0, &y6);
  fp12_mul(&t0, &t0, &y4);
  fp12_mul(&t0, &t0, &f1);
  fp12_mul(&t1, &y3, &f1);
  fp12_mul(&t1, &t1, &t0);
  fp12_mul(&t0, &t0, &f2);
  fp12_cyc_sqr(&t1, &t1);
  fp12_mul(&t1, &t1, &t0);
  fp12_cyc_sqr(&t1, &t1);
  fp12_mul(&t0, &t1, &f3);
  fp12_mul(&t1, &t1, &y0);
  fp12_cyc_sqr(&t0, &t0);
  fp12_mul(f, &t0, &t1);
}

// f == 1: Montgomery one at w^0, zero elsewhere
__device__ __forceinline__ bool fp12_is_one(const fp12* f) {
  bool ok = fe_eq(f->c[0].c0, C_BN254_ONE) && fe_is_zero(f->c[0].c1);
#pragma unroll 1
  for (int k = 1; k < 6; ++k)
    ok = ok && fe_is_zero(f->c[k].c0) && fe_is_zero(f->c[k].c1);
  return ok;
}

}  // namespace bn
