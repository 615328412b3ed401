// Edwards25519 point arithmetic for Hopper (sm_90a), one point per
// thread: extended coordinates, the complete add and doubling, the niels
// mixed add, the signed 7-bit comb over a niels table, the 4-bit window
// ladder, RFC 8032 decompression, the inversion chain and the
// recompression compare.  Shared by KE5 (ed25519_verify.cu) and KE6
// (ed25519_verify_rows.cu).
//
// Replaces: fabric_tpu/ops/edwards.py:add, dbl, add_niels, neg,
// comb_digits_signed, comb_accumulate, comb_accumulate_rows,
// ladder_digits, windowed_mul, decompress, batch_zinv and
// compressed_equals.  The plain PyTorch versions are in
// fabric_tpu_torch/ops/edwards.py.
//
// Values are Montgomery forms mod p = 2^255 - 19 with R = 2^256, fully
// reduced, on the CIOS field layer of p256_field.cuh (MOD_25519).  The
// reference keeps lazily reduced 22 x 12-bit limbs with R = 2^264; the
// values are the same.  The reference selects comb rows with one-hot
// f32 matmuls; here a thread loads its row (96 bytes) directly.  It
// inverts Z with a product tree over the batch; here each thread runs
// ref10's Fermat chain (254 squares, 11 multiplies).

#pragma once
#include <stdint.h>

#include "p256_field.cuh"

namespace ed25519 {

using namespace p256;

enum { COMB_WINDOWS = 37, COMB_ROWS = 65, ROW_WORDS = 24 };

// the group order L, little-endian limbs
static __constant__ uint32_t C_ED_L[8] = {
    0x5CF5D3EDu, 0x5812631Au, 0xA2F79CD6u, 0x14DEF9DEu,
    0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u};
// d, 2d and sqrt(-1), Montgomery form mod p
static __constant__ uint32_t C_ED_D_MONT[8] = {
    0xDF47E9FAu, 0x80ED8BFEu, 0xAFC62973u, 0x10A18777u,
    0xBC188690u, 0xE5939207u, 0x729FC526u, 0x2C822B5Au};
static __constant__ uint32_t C_ED_D2_MONT[8] = {
    0xBE8FD3F4u, 0x01DB17FDu, 0x5F8C52E7u, 0x21430EEFu,
    0x78310D20u, 0xCB27240Fu, 0xE53F8A4Du, 0x590456B4u};
static __constant__ uint32_t C_ED_SQRTM1_MONT[8] = {
    0xFE2BDB04u, 0x3B5807D4u, 0xB51BE9EDu, 0x03F590FDu,
    0x336202D1u, 0x6D6E16BFu, 0xD6C71BA8u, 0x75776B0Bu};

struct Ext {
  uint32_t X[8], Y[8], Z[8], T[8];
};

__device__ __forceinline__ void fq_mul(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b) {
  mont_mul<MOD_25519>(r, a, b);
}
__device__ __forceinline__ void fq_sqr(uint32_t* r, const uint32_t* a) {
  mont_mul<MOD_25519>(r, a, a);
}
__device__ __forceinline__ void fq_add(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b) {
  mod_add<MOD_25519>(r, a, b);
}
__device__ __forceinline__ void fq_sub(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b) {
  mod_sub<MOD_25519>(r, a, b);
}
__device__ __forceinline__ void fq_neg(uint32_t* r, const uint32_t* a) {
  uint32_t z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  mod_sub<MOD_25519>(r, z, a);
}
// r = a * c for a __constant__ c, copied to registers first (the
// multiply is a real call that takes generic pointers)
__device__ __forceinline__ void fq_mul_const(uint32_t* r, const uint32_t* a,
                                             const uint32_t c[8]) {
  uint32_t cc[8];
  fe_copy(cc, c);
  mont_mul<MOD_25519>(r, a, cc);
}
// Montgomery form -> canonical integer
__device__ __forceinline__ void fq_from_mont(uint32_t* r, const uint32_t* a) {
  uint32_t one[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  mont_mul<MOD_25519>(r, a, one);
}

__device__ __forceinline__ void fq_sqr_n(uint32_t* t, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) fq_sqr(t, t);
}

// t1 = z^(2^250 - 1), z11 = z^11: the head of both fixed-exponent chains
// (ref10 fe_invert / fe_pow22523; edwards.py:_pow_2_250_1)
__device__ __noinline__ void pow_2_250_1(uint32_t* t1, uint32_t* z11,
                                         const uint32_t* z) {
  uint32_t t0[8], t2[8];
  fq_sqr(t0, z);                                    // 2
  fq_sqr(t1, t0);
  fq_sqr(t1, t1);                                   // 8
  fq_mul(t1, z, t1);                                // 9
  fq_mul(z11, t0, t1);                              // 11
  fq_sqr(t0, z11);                                  // 22
  fq_mul(t1, t1, t0);                               // 2^5 - 1
  fe_copy(t0, t1);
  fq_sqr_n(t0, 5);
  fq_mul(t1, t0, t1);                               // 2^10 - 1
  fe_copy(t2, t1);
  fq_sqr_n(t2, 10);
  fq_mul(t2, t2, t1);                               // 2^20 - 1
  fe_copy(t0, t2);
  fq_sqr_n(t0, 20);
  fq_mul(t2, t0, t2);                               // 2^40 - 1
  fq_sqr_n(t2, 10);
  fq_mul(t1, t2, t1);                               // 2^50 - 1
  fe_copy(t2, t1);
  fq_sqr_n(t2, 50);
  fq_mul(t2, t2, t1);                               // 2^100 - 1
  fe_copy(t0, t2);
  fq_sqr_n(t0, 100);
  fq_mul(t2, t0, t2);                               // 2^200 - 1
  fq_sqr_n(t2, 50);
  fq_mul(t1, t2, t1);                               // 2^250 - 1
}

// r = z^(p - 2) = z^-1 (Montgomery in and out; inv(0) = 0)
__device__ __forceinline__ void fq_inv(uint32_t* r, const uint32_t* z) {
  uint32_t t[8], z11[8];
  pow_2_250_1(t, z11, z);
  fq_sqr_n(t, 5);
  fq_mul(r, t, z11);
}

// r = z^((p - 5) / 8) = z^(2^252 - 3)
__device__ __forceinline__ void fq_pow22523(uint32_t* r, const uint32_t* z) {
  uint32_t t[8], z11[8];
  pow_2_250_1(t, z11, z);
  fq_sqr_n(t, 2);
  fq_mul(r, t, z);
}

// ---------------------------------------------------------------------------
// extended-coordinate point ops (edwards.py:add, dbl, add_niels)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ext_set_identity(Ext& o) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o.X[j] = 0;
    o.T[j] = 0;
  }
  fe_copy(o.Y, C_F25519_ONE);
  fe_copy(o.Z, C_F25519_ONE);
}

__device__ __forceinline__ void ext_copy(Ext& o, const Ext& p) {
  fe_copy(o.X, p.X);
  fe_copy(o.Y, p.Y);
  fe_copy(o.Z, p.Z);
  fe_copy(o.T, p.T);
}

// (E, F, G, H) -> (EF, GH, FG, EH), the common tail of the three formulas
__device__ __forceinline__ void ext_finish(Ext& o, const uint32_t E[8],
                                           const uint32_t F[8],
                                           const uint32_t G[8],
                                           const uint32_t H[8]) {
  fq_mul(o.X, E, F);
  fq_mul(o.Y, G, H);
  fq_mul(o.Z, F, G);
  fq_mul(o.T, E, H);
}

// complete unified add (add-2008-hwcd-3, a = -1); 9 multiplies; o may
// alias p or q
__device__ __noinline__ void ext_add(Ext& o, const Ext& p, const Ext& q) {
  uint32_t A[8], B[8], C[8], Dv[8], t[8], u[8];
  fq_sub(t, p.Y, p.X);
  fq_sub(u, q.Y, q.X);
  fq_mul(A, t, u);
  fq_add(t, p.Y, p.X);
  fq_add(u, q.Y, q.X);
  fq_mul(B, t, u);
  fq_mul_const(t, p.T, C_ED_D2_MONT);
  fq_mul(C, t, q.T);
  fq_mul(t, p.Z, q.Z);
  fq_add(Dv, t, t);
  uint32_t E[8], F[8], G[8], H[8];
  fq_sub(E, B, A);
  fq_sub(F, Dv, C);
  fq_add(G, Dv, C);
  fq_add(H, B, A);
  ext_finish(o, E, F, G, H);
}

// doubling (dbl-2008-hwcd, a = -1), complete; 4 squares, 4 multiplies;
// o may alias p
__device__ __noinline__ void ext_dbl(Ext& o, const Ext& p) {
  uint32_t A[8], B[8], C[8], t[8];
  fq_sqr(A, p.X);
  fq_sqr(B, p.Y);
  fq_sqr(C, p.Z);
  fq_add(C, C, C);
  uint32_t E[8], F[8], G[8], H[8];
  fq_add(H, A, B);
  fq_add(t, p.X, p.Y);
  fq_sqr(t, t);
  fq_sub(E, H, t);
  fq_sub(G, A, B);
  fq_add(F, C, G);
  ext_finish(o, E, F, G, H);
}

// mixed add of a niels entry (y - x, y + x, 2dxy); 7 multiplies; the
// identity entry (1, 1, 0) flows through unmasked
__device__ __noinline__ void ext_add_niels(Ext& o, const uint32_t e0[8],
                                           const uint32_t e1[8],
                                           const uint32_t e2[8]) {
  uint32_t A[8], B[8], C[8], Dv[8], t[8];
  fq_sub(t, o.Y, o.X);
  fq_mul(A, t, e0);
  fq_add(t, o.Y, o.X);
  fq_mul(B, t, e1);
  fq_mul(C, o.T, e2);
  fq_add(Dv, o.Z, o.Z);
  uint32_t E[8], F[8], G[8], H[8];
  fq_sub(E, B, A);
  fq_sub(F, Dv, C);
  fq_add(G, Dv, C);
  fq_add(H, B, A);
  ext_finish(o, E, F, G, H);
}

// ---------------------------------------------------------------------------
// the signed comb (edwards.py:comb_digits_signed, comb_accumulate)
// ---------------------------------------------------------------------------

// acc = u * T over T's (37 x 65)-row niels table: window j's raw 7 bits
// plus the carry v in [0, 128]; v >= 64 gives the digit v - 128 and a
// carry into the next window (the last carry is dropped).  A negative
// digit swaps (y - x, y + x) and negates 2dxy after the lookup of row
// j*65 + |digit|; row j*65 is the identity.  u: little-endian limbs,
// any 256-bit value.
__device__ __forceinline__ void ext_comb(Ext& acc,
                                         const uint32_t* __restrict__ table,
                                         const uint32_t u[8]) {
  ext_set_identity(acc);
  uint32_t carry = 0;
#pragma unroll 1
  for (int j = 0; j < COMB_WINDOWS; ++j) {
    const int pos = 7 * j, limb = pos >> 5, off = pos & 31;
    uint32_t v = u[limb] >> off;
    if (off > 25 && limb < 7) v |= u[limb + 1] << (32 - off);
    v = (v & 0x7Fu) + carry;
    const bool neg = v >= 64u;
    carry = neg ? 1u : 0u;
    const uint32_t mag = neg ? 128u - v : v;
    const uint32_t* row = table + ((size_t)j * COMB_ROWS + mag) * ROW_WORDS;
    uint32_t e0[8], e1[8], e2[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const uint32_t a = __ldg(row + w), b = __ldg(row + 8 + w);
      e0[w] = neg ? b : a;
      e1[w] = neg ? a : b;
      e2[w] = __ldg(row + 16 + w);
    }
    if (neg) fq_neg(e2, e2);
    ext_add_niels(acc, e0, e1, e2);
  }
}

// ---------------------------------------------------------------------------
// the 4-bit window ladder (edwards.py:ladder_digits, windowed_mul)
// ---------------------------------------------------------------------------

// acc = u * Q: a 16-entry table (identity, Q, 2Q, ..., 15Q) in local
// memory, then 64 windows MSB-first of 4 doublings and one complete add
__device__ __forceinline__ void ext_ladder(Ext& acc, const Ext& q,
                                           const uint32_t u[8]) {
  Ext tab[16];
  ext_set_identity(tab[0]);
  ext_copy(tab[1], q);
  ext_dbl(tab[2], q);
#pragma unroll 1
  for (int e = 3; e < 16; ++e) ext_add(tab[e], tab[e - 1], q);
  ext_set_identity(acc);
#pragma unroll 1
  for (int w = 63; w >= 0; --w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) ext_dbl(acc, acc);
    const uint32_t d = (u[w >> 3] >> (4 * (w & 7))) & 0xFu;
    ext_add(acc, acc, tab[d]);
  }
}

// ---------------------------------------------------------------------------
// decompression and the recompression compare
// ---------------------------------------------------------------------------

// RFC 8032 5.1.3 (edwards.py:decompress): y canonical integer limbs
// (< 2^255), sign 0/1 -> x_m, y_m Montgomery; returns ok.  ok is false
// for y >= p, a y with no x, or x = 0 with sign 1; the point is then
// garbage and the caller's verdict false.
__device__ __noinline__ bool ed_decompress(uint32_t x[8], uint32_t y_m[8],
                                           const uint32_t y[8], int sign) {
  const bool y_ok = fe_lt(y, C_F25519);
  to_mont<MOD_25519>(y_m, y);
  uint32_t y2[8], u[8], v[8], v3[8], t[8], pw[8];
  fq_sqr(y2, y_m);
  fq_sub(u, y2, C_F25519_ONE);                      // y^2 - 1
  fq_mul_const(t, y2, C_ED_D_MONT);
  fq_add(v, t, C_F25519_ONE);                       // d y^2 + 1
  fq_sqr(t, v);
  fq_mul(v3, t, v);                                 // v^3
  fq_sqr(t, v3);
  fq_mul(t, t, v);                                  // v^7
  fq_mul(t, u, t);                                  // u v^7
  fq_pow22523(pw, t);
  fq_mul(t, u, v3);
  fq_mul(x, t, pw);                                 // u v^3 (u v^7)^((p-5)/8)
  fq_sqr(t, x);
  fq_mul(t, v, t);                                  // v x^2
  const bool root_ok = fe_eq(t, u);
  uint32_t nu[8];
  fq_neg(nu, u);
  const bool root_neg = fe_eq(t, nu);
  if (root_neg) fq_mul_const(x, x, C_ED_SQRTM1_MONT);
  bool ok = y_ok && (root_ok || root_neg);
  uint32_t xc[8];
  fq_from_mont(xc, x);
  const bool x_zero = fe_is_zero(xc);
  ok = ok && !(x_zero && sign == 1);
  if ((int)(xc[0] & 1u) != sign && !x_zero) fq_neg(x, x);
  return ok;
}

// does the point equal the encoding (y, sign)?  (edwards.py:
// compressed_equals) y: canonical integer limbs; y >= p never matches,
// nor sign 1 with x = 0.
__device__ __noinline__ bool ed_compressed_equals(const Ext& p,
                                                  const uint32_t y[8],
                                                  int sign) {
  uint32_t zi[8], xa[8], ya[8];
  fq_inv(zi, p.Z);
  fq_mul(xa, p.X, zi);
  fq_from_mont(xa, xa);
  fq_mul(ya, p.Y, zi);
  fq_from_mont(ya, ya);
  return fe_lt(y, C_F25519) && fe_eq(ya, y) && (int)(xa[0] & 1u) == sign;
}

}  // namespace ed25519
