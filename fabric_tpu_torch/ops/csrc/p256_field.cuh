// Field layer for Hopper (sm_90a): 256-bit Montgomery arithmetic mod
// P-256's p and n, mod p25519 = 2^255 - 19 (Ed25519) and mod BN254's p
// (idemix, ~2^253.2), one value per thread.
//
// Replaces: fabric_tpu/ops/flatfield.py:FlatMod (mul, sqr, mod_add,
// mod_sub, canon, is_zero_k, eq_k, inv/pow_const, lt_const) and the limb
// layout of fabric_tpu/ops/bignum.py.  The TPU version works on (22, B)
// int32 planes of 12-bit limbs with R = 2^264 and lazy bounds (< 2p ..
// 11p), so that products stay exact in int32/f32 on the vector unit.
// Here each thread holds a value as 8 little-endian 32-bit limbs with
// R = 2^256, multiplies through 64-bit products (CIOS: Coarsely
// Integrated Operand Scanning), and keeps every value fully reduced
// (< m) after every operation.  The TPU's lazy bounds rely on R > 256p
// and would overflow here, where p is within 2^224 of R.
//
// What bounds it on the H100: integer multiply-adds, of which the card
// issues 64 per SM per clock (a 32x32->64-bit product counts as two, low
// and high half).  The least work per operation (fabric_tpu_torch/ops/
// field.py:IMADS): mod p a multiply needs its 64 limb products (128
// multiply-adds) and a square 36 (72), and the reduction none, since
// p's limbs are 0, 1 and 2^32 - 1; mod n the reduction adds 64 products
// and 8 low ones (264 for a multiply, 208 for a square); mod p25519 the
// least reduction is the fold 2^256 = 38, 9 products (146 and 90); mod
// BN254's p, a generic prime, as mod n.
// Loads and stores are a few bytes per value, so memory is not the limit.
//
// Design: mont_mul is one generic CIOS for every modulus, a real
// (non-inlined) call on operands in local memory.  That keeps the code
// small and the build to seconds; the operand traffic is L1-resident.
// Mod p it issues 2 to 3.5 times the least work: the q*p products, and
// the full product for a square.  field_ptx.cuh holds the PTX
// carry-chain multiplies (mad.lo.cc / madc.hi), p's special-form
// reduction among them, with operands in registers: KP2's field.  A
// dedicated square and the x38 fold for p25519 are later work.  Mod p25519 (m < 2^255)
// and BN254's p (m < 2^254) every value stays fully reduced all the
// same; only canon, which takes any 256-bit value, subtracts m up to
// twice (p25519) or six times (BN254: 2^256 - 1 < 7m).

#pragma once
#include <stdint.h>

namespace p256 {

enum { MOD_P = 0, MOD_N = 1, MOD_25519 = 2, MOD_BN254 = 3 };

// little-endian 32-bit limbs
static __constant__ uint32_t C_P[8] = {
    0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000001u, 0xFFFFFFFFu};
static __constant__ uint32_t C_N[8] = {
    0xFC632551u, 0xF3B9CAC2u, 0xA7179E84u, 0xBCE6FAADu,
    0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0xFFFFFFFFu};
static __constant__ uint32_t C_F25519[8] = {
    0xFFFFFFEDu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
    0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu};
static __constant__ uint32_t C_BN254[8] = {
    0x00000013u, 0xA7000000u, 0x00000013u, 0x61210000u,
    0x00000008u, 0xBA344D80u, 0x40000001u, 0x25236482u};
// R^2 mod m: to_mont(a) = mont_mul(a, R2)
static __constant__ uint32_t C_P_R2[8] = {
    0x00000003u, 0x00000000u, 0xFFFFFFFFu, 0xFFFFFFFBu,
    0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFDu, 0x00000004u};
static __constant__ uint32_t C_N_R2[8] = {
    0xBE79EEA2u, 0x83244C95u, 0x49BD6FA6u, 0x4699799Cu,
    0x2B6BEC59u, 0x2845B239u, 0xF3D95620u, 0x66E12D94u};
static __constant__ uint32_t C_F25519_R2[8] = {
    0x000005A4u, 0x00000000u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u};
static __constant__ uint32_t C_BN254_R2[8] = {
    0x5370473Du, 0xB3E88674u, 0x8C1CC3F1u, 0x55EFBF6Eu,
    0x7F86954Fu, 0x281E3A1Bu, 0xF6403A3Du, 0x1B0A32FDu};
// R mod p: Montgomery one
static __constant__ uint32_t C_P_ONE[8] = {
    0x00000001u, 0x00000000u, 0x00000000u, 0xFFFFFFFFu,
    0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFEu, 0x00000000u};
static __constant__ uint32_t C_F25519_ONE[8] = {
    0x00000026u, 0x00000000u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u};
static __constant__ uint32_t C_BN254_ONE[8] = {
    0xFFFFFF8Eu, 0x15FFFFFFu, 0xFFFFFF8Au, 0xB939FFFFu,
    0xFFFFFFCDu, 0xA2C62EFFu, 0x7FFFFFF5u, 0x212BA4F2u};
// curve coefficients a = p - 3 and b, Montgomery form mod p
static __constant__ uint32_t C_A_MONT[8] = {
    0xFFFFFFFCu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000003u,
    0x00000000u, 0x00000000u, 0x00000004u, 0xFFFFFFFCu};
static __constant__ uint32_t C_B_MONT[8] = {
    0x29C4BDDFu, 0xD89CDF62u, 0x78843090u, 0xACF005CDu,
    0xF7212ED6u, 0xE5A220ABu, 0x04874834u, 0xDC30061Du};
// (n - 1) / 2 + 1: s < this is the low-S rule
static __constant__ uint32_t C_HALF_N_PLUS_1[8] = {
    0x7E3192A9u, 0x79DCE561u, 0xD38BCF42u, 0xDE737D56u,
    0xFFFFFFFFu, 0x7FFFFFFFu, 0x80000000u, 0x7FFFFFFFu};

// -m^-1 mod 2^32
#define P256_P_MINV 0x00000001u
#define P256_N_MINV 0xEE00BC4Fu
#define F25519_MINV 0x286BCA1Bu
#define BN254_MINV 0xD79435E5u

template <int M>
__device__ __forceinline__ uint32_t mword(int j) {
  return M == MOD_P ? C_P[j]
         : M == MOD_N ? C_N[j]
         : M == MOD_25519 ? C_F25519[j]
                          : C_BN254[j];
}

template <int M>
__device__ __forceinline__ uint32_t minv() {
  return M == MOD_P ? P256_P_MINV
         : M == MOD_N ? P256_N_MINV
         : M == MOD_25519 ? F25519_MINV
                          : BN254_MINV;
}

// ---------------------------------------------------------------------------
// limb helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fe_copy(uint32_t r[8], const uint32_t a[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = a[j];
}

__device__ __forceinline__ bool fe_is_zero(const uint32_t a[8]) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc |= a[j];
  return acc == 0;
}

__device__ __forceinline__ bool fe_eq(const uint32_t a[8],
                                      const uint32_t b[8]) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc |= a[j] ^ b[j];
  return acc == 0;
}

// a < c as 256-bit integers (the borrow of a - c)
__device__ __forceinline__ bool fe_lt(const uint32_t a[8],
                                      const uint32_t c[8]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t x = (uint64_t)a[j] - c[j] - borrow;
    borrow = (uint32_t)(x >> 32) & 1u;
  }
  return borrow != 0;
}

// r = a + c as 256-bit integers; returns the carry out
__device__ __forceinline__ uint32_t fe_add_raw(uint32_t r[8],
                                               const uint32_t a[8],
                                               const uint32_t c[8]) {
  uint64_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc += (uint64_t)a[j] + c[j];
    r[j] = (uint32_t)acc;
    acc >>= 32;
  }
  return (uint32_t)acc;
}

// t (with a 257th bit `hi`) in [0, 2m) -> r = t mod m
template <int M>
__device__ __forceinline__ void reduce_once(uint32_t r[8], const uint32_t t[8],
                                            uint32_t hi) {
  uint32_t d[8];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t x = (uint64_t)t[j] - mword<M>(j) - borrow;
    d[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 32) & 1u;
  }
  const bool use_d = hi != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = use_d ? d[j] : t[j];
}

// any 256-bit value (< 2m for P-256's p and n; < 3m for p25519; < 7m
// for BN254's p) -> [0, m)
template <int M>
__device__ __forceinline__ void fe_canon(uint32_t r[8], const uint32_t a[8]) {
  reduce_once<M>(r, a, 0u);
  if (M == MOD_25519) reduce_once<M>(r, r, 0u);
  if (M == MOD_BN254) {
#pragma unroll
    for (int k = 0; k < 5; ++k) reduce_once<M>(r, r, 0u);
  }
}

// ---------------------------------------------------------------------------
// Montgomery multiply: r = a * b * 2^-256 mod m
// a < 2^256 and b < m, so a*b < m*2^256 and the CIOS sum is < 2m.
// r may alias a or b.
// ---------------------------------------------------------------------------

template <int M>
__device__ __noinline__ void mont_mul(uint32_t* r, const uint32_t* a,
                                      const uint32_t* b) {
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = 0;
  uint32_t bb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bb[j] = b[j];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t ai = a[i];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t x = (uint64_t)ai * bb[j] + t[j] + c;
      t[j] = (uint32_t)x;
      c = x >> 32;
    }
    uint64_t x = (uint64_t)t[8] + c;
    t[8] = (uint32_t)x;
    const uint32_t t9 = (uint32_t)(x >> 32);
    const uint32_t q = t[0] * minv<M>();
    x = (uint64_t)q * mword<M>(0) + t[0];
    c = x >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      x = (uint64_t)q * mword<M>(j) + t[j] + c;
      t[j - 1] = (uint32_t)x;
      c = x >> 32;
    }
    x = (uint64_t)t[8] + c;
    t[7] = (uint32_t)x;
    t[8] = t9 + (uint32_t)(x >> 32);
  }
  reduce_once<M>(r, t, t[8]);
}

template <int M>
__device__ __forceinline__ void mont_sqr(uint32_t* r, const uint32_t* a) {
  mont_mul<M>(r, a, a);
}

template <int M>
__device__ __forceinline__ void mod_add(uint32_t r[8], const uint32_t a[8],
                                        const uint32_t b[8]) {
  uint32_t s[8];
  const uint32_t hi = fe_add_raw(s, a, b);
  reduce_once<M>(r, s, hi);
}

template <int M>
__device__ __forceinline__ void mod_sub(uint32_t r[8], const uint32_t a[8],
                                        const uint32_t b[8]) {
  uint32_t d[8];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t x = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 32) & 1u;
  }
  const uint32_t mask = 0u - borrow;  // add m back when a < b
  uint64_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc += (uint64_t)d[j] + (mword<M>(j) & mask);
    r[j] = (uint32_t)acc;
    acc >>= 32;
  }
}

// any 256-bit value -> Montgomery form of (a mod m)
template <int M>
__device__ __forceinline__ void to_mont(uint32_t* r, const uint32_t* a) {
  uint32_t r2[8];
  fe_copy(r2, M == MOD_P       ? C_P_R2
              : M == MOD_N     ? C_N_R2
              : M == MOD_25519 ? C_F25519_R2
                               : C_BN254_R2);
  mont_mul<M>(r, a, r2);
}

// r = a^(m-2) for Montgomery a (Fermat inverse; inv(0) = 0):
// left-to-right binary square-and-multiply over the bits below the top
// bit of m - 2, bit 255 for P-256's p and n, 254 for p25519 and 253 for
// BN254's p (m's low limb is >= 2, so m - 2 borrows nothing)
template <int M>
__device__ __noinline__ void mont_inv(uint32_t* r, const uint32_t* a) {
  uint32_t acc[8];
  fe_copy(acc, a);
#pragma unroll 1
  for (int i = M == MOD_25519 ? 253 : M == MOD_BN254 ? 252 : 254; i >= 0;
       --i) {
    mont_sqr<M>(acc, acc);
    const uint32_t w = mword<M>(i >> 5) - (i < 32 ? 2u : 0u);
    if ((w >> (i & 31)) & 1u) mont_mul<M>(acc, acc, a);
  }
  fe_copy(r, acc);
}

}  // namespace p256
