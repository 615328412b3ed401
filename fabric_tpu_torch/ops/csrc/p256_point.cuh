// P-256 point arithmetic for Hopper (sm_90a), one point per thread: the
// Jacobian point type, doubling, the adds, the comb
// accumulation over a fixed-base table and the big-endian word loader.
// Shared by KP2 (p256_verify.cu) and KP3 (p256_verify_rows.cu), both on
// field_ptx.cuh's PtxField; every routine that multiplies takes the
// field as its template parameter F.  No kernel multiplies through
// p256_field.cuh's generic CIOS here any more; that header stays for
// the adds and subtractions below and for KP1, KE5, KE6 and KB8.
//
// Replaces: fabric_tpu/ops/ecp256.py:dbl, add_nodbl, add_complete,
// add_mixed and comb_accumulate.  Infinity is a flag, never Z == 0.

#pragma once
#include <stdint.h>

#include "p256_field.cuh"

namespace p256 {

struct Jac {
  uint32_t X[8], Y[8], Z[8];
  int inf;
};

// The field a point routine computes in, its template parameter F:
// F::mul(r, a, b) and F::sqr(r, a) mod p (a < 2^256, b < p), F::p_to_mont
// (any 256-bit a), and mod n F::n_to_mont, F::n_mul and F::n_inv (the
// scalars): field_ptx.cuh's PtxField, operands in registers.  Adds and
// subtractions are p256_field.cuh's.

__device__ __forceinline__ void fp_add(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b) {
  mod_add<MOD_P>(r, a, b);
}
__device__ __forceinline__ void fp_sub(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b) {
  mod_sub<MOD_P>(r, a, b);
}

__device__ __forceinline__ void pt_set_inf(Jac& o) {
  fe_copy(o.X, C_P_ONE);
  fe_copy(o.Y, C_P_ONE);
  fe_copy(o.Z, C_P_ONE);
  o.inf = 1;
}

__device__ __forceinline__ void pt_copy(Jac& o, const Jac& p) {
  fe_copy(o.X, p.X);
  fe_copy(o.Y, p.Y);
  fe_copy(o.Z, p.Z);
  o.inf = p.inf;
}

// Jacobian doubling, dbl-2001-b with a = -3 (ecp256.py:dbl); 8 mont_muls.
// o may alias p.  Infinity stays infinity.
template <class F>
__device__ __forceinline__ void pt_dbl(Jac& o, const Jac& p) {
  if (p.inf) {
    pt_copy(o, p);
    return;
  }
  uint32_t delta[8], gamma[8], beta[8], alpha[8], t[8], u[8];
  uint32_t b4[8], b8[8], X3[8], Y3[8], Z3[8];
  F::sqr(delta, p.Z);
  F::sqr(gamma, p.Y);
  F::mul(beta, p.X, gamma);
  fp_sub(t, p.X, delta);
  fp_add(u, p.X, delta);
  F::mul(alpha, t, u);
  fp_add(t, alpha, alpha);
  fp_add(alpha, t, alpha);          // 3 (X - delta)(X + delta)
  fp_add(b4, beta, beta);
  fp_add(b4, b4, b4);               // 4 beta
  fp_add(b8, b4, b4);               // 8 beta
  F::sqr(X3, alpha);
  fp_sub(X3, X3, b8);               // alpha^2 - 8 beta
  fp_add(t, p.Y, p.Z);
  F::sqr(Z3, t);
  fp_sub(Z3, Z3, gamma);
  fp_sub(Z3, Z3, delta);            // (Y + Z)^2 - gamma - delta
  fp_sub(t, b4, X3);
  F::mul(Y3, alpha, t);
  fp_add(u, gamma, gamma);
  fp_add(u, u, u);
  fp_add(u, u, u);                  // 8 gamma
  F::mul(t, gamma, u);
  fp_sub(Y3, Y3, t);                // alpha (4 beta - X3) - 8 gamma^2
  fe_copy(o.X, X3);
  fe_copy(o.Y, Y3);
  fe_copy(o.Z, Z3);
  o.inf = 0;
}

// The shared body of add_nodbl / add_complete for finite P, Q: 16
// mont_muls.  Returns h == 0 in *h_zero and r == 0 in *r_zero.
template <class F>
__device__ __forceinline__ void pt_add_body(uint32_t X3[8], uint32_t Y3[8],
                                            uint32_t Z3[8], const Jac& p,
                                            const Jac& q, bool* h_zero,
                                            bool* r_zero) {
  uint32_t z1z1[8], z2z2[8], u1[8], u2[8], s1[8], s2[8], t[8];
  uint32_t h[8], r[8], h2[8], h3[8], u1h2[8];
  F::sqr(z1z1, p.Z);
  F::sqr(z2z2, q.Z);
  F::mul(u1, p.X, z2z2);
  F::mul(u2, q.X, z1z1);
  F::mul(t, q.Z, z2z2);
  F::mul(s1, p.Y, t);
  F::mul(t, p.Z, z1z1);
  F::mul(s2, q.Y, t);
  fp_sub(h, u2, u1);
  fp_sub(r, s2, s1);
  *h_zero = fe_is_zero(h);
  *r_zero = fe_is_zero(r);
  F::sqr(h2, h);
  F::mul(h3, h, h2);
  F::mul(u1h2, u1, h2);
  F::sqr(X3, r);
  fp_sub(X3, X3, h3);
  fp_sub(X3, X3, u1h2);
  fp_sub(X3, X3, u1h2);             // r^2 - h^3 - 2 u1 h^2
  fp_sub(t, u1h2, X3);
  F::mul(Y3, r, t);
  F::mul(t, s1, h3);
  fp_sub(Y3, Y3, t);                // r (u1 h^2 - X3) - s1 h^3
  F::mul(t, p.Z, q.Z);
  F::mul(Z3, t, h);                 // Z1 Z2 h
}

// Add without the doubling case (ecp256.py:add_nodbl): infinity
// operands by flag; h == 0 (P == -Q, or P == Q, which the ladder cannot
// reach for an on-curve Q) gives infinity.  o may alias p or q.
template <class F>
__device__ __forceinline__ void pt_add_nodbl(Jac& o, const Jac& p,
                                             const Jac& q) {
  if (p.inf) {
    pt_copy(o, q);
    return;
  }
  if (q.inf) {
    pt_copy(o, p);
    return;
  }
  uint32_t X3[8], Y3[8], Z3[8];
  bool h_zero, r_zero;
  pt_add_body<F>(X3, Y3, Z3, p, q, &h_zero, &r_zero);
  fe_copy(o.X, X3);
  fe_copy(o.Y, Y3);
  fe_copy(o.Z, Z3);
  o.inf = h_zero ? 1 : 0;
}

// Fully complete add (ecp256.py:add_complete): P == Q doubles.
template <class F>
__device__ __forceinline__ void pt_add_complete(Jac& o, const Jac& p,
                                                const Jac& q) {
  if (p.inf) {
    pt_copy(o, q);
    return;
  }
  if (q.inf) {
    pt_copy(o, p);
    return;
  }
  uint32_t X3[8], Y3[8], Z3[8];
  bool h_zero, r_zero;
  pt_add_body<F>(X3, Y3, Z3, p, q, &h_zero, &r_zero);
  if (h_zero && r_zero) {
    pt_dbl<F>(o, q);
    return;
  }
  fe_copy(o.X, X3);
  fe_copy(o.Y, Y3);
  fe_copy(o.Z, Z3);
  o.inf = h_zero ? 1 : 0;
}

// Mixed add of an affine comb entry (ecp256.py:add_mixed); 11 mont_muls.
// The comb never meets P == +-Q (u < n), so there is no patch for it.
template <class F>
__device__ __forceinline__ void pt_add_mixed(Jac& o, const uint32_t x2[8],
                                             const uint32_t y2[8]) {
  if (o.inf) {
    fe_copy(o.X, x2);
    fe_copy(o.Y, y2);
    fe_copy(o.Z, C_P_ONE);
    o.inf = 0;
    return;
  }
  uint32_t z1z1[8], u2[8], s2[8], t[8], h[8], r[8], h2[8], h3[8];
  uint32_t u1h2[8], X3[8], Y3[8];
  F::sqr(z1z1, o.Z);
  F::mul(u2, x2, z1z1);
  F::mul(t, o.Z, z1z1);
  F::mul(s2, y2, t);
  fp_sub(h, u2, o.X);
  fp_sub(r, s2, o.Y);
  F::sqr(h2, h);
  F::mul(h3, h, h2);
  F::mul(u1h2, o.X, h2);
  F::sqr(X3, r);
  fp_sub(X3, X3, h3);
  fp_sub(X3, X3, u1h2);
  fp_sub(X3, X3, u1h2);
  fp_sub(t, u1h2, X3);
  F::mul(Y3, r, t);
  F::mul(t, o.Y, h3);
  fp_sub(Y3, Y3, t);
  F::mul(o.Z, o.Z, h);
  fe_copy(o.X, X3);
  fe_copy(o.Y, Y3);
}

// acc = u * T over T's (32 x 256)-entry affine comb table (ecp256.py:
// comb_accumulate): 8-bit digits LSB-first, digit d of window j reads
// row j*256 + d (x in words 0..7, y in 8..15, Montgomery little-endian
// limbs), digit 0 adds nothing.  u < n, canonical.
template <class F>
__device__ __forceinline__ void pt_comb(Jac& acc,
                                        const uint32_t* __restrict__ table,
                                        const uint32_t u[8]) {
  pt_set_inf(acc);
#pragma unroll 1
  for (int j = 0; j < 32; ++j) {
    const uint32_t d = (u[j >> 2] >> (8 * (j & 3))) & 0xFFu;
    if (d) {
      const uint32_t* row = table + ((size_t)j * 256 + d) * 16;
      uint32_t x2[8], y2[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        x2[k] = __ldg(row + k);
        y2[k] = __ldg(row + 8 + k);
      }
      pt_add_mixed<F>(acc, x2, y2);
    }
  }
}

// (8, n) big-endian words, word 0 most significant -> little-endian limbs
__device__ __forceinline__ void load_be(uint32_t r[8],
                                        const uint32_t* __restrict__ w,
                                        int i, int n) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r[7 - k] = w[(size_t)k * n + i];
}

// The projective x check of ECDSA (ecp256.py:verify_body): the sum is
// finite with Z != 0 and X == r Z^2, or r + n < p and X == (r + n) Z^2
// (R: r's limbs; the caller's range check rejects r >= n).
template <class F>
__device__ __forceinline__ bool x_matches_r(const Jac& res,
                                            const uint32_t R[8]) {
  const bool nonzero = !res.inf && !fe_is_zero(res.Z);
  uint32_t z2[8], rm[8], t[8], rn[8];
  F::sqr(z2, res.Z);
  F::p_to_mont(rm, R);
  F::mul(t, rm, z2);
  const bool eq1 = fe_eq(res.X, t);
  const uint32_t carry = fe_add_raw(rn, R, C_N);
  const bool rn_lt_p = carry == 0 && fe_lt(rn, C_P);
  F::p_to_mont(rm, rn);
  F::mul(t, rm, z2);
  const bool eq2 = rn_lt_p && fe_eq(res.X, t);
  return nonzero && (eq1 || eq2);
}

// w = s^-1, u1 = e w, u2 = r w mod n, canonical (e any 256-bit value)
template <class F>
__device__ __forceinline__ void scalars(uint32_t u1[8], uint32_t u2[8],
                                        const uint32_t R[8],
                                        const uint32_t S[8],
                                        const uint32_t E[8]) {
  uint32_t w[8];
  F::n_to_mont(w, S);
  F::n_inv(w, w);                   // Montgomery form of s^-1
  F::n_mul(u1, E, w);               // e * s^-1 (plain, canonical)
  F::n_mul(u2, R, w);
}

}  // namespace p256
