// KP2: generic ECDSA-P256 verification, one signature per thread.
//
// Replaces: fabric_tpu/ops/ecp256.py:verify_body (with comb_accumulate,
// add_mixed, dbl, add_nodbl, add_complete and _inv_n), the generic lane
// of fabric_tpu/bccsp/jaxtpu.py; its verdicts also equal those of the
// round-1 ladder fabric_tpu/ops/p256.py:verify_words.
//
// Per signature: r, s in [1, n); low-S (s < (n-1)/2 + 1) when asked;
// qx, qy < p and Q on the curve; w = s^-1 mod n (Fermat);
// u1 = e*w, u2 = r*w mod n; u1*G by an 8-bit fixed-base comb over the
// (32 x 256)-entry affine table of G (digits LSB-first, digit 0 adds
// nothing); u2*Q by a 4-bit window ladder over a 16-entry Jacobian table
// of Q (64 digits MSB-first); a complete add of the two; then
// X == r*Z^2 or (r + n < p and X == (r+n)*Z^2), with the result neither
// infinity nor Z == 0.  Infinity is a flag, never Z == 0.
//
// The TPU version selects comb entries with a one-hot f32 matmul on the
// MXU; here each thread loads row j*256 + d of the table directly (64 B,
// the whole 512 KB table stays in L2).  The TPU inverts s with a product
// tree across the batch; here each thread runs its own Fermat chain.
//
// Bound on the H100: integer multiply-adds.  The least work of a verify
// is about 3,530 Montgomery multiplies and squares mod p and 6 mod n,
// with s^-1 batched (3 multiplies per signature, one Fermat chain per
// launch); the exact count for given u1, u2 is fabric_tpu_torch/ops/
// p256.py:field_ops_per_verify, weighed by the least work of each
// (ops/field.py:IMADS, see p256_field.cuh) against 64 multiply-adds per
// SM per clock; each signature moves 161 bytes.
//
// Design: the point routines run on field_ptx.cuh's PtxField, with
// operands in registers: mod p the PTX carry-chain product with the
// reduction from p's special form (adds only, no q*p products), one real
// call shared by every site (its operands and result pass in registers),
// mod n a carry-chain CIOS inlined; both end fully reduced, so the adds,
// subtractions and comparisons of the point layer are unchanged.  What still holds
// it back from the bound:
//   - the 16-entry table of Q (1.5 KB a thread) lives in local memory,
//     and the ladder reads one entry a window from it;
//   - s^-1 is still one Fermat chain per thread (423 multiplies mod n),
//     not batched across the launch;
//   - one thread per signature leaves few warps per SM at block sizes
//     (40k signatures = 313 blocks of 128 on 132 SMs), and a small batch
//     is one serial chain of ~4,000 multiplies.
// The field probe (p256_field_probe_launch, below) runs mul_p, sqr_p and
// mont_mul_ptx<MOD_N> once per thread, through PtxField as KP2 calls
// them, and mul_25519 as KE5 and KE6 call it, so that each can be held
// bit for bit against the plain field on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field_ptx.cuh"
#include "p256_point.cuh"

using namespace p256;

__global__ void __launch_bounds__(128) p256_verify_kernel(
    const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
    const uint32_t* __restrict__ rw, const uint32_t* __restrict__ sw,
    const uint32_t* __restrict__ ew, const uint32_t* __restrict__ table,
    uint8_t* __restrict__ out, int n, int require_low_s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t QX[8], QY[8], R[8], S[8], E[8];
  load_be(QX, qx, i, n);
  load_be(QY, qy, i, n);
  load_be(R, rw, i, n);
  load_be(S, sw, i, n);
  load_be(E, ew, i, n);

  // --- range and key checks (ecp256.py:455-469) ---
  const bool r_ok = !fe_is_zero(R) && fe_lt(R, C_N);
  bool s_ok = !fe_is_zero(S) && fe_lt(S, C_N);
  if (require_low_s) s_ok = s_ok && fe_lt(S, C_HALF_N_PLUS_1);
  bool q_ok = fe_lt(QX, C_P) && fe_lt(QY, C_P);

  uint32_t xm[8], ym[8], lhs[8], rhs[8];
  PtxField::p_to_mont(xm, QX);
  PtxField::p_to_mont(ym, QY);
  PtxField::sqr(lhs, ym);           // y^2
  PtxField::sqr(rhs, xm);
  fp_add(rhs, rhs, C_A_MONT);
  PtxField::mul(rhs, rhs, xm);
  fp_add(rhs, rhs, C_B_MONT);       // x^3 + a x + b
  q_ok = q_ok && fe_eq(lhs, rhs);

  // --- u1 = e / s, u2 = r / s mod n ---
  uint32_t u1[8], u2[8];
  scalars<PtxField>(u1, u2, R, S, E);

  // --- u1*G: 8-bit comb, windows LSB-first, digit 0 adds nothing ---
  Jac acc_g;
  pt_comb<PtxField>(acc_g, table, u1);

  // --- u2*Q: 16-entry table, 4-bit digits MSB-first ---
  Jac T[16];
  pt_set_inf(T[0]);
  fe_copy(T[1].X, xm);
  fe_copy(T[1].Y, ym);
  fe_copy(T[1].Z, C_P_ONE);
  T[1].inf = 0;
  pt_dbl<PtxField>(T[2], T[1]);
#pragma unroll 1
  for (int k = 3; k < 16; ++k) pt_add_nodbl<PtxField>(T[k], T[k - 1], T[1]);

  Jac acc;
  pt_set_inf(acc);
#pragma unroll 1
  for (int win = 63; win >= 0; --win) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) pt_dbl<PtxField>(acc, acc);
    const uint32_t d = (u2[win >> 3] >> (4 * (win & 7))) & 0xFu;
    pt_add_nodbl<PtxField>(acc, acc, T[d]);
  }

  // --- combine (complete: u1*G == +-u2*Q is reachable), then the
  // projective x check: X == (r + k n) Z^2, k in {0, 1} ---
  Jac res;
  pt_add_complete<PtxField>(res, acc_g, acc);
  out[i] = r_ok && s_ok && q_ok && x_matches_r<PtxField>(res, R);
}

extern "C" int p256_verify_launch(const void* qx, const void* qy,
                                  const void* r, const void* s, const void* e,
                                  const void* table, void* out, int n,
                                  int require_low_s, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  p256_verify_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)qx, (const uint32_t*)qy, (const uint32_t*)r,
      (const uint32_t*)s, (const uint32_t*)e, (const uint32_t*)table,
      (uint8_t*)out, n, require_low_s);
  return (int)cudaGetLastError();
}

// -- the field probe ----------------------------------------------------------
// a, b, out: (n, 8) uint32, little-endian words of input i at i * 8 + j.
// op 0: mul_p(a, b), written over a; 1: sqr_p(a), in place; 2:
// mont_mul_ptx<MOD_N>(a, b), written over b (KP2's call sites alias the
// same ways); 3: mul_25519(a, b) through mul_25519_call, as KE5 and KE6
// call it.  Inputs must meet the routines' preconditions (a < 2^256;
// b < p, < n for op 2, < p25519 for op 3; a < p for sqr_p): the kernel
// does not check.

__global__ void __launch_bounds__(128)
    p256_field_probe_kernel(int op, const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ b,
                            uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    x[j] = a[(size_t)i * 8 + j];
    y[j] = b[(size_t)i * 8 + j];
  }
  if (op == 0) {
    PtxField::mul(x, x, y);
  } else if (op == 1) {
    PtxField::sqr(x, x);
  } else if (op == 3) {
    fe8 u, v;
    fe_copy(u.w, x);
    fe_copy(v.w, y);
    u = mul_25519_call(u, v);
    fe_copy(x, u.w);
  } else {
    PtxField::n_mul(y, x, y);
    fe_copy(x, y);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) out[(size_t)i * 8 + j] = x[j];
}

extern "C" int p256_field_probe_launch(int op, const void* a, const void* b,
                                       void* out, int n, void* stream) {
  if (n <= 0) return 0;
  if (op < 0 || op > 3) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  p256_field_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      op, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
