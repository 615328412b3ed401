// KP3: ECDSA-P256 verification under device-resident keys, one
// signature per thread.
//
// Replaces: fabric_tpu/ops/p256_fixed.py:verify_words_rows (with
// _verify_core and ecp256.py:comb_accumulate_rows), the fixed-key row
// lane of fabric_tpu/bccsp/jaxtpu.py; for one key it is also
// p256_fixed.py:verify_words_fixed.
//
// Per signature: r, s in [1, n); low-S (s < (n-1)/2 + 1) when asked;
// w = s^-1 mod n (Fermat); u1 = e*w, u2 = r*w mod n; u1*G by the 8-bit
// comb over G's (32 x 256)-entry affine table and u2*Q by the same comb
// over Q's table, which sits in slot slot[i] of the bank (digits
// LSB-first, digit 0 adds nothing); a complete add of the two; then
// X == r*Z^2 or (r + n < p and X == (r+n)*Z^2), with the result neither
// infinity nor Z == 0.  The key never reaches the device: the on-curve
// check happened once, when its table was built on the host, so there is
// no qx/qy range or curve check here.
//
// The TPU version packs signatures into an (R, C) grid whose rows share
// a key and selects table rows with one-hot f32 matmuls per row.  Here
// the batch is flat, key-major, with one int32 slot per signature: each
// thread loads row j*256 + d of its own key's table directly (64 B).
// Neighbouring threads mostly share a key, so their loads hit the same
// 512 KB table; the tables of a block's keys (67 of them, 33.5 MB) fit in
// the H100's 50 MB L2.
//
// Bound on the H100: integer multiply-adds.  The least work of a verify
// is about 62 mixed adds mod p and 6 multiplies mod n, with s^-1 batched
// (3 multiplies per signature, one Fermat chain per launch); the exact
// count for given u1, u2 is fabric_tpu_torch/ops/p256_fixed.py:
// field_ops_per_verify_rows, weighed by ops/field.py:IMADS against 64
// multiply-adds per SM per clock.  Each signature moves 101 bytes plus
// its share of the key tables read once.  The design keeps the
// per-thread state to two Jacobian points (no 16-entry table of Q as in
// KP2), so the frame stays small; it does not yet reach the bound: each
// thread runs its own Fermat chain (~425 Montgomery operations mod n,
// more than the rest of its work).  Later work: a batch (product-tree)
// inversion pass, comb rows staged through shared memory per key run,
// field_ptx.cuh's PtxField (KP2's PTX carry chains) in place of
// CiosField.

#include <cuda_runtime.h>
#include <stdint.h>

#include "p256_point.cuh"

using namespace p256;

__global__ void __launch_bounds__(128) p256_verify_rows_kernel(
    const uint32_t* __restrict__ rw, const uint32_t* __restrict__ sw,
    const uint32_t* __restrict__ ew, const int32_t* __restrict__ slot,
    const uint32_t* __restrict__ bank, const uint32_t* __restrict__ table,
    uint8_t* __restrict__ out, int n, int require_low_s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t R[8], S[8], E[8];
  load_be(R, rw, i, n);
  load_be(S, sw, i, n);
  load_be(E, ew, i, n);

  // --- range checks (p256_fixed.py:43-47) ---
  const bool r_ok = !fe_is_zero(R) && fe_lt(R, C_N);
  bool s_ok = !fe_is_zero(S) && fe_lt(S, C_N);
  if (require_low_s) s_ok = s_ok && fe_lt(S, C_HALF_N_PLUS_1);

  // --- u1 = e / s, u2 = r / s mod n ---
  uint32_t u1[8], u2[8];
  scalars<CiosField>(u1, u2, R, S, E);

  // --- two fixed-base combs: u1*G over G's table, u2*Q over Q's ---
  const uint32_t* qtab = bank + (size_t)slot[i] * (32 * 256 * 16);
  Jac acc_g, acc_q, res;
  pt_comb<CiosField>(acc_g, table, u1);
  pt_comb<CiosField>(acc_q, qtab, u2);

  // --- complete combine, then the projective x check ---
  pt_add_complete<CiosField>(res, acc_g, acc_q);
  out[i] = (r_ok && s_ok && x_matches_r<CiosField>(res, R)) ? 1 : 0;
}

extern "C" int p256_verify_rows_launch(const void* r, const void* s,
                                       const void* e, const void* slot,
                                       const void* bank, const void* table,
                                       void* out, int n, int require_low_s,
                                       void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  p256_verify_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)r, (const uint32_t*)s, (const uint32_t*)e,
      (const int32_t*)slot, (const uint32_t*)bank, (const uint32_t*)table,
      (uint8_t*)out, n, require_low_s);
  return (int)cudaGetLastError();
}
