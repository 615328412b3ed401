// KE6: Ed25519 verification under device-resident keys, one signature
// per thread.
//
// Replaces: fabric_tpu/ops/ed25519.py:verify_words_rows (with edwards.py:
// comb_accumulate_rows), the fixed-key Ed25519 lane of fabric_tpu/bccsp/
// jaxtpu.py.
//
// Per signature: S < L; [S]B by the signed 7-bit comb over B's niels
// table and [k](-A) by the same comb over the table of -A in slot
// slot[i] of the bank; the complete add; Z^-1 by the Fermat chain;
// accept iff y(sum) == R.y (R.y < p) and the parity of x(sum) is R's
// sign bit.  A never reaches the device: it was decompressed once, when
// its table was built on the host, so there is no decompression and no
// ladder here.
//
// The TPU version packs signatures into an (R, C) grid whose rows share
// a key and selects table rows with one-hot f32 matmuls per row.  Here
// the batch is flat, key-major, with one int32 slot per signature: each
// thread loads row j*65 + |d| of its own key's table directly (96 B).
// Neighbouring threads mostly share a key, so their loads hit the same
// 230,880-byte table.
//
// Bound on the H100: integer multiply-adds.  The least work of a verify
// is about 73 niels adds and one complete add mod p25519 (~520 Montgomery
// multiplies), with Z^-1 batched (3 multiplies per signature, one chain
// per launch); the exact count for given S, k is fabric_tpu_torch/ops/
// ed25519.py:field_ops_per_verify_rows, weighed by ops/field.py:IMADS
// against 64 multiply-adds per SM per clock.  Each signature moves 137
// bytes plus its share of the key tables read once.  Each thread still
// runs its own Fermat chain (265 operations), which adds half again to
// the rest of its work.  Later work: a batch inversion pass, the x38
// reduction, comb rows through shared memory per key run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edwards_point.cuh"
#include "p256_point.cuh"

using namespace ed25519;

__global__ void __launch_bounds__(128) ed25519_verify_rows_kernel(
    const uint32_t* __restrict__ ryw, const int32_t* __restrict__ r_sign,
    const uint32_t* __restrict__ sw, const uint32_t* __restrict__ kw,
    const int32_t* __restrict__ slot, const uint32_t* __restrict__ bank,
    const uint32_t* __restrict__ table, uint8_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t RY[8], S[8], K[8];
  p256::load_be(RY, ryw, i, n);
  p256::load_be(S, sw, i, n);
  p256::load_be(K, kw, i, n);

  const bool s_ok = fe_lt(S, C_ED_L);

  const uint32_t* atab =
      bank + (size_t)slot[i] * (COMB_WINDOWS * COMB_ROWS * ROW_WORDS);
  Ext acc_b, acc_a;
  ext_comb(acc_b, table, S);
  ext_comb(acc_a, atab, K);
  ext_add(acc_b, acc_b, acc_a);

  out[i] = (s_ok && ed_compressed_equals(acc_b, RY, r_sign[i])) ? 1 : 0;
}

extern "C" int ed25519_verify_rows_launch(const void* ry, const void* r_sign,
                                          const void* s, const void* k,
                                          const void* slot, const void* bank,
                                          const void* table, void* out,
                                          int n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  ed25519_verify_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ry, (const int32_t*)r_sign, (const uint32_t*)s,
      (const uint32_t*)k, (const int32_t*)slot, (const uint32_t*)bank,
      (const uint32_t*)table, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}
