// KE5: generic Ed25519 verification (RFC 8032, cofactorless), one
// signature per thread.
//
// Replaces: fabric_tpu/ops/ed25519.py:verify_words (with edwards.py:
// decompress, comb_accumulate, windowed_mul, add, batch_zinv and
// compressed_equals), the generic Ed25519 lane of fabric_tpu/bccsp/
// jaxtpu.py.
//
// Per signature: S < L; A decompressed (verdict false when it does
// not); [S]B by the signed 7-bit comb over B's (37 x 65)-row niels
// table in global memory; [k](-A) by the 4-bit window ladder over a
// 16-entry table of -A in local memory; the complete add of the two;
// Z^-1 by the Fermat chain; accept iff y(sum) == R.y (R.y < p) and the
// parity of x(sum) is R's sign bit.  k = SHA-512(R || A || M) mod L
// comes from the host.  A lane whose A does not decompress computes on
// a garbage point; nothing it computes reaches another lane (the
// reference gates its shared product-tree inversion on that instead).
//
// Bound on the H100: integer multiply-adds.  The least work of a verify
// is about 3,200 Montgomery multiplies and squares mod p25519: the
// decompression chain (~275), the ladder (~250 doublings, ~60 adds) and
// the comb (~37 niels adds), with Z^-1 batched (3 multiplies per
// signature, one chain per launch); the exact count for given S, k is
// fabric_tpu_torch/ops/ed25519.py:field_ops_per_verify, weighed by
// ops/field.py:IMADS against 64 multiply-adds per SM per clock.  Each
// signature moves 137 bytes.  The design is the simple one: one
// dependent chain of non-inlined CIOS multiplies per thread, so a
// launch takes about one chain's latency until the card is full.
// Later work: a batch inversion pass, the x38 reduction, comb rows
// through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edwards_point.cuh"
#include "p256_point.cuh"

using namespace ed25519;

__global__ void __launch_bounds__(128) ed25519_verify_kernel(
    const uint32_t* __restrict__ ayw, const int32_t* __restrict__ a_sign,
    const uint32_t* __restrict__ ryw, const int32_t* __restrict__ r_sign,
    const uint32_t* __restrict__ sw, const uint32_t* __restrict__ kw,
    const uint32_t* __restrict__ table, uint8_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t AY[8], RY[8], S[8], K[8];
  p256::load_be(AY, ayw, i, n);
  p256::load_be(RY, ryw, i, n);
  p256::load_be(S, sw, i, n);
  p256::load_be(K, kw, i, n);

  const bool s_ok = fe_lt(S, C_ED_L);

  // --- -A from its encoding (ed25519.py:63-64) ---
  Ext na;
  const bool a_ok = ed_decompress(na.X, na.Y, AY, a_sign[i]);
  fq_mul(na.T, na.X, na.Y);
  fq_neg(na.X, na.X);
  fq_neg(na.T, na.T);
  fe_copy(na.Z, C_F25519_ONE);

  // --- [S]B + [k](-A) ---
  Ext acc_b, acc_a;
  ext_comb(acc_b, table, S);
  ext_ladder(acc_a, na, K);
  ext_add(acc_b, acc_b, acc_a);

  out[i] = (s_ok && a_ok && ed_compressed_equals(acc_b, RY, r_sign[i]))
               ? 1 : 0;
}

extern "C" int ed25519_verify_launch(const void* ay, const void* a_sign,
                                     const void* ry, const void* r_sign,
                                     const void* s, const void* k,
                                     const void* table, void* out, int n,
                                     void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  ed25519_verify_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ay, (const int32_t*)a_sign, (const uint32_t*)ry,
      (const int32_t*)r_sign, (const uint32_t*)s, (const uint32_t*)k,
      (const uint32_t*)table, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}
