// KE6: Ed25519 verification under device-resident keys, four lanes a
// signature.
//
// Replaces: fabric_tpu/ops/ed25519.py:verify_words_rows (with edwards.py:
// comb_accumulate_rows), the fixed-key Ed25519 lane of fabric_tpu/bccsp/
// jaxtpu.py.
//
// Per signature: S < L; [S]B by the signed 7-bit comb over B's niels
// table, then [k](-A) added onto it by the same comb over the table of -A
// in slot slot[i] of the bank; Z^-1 over the block; accept iff
// y(sum) == R.y (R.y < p) and the parity of x(sum) is R's sign bit.  A
// never reaches the device: it was decompressed once, when its table was
// built on the host, so there is no decompression and no ladder here.
//
// The TPU version packs signatures into an (R, C) grid whose rows share
// a key and selects table rows with one-hot f32 matmuls per row.  Here
// the batch is flat, key-major, with one int32 slot per signature: each
// quad loads row j*65 + |d| of its own key's table directly (96 B, one
// component a lane).  Neighbouring quads mostly share a key, so their
// loads hit the same 230,880-byte table.
//
// Design (edwards_point.cuh): four lanes a signature, 8 signatures a
// warp, 32 a block of 128 threads; a niels add is two steps of four
// independent multiplies, one a lane.  Z^-1 is batched over the block by
// Montgomery's trick (quad_block_inv): a quad whose S >= L, or past n,
// brings 1; the block's product is inverted by one thread's binary
// extended Euclid, ~750 dependent 8-word ALU steps where a Fermat chain
// is 265 multiplies.  A signature's chain is 169 multiplies (the two
// combs' 74 adds 2 each, the block inversion's 19, the compare 2) plus
// that Euclid, where one thread a signature ran ~796 multiplies.  The
// multiply is field_ptx.cuh's mul_25519 on PTX carry chains, one real
// call with operands and result in registers.  Every thread reaches
// every shuffle and both barriers: a quad past n computes on the last
// signature and writes nothing.
//
// Bound on the H100: integer multiply-adds.  The least work of a verify
// is about 73 niels adds and one complete add mod p25519 (~520 Montgomery
// multiplies), with Z^-1 batched (3 multiplies per signature, one chain
// per launch); the exact count for given S, k is fabric_tpu_torch/ops/
// ed25519.py:field_ops_per_verify_rows, weighed by ops/field.py:IMADS
// against 64 multiply-adds per SM per clock.  Each signature moves 137
// bytes plus its share of the key tables read once.  What still holds it
// back: the chain's latency (each multiply a call of ~300 dependent
// instructions, with the quad's shuffles and adds between the steps) on
// a card that 9,972 signatures fill to ~2.4 warps a scheduler; later
// work: comb rows through shared memory per key run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edwards_point.cuh"
#include "p256_point.cuh"

using namespace ed25519;

constexpr int THREADS = 128, QUADS = THREADS / 4;

__global__ void __launch_bounds__(THREADS) ed25519_verify_rows_kernel(
    const uint32_t* __restrict__ ryw, const int32_t* __restrict__ r_sign,
    const uint32_t* __restrict__ sw, const uint32_t* __restrict__ kw,
    const int32_t* __restrict__ slot, const uint32_t* __restrict__ bank,
    const uint32_t* __restrict__ table, uint8_t* __restrict__ out, int n) {
  const int sig = (int)((blockIdx.x * (unsigned)THREADS + threadIdx.x) >> 2);
  const bool live = sig < n;
  const int i = live ? sig : n - 1;
  uint32_t RY[8], S[8], K[8];
  p256::load_be(RY, ryw, i, n);
  p256::load_be(S, sw, i, n);
  p256::load_be(K, kw, i, n);

  const bool s_ok = fe_lt(S, C_ED_L);

  const uint32_t* atab =
      bank + (size_t)slot[i] * (COMB_WINDOWS * COMB_ROWS * ROW_WORDS);
  fe acc = quad_comb(quad_identity(), table, S);
  acc = quad_comb(acc, atab, K);

  // --- Z^-1 over the block, then the compare ---
  const fe zi = quad_block_inv<THREADS / 32>(quad_read(acc, 2), live && s_ok);
  const bool eq = quad_compressed_equals(acc, zi, RY, r_sign[i]);
  if (live && quad_lane() == 0) out[sig] = (s_ok && eq) ? 1 : 0;
}

extern "C" int ed25519_verify_rows_launch(const void* ry, const void* r_sign,
                                          const void* s, const void* k,
                                          const void* slot, const void* bank,
                                          const void* table, void* out,
                                          int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + QUADS - 1) / QUADS;
  ed25519_verify_rows_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ry, (const int32_t*)r_sign, (const uint32_t*)s,
      (const uint32_t*)k, (const int32_t*)slot, (const uint32_t*)bank,
      (const uint32_t*)table, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}
