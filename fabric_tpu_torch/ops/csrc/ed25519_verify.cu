// KE5: generic Ed25519 verification (RFC 8032, cofactorless), four lanes
// a signature.
//
// Replaces: fabric_tpu/ops/ed25519.py:verify_words (with edwards.py:
// decompress, comb_accumulate, windowed_mul, add, batch_zinv and
// compressed_equals), the generic Ed25519 lane of fabric_tpu/bccsp/
// jaxtpu.py.
//
// Per signature: S < L; A decompressed (verdict false when it does
// not); [k](-A) by the signed 4-bit window ladder over a 9-entry cached
// table of -A in shared memory; [S]B added onto it by the signed 7-bit
// comb over B's (37 x 65)-row niels table in global memory; accept iff R
// decompresses (R.y < p, a y of the curve, not x = 0 with sign 1) and
// the sum is R: X == x_R Z and Y == y_R Z.  That is the reference's
// y(sum) == R.y and parity(x(sum)) == sign: y fixes x up to its sign.
// k = SHA-512(R || A || M) mod L comes from the host.  A quad whose A
// does not decompress computes on a garbage point; nothing it computes
// reaches another quad (the reference gates its shared product-tree
// inversion on that instead).
//
// Design (edwards_point.cuh): four lanes a signature, 8 signatures a
// warp, 32 a block of 128 threads; each point operation is two steps of
// four independent multiplies, one a lane.  Lane 1 decompresses R while
// lanes 0, 2 and 3 decompress A, the same chain side by side, so the
// compare needs no inversion.  The dependent chain of a signature is
// 1,006 multiplies (decompression 277, the ladder's table 22, its 63 x 4
// doublings and 64 adds 2 each, the comb's 37 niels adds 2 each, the
// compare 1) where one thread a signature ran ~3,560.  The
// multiply is field_ptx.cuh's mul_25519 on PTX carry chains, one real
// call with operands and result in registers.  The ladder's table lives
// in shared memory, 1,156 bytes a quad, 36,992 a block.  Every thread
// reaches every shuffle: a quad past n computes on the last signature and
// writes nothing.
//
// Bound on the H100: integer multiply-adds.  The least work of a verify
// is about 3,200 Montgomery multiplies and squares mod p25519: the
// decompression chain (~275), the ladder (~250 doublings, ~60 adds) and
// the comb (~37 niels adds), with Z^-1 batched (3 multiplies per
// signature, one chain per launch); the exact count for given S, k is
// fabric_tpu_torch/ops/ed25519.py:field_ops_per_verify, weighed by
// ops/field.py:IMADS against 64 multiply-adds per SM per clock.  Each
// signature moves 137 bytes.  What still holds it back: a launch is one
// chain's latency (4,096 signatures are 128 blocks, one an SM), and the
// decompression chain (277, mostly squares) runs on every lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edwards_point.cuh"
#include "p256_point.cuh"

using namespace ed25519;

constexpr int THREADS = 128, QUADS = THREADS / 4;

__global__ void __launch_bounds__(THREADS) ed25519_verify_kernel(
    const uint32_t* __restrict__ ayw, const int32_t* __restrict__ a_sign,
    const uint32_t* __restrict__ ryw, const int32_t* __restrict__ r_sign,
    const uint32_t* __restrict__ sw, const uint32_t* __restrict__ kw,
    const uint32_t* __restrict__ table, uint8_t* __restrict__ out, int n) {
  __shared__ uint32_t tabs[QUADS * QUAD_TAB_WORDS];
  const int sig = (int)((blockIdx.x * (unsigned)THREADS + threadIdx.x) >> 2);
  const bool live = sig < n;
  const int i = live ? sig : n - 1;
  const int j = quad_lane();
  uint32_t AY[8], RY[8], S[8], K[8];
  p256::load_be(AY, ayw, i, n);
  p256::load_be(RY, ryw, i, n);
  p256::load_be(S, sw, i, n);
  p256::load_be(K, kw, i, n);

  const bool s_ok = fe_lt(S, C_ED_L);

  // --- A, and R on lane 1, from their encodings; -A = (-x, y, 1, -xy) ---
  // (inputs selected first: one call, no divergent copies of the chain)
  uint32_t DY[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) DY[k] = j == 1 ? RY[k] : AY[k];
  const Decoded d = ed_decompress(DY, j == 1 ? r_sign[i] : a_sign[i]);
  const fe ax = quad_read(d.x, 0), ay = quad_read(d.y, 0);
  const bool a_ok = __shfl_sync(0xFFFFFFFFu, d.ok, 0, 4);
  const bool r_ok = __shfl_sync(0xFFFFFFFFu, d.ok, 1, 4);
  const fe rx = quad_read(d.x, 1);                  // lane 0 takes R's x
  const fe xy = fq_mul(ax, ay);
  const fe na = j == 0 ? fq_neg(ax) : j == 1 ? ay : j == 2 ? fq_one()
                                                          : fq_neg(xy);

  // --- [k](-A) + [S]B ---
  fe acc = quad_ladder(na, K, tabs + (threadIdx.x >> 2) * QUAD_TAB_WORDS);
  acc = quad_comb(acc, table, S);

  // --- the sum against R: lane 0 x_R Z == X, lane 1 y_R Z == Y ---
  const bool eq = quad_equals_point(acc, j == 0 ? rx : d.y);
  if (live && j == 0) out[sig] = (s_ok && a_ok && r_ok && eq) ? 1 : 0;
}

extern "C" int ed25519_verify_launch(const void* ay, const void* a_sign,
                                     const void* ry, const void* r_sign,
                                     const void* s, const void* k,
                                     const void* table, void* out, int n,
                                     void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + QUADS - 1) / QUADS;
  ed25519_verify_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ay, (const int32_t*)a_sign, (const uint32_t*)ry,
      (const int32_t*)r_sign, (const uint32_t*)s, (const uint32_t*)k,
      (const uint32_t*)table, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}
