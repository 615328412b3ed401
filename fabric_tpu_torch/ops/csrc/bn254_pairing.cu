// KB8: the batched BN254 pairing check of the idemix lane,
// e(P1_i, Q1_slot[i]) * e(P2_i, Q2) == 1, one thread per check.
//
// Replaces: fabric_tpu/ops/bn254_batch.py:pairing_check_batch (with
// miller_loop_dual, final_exp, f12_mul, f12_mul_sparse013, f2_mul), the
// JAX device program of the reference's idemix lane
// (fabric_tpu/bccsp/jaxtpu.py:_verify_idemix), which the reference
// dispatches once per issuer.  Here one launch covers every issuer of a
// batch: check i reads the line constants of slot[i] for Q1 (the
// issuer's w) and slot 0 for Q2 (g2).
//
// Inputs: flags (S,) int32, 1 where a Miller step squares f; lines
// (K, S, 2, 2, 8) uint32, [slot][step][A or B][c0 or c1] in Montgomery
// form (R = 2^256), precomputed on the host from ate_precompute; slot
// (B,) int32; x1, y1, x2, y2 (8, B) uint32, row j the j-th little-endian
// limb of a coordinate (the caller passes P2 = -Abar for the idemix
// equation e(A', w) == e(Abar, g2)).  Output: (B,) uint8 verdicts.
//
// Per check: the four coordinates into Montgomery form; the dual Miller
// loop (square f on flagged steps, multiply in both sparse lines: y at
// w^0, A*x at w^1, B at w^3); the final exponentiation by
// (p^12 - 1)/r, split as the host's (bn254_tower.cuh final_exp); f == 1.
//
// Bound on the H100: operations.  A check needs at least ~18,100
// Montgomery multiplies mod BN254's p (ops/bn254.py fp_ops_per_check;
// this kernel issues ~50,650, fp_ops_issued), each at least 264 32-bit
// multiply-adds for a generic modulus, against 64 per SM per clock; it
// reads 128 bytes of coordinates and ~35 KB of line constants that
// every check of an issuer shares (read-only path, cached).  The chain of each check is serial; at small batches the
// latency of one thread's chain is the time.
//
// Design for this first version: simple and right.  One thread per
// check; f and the tower temporaries live in local memory (an Fp12 is
// 384 bytes), the tower routines are real calls.  Later work: a
// dedicated Fp12 squaring and cyclotomic squarings in the hard part,
// one warp per check (or the 36 Fp2 products spread over threads) for
// small batches, line constants staged through shared memory, PTX carry
// chains.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_tower.cuh"

using namespace bn;

__device__ __forceinline__ void load_coord(uint32_t r[8],
                                           const uint32_t* __restrict__ c,
                                           int i, int n) {
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = c[(size_t)j * n + i];
  to_mont<M>(r, r);
}

__device__ __forceinline__ void load_fp2(fp2* r,
                                         const uint32_t* __restrict__ p) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r->c0[j] = __ldg(p + j);
    r->c1[j] = __ldg(p + 8 + j);
  }
}

// f times the line of step s of one slot, evaluated at (x, y)
__device__ __forceinline__ void line_step(fp12* f,
                                          const uint32_t* __restrict__ line,
                                          const uint32_t* x,
                                          const uint32_t* y) {
  fp2 a, b;
  load_fp2(&a, line);
  load_fp2(&b, line + 16);
  fp2_mul_fp(&a, &a, x);
  fp12_mul_line(f, y, &a, &b);
}

__global__ void __launch_bounds__(128)
    bn254_pairing_kernel(const int* __restrict__ flags,
                         const uint32_t* __restrict__ lines,
                         const int* __restrict__ slot,
                         const uint32_t* __restrict__ x1,
                         const uint32_t* __restrict__ y1,
                         const uint32_t* __restrict__ x2,
                         const uint32_t* __restrict__ y2,
                         uint8_t* __restrict__ out, int S, int K, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int q1 = slot[i];
  if (q1 < 0 || q1 >= K) {
    out[i] = 0;
    return;
  }
  uint32_t px1[8], py1[8], px2[8], py2[8];
  load_coord(px1, x1, i, n);
  load_coord(py1, y1, i, n);
  load_coord(px2, x2, i, n);
  load_coord(py2, y2, i, n);
  const size_t step_words = 2 * 2 * 8;
  const uint32_t* l1 = lines + (size_t)q1 * S * step_words;
  const uint32_t* l2 = lines;
  fp12 f;
  fp12_one(&f);
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    if (__ldg(flags + s)) fp12_mul(&f, &f, &f);
    line_step(&f, l1 + s * step_words, px1, py1);
    line_step(&f, l2 + s * step_words, px2, py2);
  }
  final_exp(&f);
  out[i] = fp12_is_one(&f) ? 1 : 0;
}

extern "C" int bn254_pairing_launch(const void* flags, const void* lines,
                                    const void* slot, const void* x1,
                                    const void* y1, const void* x2,
                                    const void* y2, void* out, int S, int K,
                                    int n, int threads, void* stream) {
  // threads: 128, the launch bound; the wrapper passes it so that a test
  // can make the card refuse a launch
  if (n <= 0) return 0;
  if (threads <= 0) return (int)cudaErrorInvalidConfiguration;
  const int blocks = (n + threads - 1) / threads;
  bn254_pairing_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)flags, (const uint32_t*)lines, (const int*)slot,
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)x2,
      (const uint32_t*)y2, (uint8_t*)out, S, K, n);
  return (int)cudaGetLastError();
}
