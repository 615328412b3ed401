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
// loop (each step multiplies its two sparse lines, y at w^0, A*x at
// w^1, B at w^3, into one Fp12 with no w^5 term, then squares f on
// flagged steps and multiplies that product in; on the first step f = 1
// becomes the product); the final exponentiation by (p^12 - 1)/r, split
// as the host's (bn254_tower.cuh final_exp); f == 1.
//
// Bound on the H100: operations.  A check needs at least 18,068
// Montgomery multiplies mod BN254's p (ops/bn254.py fp_ops_per_check,
// with Karabina's compressed squares and a launch-wide batched
// inversion); this kernel issues 19,514 (fp_ops_issued, from 50,650
// before the least-work tower), each at least 264 32-bit multiply-adds
// for a generic modulus, against 64 per SM per clock.  It reads 128
// bytes of coordinates and ~35 KB of line constants that every check of
// an issuer shares (read-only path, cached).  The chain of each check is
// serial and one multiply's latency, the tower's additions and calls
// included, is ~2,500 cycles at this occupancy (PERF.md), so the time
// follows the number of multiplies in one thread's chain.
//
// Design: one thread per check on the least-work tower of
// bn254_tower.cuh; f and the tower temporaries live in local memory (an
// Fp12 is 384 bytes), the tower routines are real calls.  Still left, in
// order: more threads a check for small batches (the 36-product Fp6
// structure splits three ways), a PTX carry-chain CIOS for BN254's p, a
// batched Fp inversion across a launch, line constants staged in shared
// memory.
//
// bn254_tower_probe_launch runs one tower routine per thread on its own
// Fp12 inputs, for tests and per-routine timings; no main path calls it.

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

// the product of step s's two lines, one of each slot, each evaluated at
// its own point (x, y)
__device__ __forceinline__ void step_lines(fp12* l,
                                           const uint32_t* __restrict__ line1,
                                           const uint32_t* x1,
                                           const uint32_t* y1,
                                           const uint32_t* __restrict__ line2,
                                           const uint32_t* x2,
                                           const uint32_t* y2) {
  fp2 a1, b1, a2, b2;
  load_fp2(&a1, line1);
  load_fp2(&b1, line1 + 16);
  load_fp2(&a2, line2);
  load_fp2(&b2, line2 + 16);
  fp2_mul_fp(&a1, &a1, x1);
  fp2_mul_fp(&a2, &a2, x2);
  lines_product(l, y1, &a1, &b1, y2, &a2, &b2);
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
  fp12 f, l;
  fp12_one(&f);
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    step_lines(&l, l1 + s * step_words, px1, py1, l2 + s * step_words, px2,
               py2);
    if (s == 0) {                           // f = 1: no square, no product
      f = l;
      continue;
    }
    if (__ldg(flags + s)) fp12_sqr(&f, &f);
    fp12_mul_by_lines(&f, &l);
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

// -- the tower probe ------------------------------------------------------------
// a, b, out: (6, 2, 8, n) uint32, word j of coefficient (k, c) of input i
// at ((k * 2 + c) * 8 + j) * n + i, Montgomery form, fully reduced.  op:
// 0 mul (a b), 1 sqr (complex), 2 cyc_sqr, 3 mul_by_lines (a times the
// product of the lines y1 = b.c0.c0, A x = b.c1, B = b.c3 and y2 = b.c0.c1,
// A x = b.c2, B = b.c4), 4 pow_u (a^u), 5 final_exp.

__device__ __forceinline__ void load_fp12(fp12* r,
                                          const uint32_t* __restrict__ p,
                                          int i, int n) {
#pragma unroll 1
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      r->c[k].c0[j] = p[(size_t)((k * 2) * 8 + j) * n + i];
      r->c[k].c1[j] = p[(size_t)((k * 2 + 1) * 8 + j) * n + i];
    }
}

__global__ void __launch_bounds__(128)
    bn254_tower_probe_kernel(int op, const uint32_t* __restrict__ a,
                             const uint32_t* __restrict__ b,
                             uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fp12 x, y, l;
  load_fp12(&x, a, i, n);
  switch (op) {
    case 0:
      load_fp12(&y, b, i, n);
      fp12_mul(&x, &x, &y);
      break;
    case 1:
      fp12_sqr(&x, &x);
      break;
    case 2:
      fp12_cyc_sqr(&x, &x);
      break;
    case 3:
      load_fp12(&y, b, i, n);
      lines_product(&l, y.c[0].c0, &y.c[1], &y.c[3], y.c[0].c1, &y.c[2],
                    &y.c[4]);
      fp12_mul_by_lines(&x, &l);
      break;
    case 4:
      fp12_pow_u(&x, &x);
      break;
    default:
      final_exp(&x);
  }
#pragma unroll 1
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      out[(size_t)((k * 2) * 8 + j) * n + i] = x.c[k].c0[j];
      out[(size_t)((k * 2 + 1) * 8 + j) * n + i] = x.c[k].c1[j];
    }
}

extern "C" int bn254_tower_probe_launch(int op, const void* a, const void* b,
                                        void* out, int n, int threads,
                                        void* stream) {
  if (n <= 0) return 0;
  if (op < 0 || op > 5 || threads <= 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + threads - 1) / threads;
  bn254_tower_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      op, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
