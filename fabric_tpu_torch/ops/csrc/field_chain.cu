// KP1: a chain of k Montgomery multiplications per lane, mod P-256's p
// or n, mod p25519 or mod BN254's p.
//
// Replaces: the Pallas field-multiply microbenchmark of the JAX package,
// experiments/proto_pallas.py:run (a CIOS chain on (22, B) 12-bit int32
// limbs in VMEM), and launches alone the device field layer
// fabric_tpu/ops/flatfield.py:FlatMod.mul that the verify kernel
// inlines.  The variants of that benchmark (proto_pallas2.py,
// proto_pallas4.py, proto_planes.py, proto_ilp.py) are KF2,
// field_chain_variants.cu.  KP1 is not on the provider's path.
//
// Per lane: b <- b mod m, then k times t <- t * b * 2^-256 mod m from
// t = a.  With r264 set, b is first scaled by 2^248 (b * 2^248 * 2^-256
// = b * 2^-8), so that each multiply is t * b * 2^-264: the reference's
// bignum.Mont, whose R is 2^264.  2^248 is below every modulus here, so
// it is its own residue.  Inputs and output are (B, 8) uint32
// little-endian limbs, one thread per lane.
//
// Bound on the H100: the least work of a Montgomery multiply, 128 32-bit
// multiply-adds mod p, 264 mod n and BN254's p, 146 mod p25519 (see
// p256_field.cuh),
// against 64 per SM per clock; 96 bytes of traffic per lane, so the
// kernel is bound by operations for any k >= 1.  The chain is
// serial in each lane; the card hides its latency only with enough lanes
// in flight (B >= 132 SMs x 16 warps x 32 for full occupancy).

#include <cuda_runtime.h>
#include <stdint.h>

#include "p256_field.cuh"

using namespace p256;

template <int M>
__device__ __forceinline__ void chain(uint32_t t[8], uint32_t b[8], int k,
                                      int r264) {
  fe_canon<M>(b, b);
  if (r264) {
    uint32_t s[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 1u << 24};  // 2^248
    mont_mul<M>(b, b, s);
  }
  if (k == 0) {
    fe_canon<M>(t, t);
    return;
  }
#pragma unroll 1
  for (int i = 0; i < k; ++i) mont_mul<M>(t, t, b);
}

__global__ void __launch_bounds__(128)
    field_mul_chain_kernel(const uint32_t* __restrict__ a,
                           const uint32_t* __restrict__ b,
                           uint32_t* __restrict__ out, int n, int k,
                           int mod, int r264) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t t[8], bb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    t[j] = a[(size_t)i * 8 + j];
    bb[j] = b[(size_t)i * 8 + j];
  }
  if (mod == MOD_N)
    chain<MOD_N>(t, bb, k, r264);
  else if (mod == MOD_25519)
    chain<MOD_25519>(t, bb, k, r264);
  else if (mod == MOD_BN254)
    chain<MOD_BN254>(t, bb, k, r264);
  else
    chain<MOD_P>(t, bb, k, r264);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[(size_t)i * 8 + j] = t[j];
}

extern "C" int field_mul_chain_launch(const void* a, const void* b,
                                      void* out, int n, int k, int mod,
                                      int r264, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  field_mul_chain_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, k, mod,
      r264);
  return (int)cudaGetLastError();
}
