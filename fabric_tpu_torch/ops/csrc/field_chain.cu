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
// little-endian limbs.  Every multiply reduces fully; the output is
// canonical.
//
// Bound on the H100: the least work of a Montgomery multiply, 128 32-bit
// multiply-adds mod p, 264 mod n and BN254's p, 146 mod p25519 (see
// p256_field.cuh), against 64 per SM per clock; 96 bytes of traffic per
// lane, so the kernel is bound by operations for any k >= 1.  The chain
// is serial in each lane, so the card hides a multiply's latency only
// with enough threads in flight.
//
// Design: TPI threads a lane, chosen by the launcher
// (fabric_tpu_torch/ops/field.py group_plan, from the lane count and the
// card's SM count):
//   TPI = 1  where one thread a lane fills the card (SMs x 2,048 lanes):
//            kp1_thread_kernel, field_ptx.cuh's in-register multiplies
//            (mul_p, mont_mul_ptx<M>, mul_25519), each with its least-work
//            reduction.
//   TPI = 4  below that: kp1_group_kernel, field_group.cuh's group
//            multiply, each modulus with its least-work reduction; b's 8
//            words are gathered once into every thread of the group, a's
//            limbs stay distributed, 2 a thread.  The header's TPI = 8 is
//            not instantiated: at the reference's 16,384 lanes 4 beat it
//            for every modulus (PERF.md §6).  Nor does the group beat one
//            thread there: with TPI forced to 1, KP1 ran faster at 16,384
//            lanes for all four moduli (mod p 0.1313 against 0.1572 ms,
//            tools/field_ab.py on an H100), so the rule's group buys KP1
//            nothing yet (ROADMAP B11).
// The operands stay in registers (ptxas: frame 0, spills 0).

#include <cuda_runtime.h>
#include <stdint.h>

#include "field_group.cuh"
#include "field_ptx.cuh"

using namespace p256;

// 2^248, the residue that maps R = 2^256 onto the reference's 2^264
__device__ __forceinline__ void scale_words(uint32_t s[8]) {
#pragma unroll
  for (int j = 0; j < 7; ++j) s[j] = 0u;
  s[7] = 1u << 24;
}

// one thread's multiply: field_ptx.cuh's routine for modulus M
template <int M>
__device__ __forceinline__ void mul1(uint32_t r[8], const uint32_t a[8],
                                     const uint32_t b[8]) {
  if constexpr (M == MOD_P)
    mul_p(r, a, b);
  else if constexpr (M == MOD_25519)
    mul_25519(r, a, b);
  else
    mont_mul_ptx<M>(r, a, b);
}

template <int M>
__global__ void __launch_bounds__(128)
    kp1_thread_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ b,
                      uint32_t* __restrict__ out, int n, int k, int r264) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t t[8], bb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    t[j] = a[(size_t)i * 8 + j];
    bb[j] = b[(size_t)i * 8 + j];
  }
  fe_canon<M>(bb, bb);
  if (r264) {
    uint32_t s[8];
    scale_words(s);
    mul1<M>(bb, bb, s);
  }
  if (k == 0) {
    fe_canon<M>(t, t);
  } else {
#pragma unroll 1
    for (int c = 0; c < k; ++c) mul1<M>(t, t, bb);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) out[(size_t)i * 8 + j] = t[j];
}

template <int M, int TPI>
__global__ void __launch_bounds__(128)
    kp1_group_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     uint32_t* __restrict__ out, int n, int k, int r264) {
  constexpr int L = 8 / TPI;
  constexpr int RED = fgroup::least_red<M>::value;
  const int th = blockIdx.x * blockDim.x + threadIdx.x;
  if ((th & ~31) / TPI >= n) return;   // the whole warp is past the end
  const bool live = th / TPI < n;      // else: repeat the last lane
  const int i = live ? th / TPI : n - 1;
  const fgroup::Group<TPI> g;
  const fgroup::GroupMod<TPI> gm = fgroup::group_mod<TPI, M, RED>(g);
  uint32_t bw[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bw[j] = b[(size_t)i * 8 + j];
  fe_canon<M>(bw, bw);
  if (r264) {
    uint32_t s[8], bl[L];
    scale_words(s);
    fgroup::group_own<TPI>(bl, bw, g);
    fgroup::group_mul<TPI, M, RED, false>(bl, bl, s, g, gm);
    fgroup::group_gather<TPI>(bw, bl, g);
  }
  uint32_t t[L];
  if (k == 0) {
    uint32_t aw[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) aw[j] = a[(size_t)i * 8 + j];
    fe_canon<M>(aw, aw);
    fgroup::group_own<TPI>(t, aw, g);
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) t[l] = a[(size_t)i * 8 + g.rank * L + l];
#pragma unroll 1
    for (int c = 0; c < k; ++c)
      fgroup::group_mul<TPI, M, RED, false>(t, t, bw, g, gm);
  }
  if (live) {
#pragma unroll
    for (int l = 0; l < L; ++l) out[(size_t)i * 8 + g.rank * L + l] = t[l];
  }
}

typedef void (*kernel_fn)(const uint32_t*, const uint32_t*, uint32_t*, int,
                          int, int);

template <int M>
kernel_fn pick(int tpi) {
  return tpi == 1 ? kp1_thread_kernel<M>
         : tpi == 4 ? kp1_group_kernel<M, 4>
                    : nullptr;
}

kernel_fn kernel(int mod, int tpi) {
  return mod == MOD_N       ? pick<MOD_N>(tpi)
         : mod == MOD_25519 ? pick<MOD_25519>(tpi)
         : mod == MOD_BN254 ? pick<MOD_BN254>(tpi)
         : mod == MOD_P     ? pick<MOD_P>(tpi)
                            : nullptr;
}

// Launch on n lanes with tpi threads a lane (1 or 4) and `threads`
// threads a block (a multiple of 32, at most 128: the launch bounds).
// Returns the CUDA error of the launch, or -1 for an unknown modulus or
// tpi.
extern "C" int field_mul_chain_group_launch(const void* a, const void* b,
                                            void* out, int n, int k,
                                            int mod, int r264, int tpi,
                                            int threads, void* stream) {
  const kernel_fn fn = kernel(mod, tpi);
  if (fn == nullptr || threads <= 0 || threads % 32) return -1;
  if (n <= 0) return 0;
  const long long total = (long long)n * tpi;
  const int blocks = (int)((total + threads - 1) / threads);
  fn<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, k, r264);
  return (int)cudaGetLastError();
}
