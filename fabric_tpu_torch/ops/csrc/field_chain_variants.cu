// KF2: the CIOS-variant microbenchmarks of the JAX package's experiments,
// as one templated kernel: a chain of n Montgomery multiplies mod P-256's
// p per lane, t <- t * b * 2^-264, from t = a.
//
// Replaces (each a Pallas chain on (22, B) 12-bit int32 limbs in VMEM,
// held there against a bignum.Mont chain, whose R is 2^264):
//   experiments/proto_pallas2.py:71  run    relaxed limbs, unshifted acc
//   experiments/proto_pallas2.py:127 run_k  K = 4 multiplies stacked
//   experiments/proto_pallas4.py:70  run    the hand-minimised CIOS
//   experiments/proto_planes.py:74   run    22 limb planes of (8, 128)
//   experiments/proto_ilp.py:72      run    K interleaved chains per lane
// Every instantiation computes the reference's function, a * (b *
// 2^-264)^n mod p, on the port's R = 2^256: b is reduced and scaled once
// by 2^248 (b * 2^248 * 2^-256 = b * 2^-8), after which a multiply with
// R = 2^256 equals one with R = 2^264.  The output is canonical (< p).
//
// The template parameters are Hopper designs, not copies of the TPU
// blocks:
//   LAZY    each multiply ends at an almost-Montgomery result in
//           [0, 2^256), which lies in [0, 2p): p is subtracted only when
//           bit 256 is set, with no comparison; the value is brought into
//           [0, p) once, at the end (the counterpart of relaxed limbs).
//           With a < 2^256 and b < p the CIOS sum is < 2p, so the chain
//           keeps its bound.  Without LAZY each multiply reduces fully.
//   K       K independent chains per thread, interleaved in one
//           instruction stream; thread (group) j carries lanes k * (B / K)
//           + j, the lane order of the reference's .reshape(L, K, B // K).
//   PLANES  limb-major (8, B) global layout: word w of lane i at w * B + i,
//           so loads and stores coalesce, against KP1's element-major
//           (B, 8).
//   MIN     the minimised multiply mod p: the reduction from p's special
//           form (limbs 0, 1 and 2^32 - 1; -p^-1 = 1 mod 2^32) with adds
//           only: with q = t_i, (t + q p) / 2^32 adds q at word i+3, q at
//           i+6 and q (2^32 - 1) at i+7..i+8.  Without MIN the reduction
//           is the generic q p row (CIOS), as the reference's relaxed
//           variants keep it.
//   CLOCK   thread 0 of block 0 reads clock64 and globaltimer around the
//           chain and writes the SM cycles to clk[0] and the nanoseconds
//           to clk[1] (their ratio is the SM clock it ran at); off in
//           timed runs.
//   TPI     threads a lane, chosen by the launcher
//           (fabric_tpu_torch/ops/field.py group_plan) from the lane count
//           B and the card's SM count:
//     1     kf2_kernel, one thread a lane, where the B lanes fill the
//           card (SMs x 2,048; K chains in a thread stand in for K
//           threads): p256_field.cuh's CIOS inlined (or, MIN,
//           the PTX product rows and special-form steps), operands in
//           registers;
//     4     kf2_group_kernel below that: field_group.cuh's group
//           multiply, one lane's limbs spread over TPI threads of a warp,
//           b's words gathered once into each thread.  Under a group, K
//           keeps its meaning: K chains interleaved in each thread of the
//           group, so K = 4 at 16,384 lanes is 4,096 groups of 4, 16,384
//           threads.  Unless the caller fixes the block, the launcher
//           halves it (down to a warp) while the grid has fewer blocks
//           than SMs, so no preset leaves an SM idle.  At the reference's
//           16,384 lanes the group beat one thread for relaxed, stacked
//           and ilp, tied for planes and lost for min (0.0837 against
//           0.0708 ms, tools/field_ab.py on an H100; ROADMAP B11).  The
//           header's TPI = 8 is not instantiated: there 4 beat it for
//           every preset but planes, a tie (PERF.md §6).
//
// Bound on the H100: operations.  The least work of a multiply mod p is
// its 64 limb products, 128 multiply-adds (field.py IMADS["p", "mul"]),
// against 64 per SM per clock: 2 SM-cycles per multiply.  A lane moves
// 96 bytes.  The chain is serial in each lane, so the card hides its
// latency only with enough independent multiplies in flight: threads
// (lanes x TPI) or K chains per thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field_group.cuh"
#include "p256_field.cuh"

using namespace p256;

namespace kf2 {

// 2^248, the residue that maps R = 2^256 onto the reference's 2^264
__device__ __forceinline__ void scale_const(uint32_t s[8]) {
#pragma unroll
  for (int j = 0; j < 7; ++j) s[j] = 0u;
  s[7] = 1u << 24;
}

// t (with bit 256 in hi) in [0, 2p) -> r in [0, 2^256), r = t mod p: add
// 2^256 - p (limbs 1, 0, 0, 2^32-1, 2^32-1, 2^32-1, 2^32-2, 0) when hi is
// set, and drop the carry out
__device__ __forceinline__ void amm_end(uint32_t r[8], const uint32_t t[8],
                                        uint32_t hi) {
  const uint32_t mask = 0u - hi;
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = t[j];
  asm("add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, %9;\n\t"
      "addc.cc.u32 %4, %4, %9;\n\t"
      "addc.cc.u32 %5, %5, %9;\n\t"
      "addc.cc.u32 %6, %6, %10;\n\t"
      "addc.u32    %7, %7, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7])
      : "r"(hi), "r"(mask), "r"(mask & 0xFFFFFFFEu));
}

// p256_field.cuh's CIOS mod p, inlined: r = a * b * 2^-256, a < 2^256,
// b < p; LAZY ends in [0, 2^256), else in [0, p).  r may alias a.
template <bool LAZY>
__device__ __forceinline__ void cios(uint32_t r[8], const uint32_t a[8],
                                     const uint32_t b[8]) {
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t ai = a[i];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t x = (uint64_t)ai * b[j] + t[j] + c;
      t[j] = (uint32_t)x;
      c = x >> 32;
    }
    uint64_t x = (uint64_t)t[8] + c;
    t[8] = (uint32_t)x;
    const uint32_t t9 = (uint32_t)(x >> 32);
    const uint32_t q = t[0] * P256_P_MINV;
    x = (uint64_t)q * mword<MOD_P>(0) + t[0];
    c = x >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      x = (uint64_t)q * mword<MOD_P>(j) + t[j] + c;
      t[j - 1] = (uint32_t)x;
      c = x >> 32;
    }
    x = (uint64_t)t[8] + c;
    t[7] = (uint32_t)x;
    t[8] = t9 + (uint32_t)(x >> 32);
  }
  if (LAZY)
    amm_end(r, t, t[8]);
  else
    reduce_once<MOD_P>(r, t, t[8]);
}

// t[0..8] += ai * b[0..7] low halves; t[8] takes the carry (t[8] <= 1
// before, so it cannot overflow)
__device__ __forceinline__ void row_lo(uint32_t* t, uint32_t ai,
                                       const uint32_t b[8]) {
  asm("mad.lo.cc.u32  %0, %9, %10, %0;\n\t"
      "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
      "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
      "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
      "addc.u32       %8, %8, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(ai), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]),
        "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// t[1..8] += ai * b[0..7] high halves; t[9] (not yet written) = the carry
__device__ __forceinline__ void row_hi(uint32_t* t, uint32_t ai,
                                       const uint32_t b[8]) {
  asm("mad.hi.cc.u32  %0, %9, %10, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %11, %1;\n\t"
      "madc.hi.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %13, %3;\n\t"
      "madc.hi.cc.u32 %4, %9, %14, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %15, %5;\n\t"
      "madc.hi.cc.u32 %6, %9, %16, %6;\n\t"
      "madc.hi.cc.u32 %7, %9, %17, %7;\n\t"
      "addc.u32       %8, 0, 0;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
        "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "=r"(t[9])
      : "r"(ai), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]),
        "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// one reduction step at word i (t points at t_i, q = t_i): t[3] += q,
// t[6] += q, t[7..8] += q (2^32 - 1) + c_in 2^32; returns the carry out
// of t[8], which belongs at t[9] and rides the next step's high word
// (q (2^32 - 1) has high word q - 1 <= 2^32 - 2, so adding it is exact)
__device__ __forceinline__ uint32_t red_step(uint32_t* t, uint32_t c_in) {
  const uint32_t q = t[0];
  const uint32_t lo = 0u - q;
  const uint32_t hi = q - (q != 0u) + c_in;
  uint32_t c;
  asm("add.cc.u32  %0, %0, %7;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, %7;\n\t"
      "addc.cc.u32 %4, %4, %8;\n\t"
      "addc.cc.u32 %5, %5, %9;\n\t"
      "addc.u32    %6, 0, 0;"
      : "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8]), "=r"(c)
      : "r"(q), "r"(lo), "r"(hi));
  return c;
}

// the minimised multiply mod p: r = a * b * 2^-256 in [0, 2^256),
// a < 2^256, b < p.  r may alias a or b.
__device__ __forceinline__ void mul_min(uint32_t r[8], const uint32_t a[8],
                                        const uint32_t b[8]) {
  uint32_t t[17];
#pragma unroll
  for (int j = 0; j < 17; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    row_lo(t + i, a[i], b);
    row_hi(t + i, a[i], b);
  }
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) c = red_step(t + i, c);
  amm_end(r, t + 8, c);   // the product is < 2^512: t[16] is 0
}

template <bool LAZY, bool MIN>
__device__ __forceinline__ void mul(uint32_t r[8], const uint32_t a[8],
                                    const uint32_t b[8]) {
  if (MIN)
    mul_min(r, a, b);
  else
    cios<LAZY>(r, a, b);
}

template <bool LAZY, int K, bool PLANES, bool MIN, bool CLOCK, int MAXT>
__global__ void __launch_bounds__(MAXT)
    kf2_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, int lanes, int n,
               long long* __restrict__ clk) {
  const int per = lanes / K;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= per) return;
  uint32_t t[K][8], bb[K][8];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t lane = (size_t)k * per + j;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const size_t at = PLANES ? (size_t)w * lanes + lane : lane * 8 + w;
      t[k][w] = a[at];
      bb[k][w] = b[at];
    }
    uint32_t s[8];
    scale_const(s);
    fe_canon<MOD_P>(bb[k], bb[k]);
    mul<LAZY, MIN>(bb[k], bb[k], s);
    fe_canon<MOD_P>(bb[k], bb[k]);   // b < p keeps every CIOS sum < 2p
  }
  long long c0 = 0, g0 = 0;
  if (CLOCK) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
    c0 = clock64();
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) mul<LAZY, MIN>(t[k], t[k], bb[k]);
  }
  if (CLOCK) {
    const long long c1 = clock64();
    long long g1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      clk[0] = c1 - c0;
      clk[1] = g1 - g0;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    fe_canon<MOD_P>(t[k], t[k]);   // any value < 2^256 < 2p -> [0, p)
    const size_t lane = (size_t)k * per + j;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const size_t at = PLANES ? (size_t)w * lanes + lane : lane * 8 + w;
      out[at] = t[k][w];
    }
  }
}

// the group design: lane j's K chains on TPI threads (see the note above)
template <bool LAZY, int K, bool PLANES, bool MIN, bool CLOCK, int MAXT,
          int TPI>
__global__ void __launch_bounds__(MAXT, 1)
    kf2_group_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     uint32_t* __restrict__ out, int lanes, int n,
                     long long* __restrict__ clk) {
  constexpr int L = 8 / TPI;
  constexpr int RED = MIN ? fgroup::RED_P : fgroup::RED_GENERIC;
  const int per = lanes / K;
  const int th = blockIdx.x * blockDim.x + threadIdx.x;
  if ((th & ~31) / TPI >= per) return;   // the whole warp is past the end
  const bool live = th / TPI < per;      // else: repeat the last group
  const int j = live ? th / TPI : per - 1;
  const fgroup::Group<TPI> g;
  const fgroup::GroupMod<TPI> gm = fgroup::group_mod<TPI, MOD_P, RED>(g);
  uint32_t t[K][L], bw[K][8];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t lane = (size_t)k * per + j;
#pragma unroll
    for (int w = 0; w < 8; ++w)
      bw[k][w] = b[PLANES ? (size_t)w * lanes + lane : lane * 8 + w];
    fe_canon<MOD_P>(bw[k], bw[k]);
    uint32_t s[8], bl[L];
    scale_const(s);
    fgroup::group_own<TPI>(bl, bw[k], g);
    fgroup::group_mul<TPI, MOD_P, RED, false>(bl, bl, s, g, gm);
    fgroup::group_gather<TPI>(bw[k], bl, g);   // b < p
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const size_t w = (size_t)g.rank * L + l;
      t[k][l] = a[PLANES ? w * lanes + lane : lane * 8 + w];
    }
  }
  long long c0 = 0, g0 = 0;
  if (CLOCK) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
    c0 = clock64();
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      fgroup::group_mul<TPI, MOD_P, RED, LAZY>(t[k], t[k], bw[k], g, gm);
  }
  if (CLOCK) {
    const long long c1 = clock64();
    long long g1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      clk[0] = c1 - c0;
      clk[1] = g1 - g0;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    fgroup::group_reduce<TPI>(t[k], t[k], g, gm);   // < 2^256 -> [0, p)
    const size_t lane = (size_t)k * per + j;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const size_t w = (size_t)g.rank * L + l;
      if (live) out[PLANES ? w * lanes + lane : lane * 8 + w] = t[k][l];
    }
  }
}

typedef void (*kernel_fn)(const uint32_t*, const uint32_t*, uint32_t*, int,
                          int, long long*);

// a variant's kernels by threads a lane: 1, 4
struct Kernels {
  kernel_fn one, four;
};

template <bool LAZY, int K, bool PLANES, bool MIN>
Kernels pick(int clock) {
  constexpr int MAXT = K >= 8 ? 128 : 512;
  if (clock)
    return {kf2_kernel<LAZY, K, PLANES, MIN, true, MAXT>,
            kf2_group_kernel<LAZY, K, PLANES, MIN, true, MAXT, 4>};
  return {kf2_kernel<LAZY, K, PLANES, MIN, false, MAXT>,
          kf2_group_kernel<LAZY, K, PLANES, MIN, false, MAXT, 4>};
}

// the variants, in the order of field_variants.VARIANTS
Kernels variant(int v, int clock, int* k) {
  switch (v) {
    case 0: *k = 1; return pick<false, 1, false, false>(clock);  // exact
    case 1: *k = 1; return pick<true, 1, false, false>(clock);   // lazy
    case 2: *k = 2; return pick<true, 2, false, false>(clock);   // lazy_k2
    case 3: *k = 4; return pick<true, 4, false, false>(clock);   // lazy_k4
    case 4: *k = 8; return pick<true, 8, false, false>(clock);   // lazy_k8
    case 5: *k = 1; return pick<true, 1, false, true>(clock);    // min
    case 6: *k = 1; return pick<true, 1, true, false>(clock);    // planes
    default: return {nullptr, nullptr};
  }
}

kernel_fn kernel(int v, int clock, int tpi, int* k) {
  const Kernels ks = variant(v, clock, k);
  return tpi == 1 ? ks.one : tpi == 4 ? ks.four : nullptr;
}

}  // namespace kf2

// Launch variant v (clock != 0: its clock64 build) on `lanes` lanes with
// tpi threads a lane (1 or 4) and `threads` threads a block (a
// multiple of 32); clk is two device int64s (clock only).  Returns the
// CUDA error of the launch, or -1 for an unknown variant or tpi.
extern "C" int field_chain_variant_group_launch(int v, int clock,
                                                const void* a,
                                                const void* b, void* out,
                                                int lanes, int n, int tpi,
                                                int threads, void* clk,
                                                void* stream) {
  int k = 1;
  const kf2::kernel_fn fn = kf2::kernel(v, clock, tpi, &k);
  if (fn == nullptr || threads <= 0 || threads % 32) return -1;
  const int per = lanes / k;
  if (per <= 0) return 0;
  const long long total = (long long)per * tpi;
  const int blocks = (int)((total + threads - 1) / threads);
  fn<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, lanes, n,
      (long long*)clk);
  return (int)cudaGetLastError();
}

// out[0..2] = registers a thread, local (stack) bytes a thread and the
// most threads a block of variant v's kernel at tpi threads a lane
extern "C" int field_chain_variant_attrs(int v, int clock, int tpi,
                                         void* out) {
  int k = 1;
  const kf2::kernel_fn fn = kf2::kernel(v, clock, tpi, &k);
  if (fn == nullptr) return -1;
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(&at, (const void*)fn);
  if (err != cudaSuccess) return (int)err;
  int* o = (int*)out;
  o[0] = at.numRegs;
  o[1] = (int)at.localSizeBytes;
  o[2] = at.maxThreadsPerBlock;
  return 0;
}
