// KI3: instruction-cost probes on (22, B) columns, one thread a column.
//
// Replaces the Pallas primitive-cost microbenchmarks of the JAX package,
// experiments/proto_pallas3.py:23 (bench.run: seven int32 bodies, each
// REP = 64 steps, run 4 times over (22, B) int32 tiles) and :115
// (bench_f32.run: x * 1.5 - x in f32).  Each probe computes the values of
// its reference body:
//   0 mul       x = (x * 3) & 0xFFFFF
//   1 row_mul   x = (x * x[i % 22]) & 0xFFFFF, i = 0..63
//   2 rotate    out[r] = x[r + 1 mod 22]  (concatenate([x[1:], x[:1]]))
//   3 roll      out[r] = x[r - 1 mod 22]  (pltpu.roll(x, 1, 0), jnp.roll's
//               direction)
//   4 where     x = where(m, x, x + 1), m = x[0] > 100 taken once a pass
//   5 split     c = x >> 12; x = (x & 4095) + [0, c[:-1]], 16 steps
//   6 shift_or  x = ((x >> 1) & 4095) | x
//   7 f32       x = x * 1.5 - x, each operation rounded and flushed to
//               zero below 2^-126 (mul.rn.ftz / sub.rn.ftz: no
//               contraction into an FFMA; the reference's XLA and TPU
//               flush subnormals, and without the flush the chain sticks
//               at 2^-149, where 1.5 * 2^-149 rounds to 2^-148, instead of
//               reaching 0)
// row_mul, rotate, roll and split mix the rows of a column, so a thread
// holds its column's 22 values in registers.  The multiplies are done in
// uint32 (the reference's int32 wraps by design; signed overflow is
// undefined in C++).  The constants (3, 0xFFFFF, 4095, 12, 100, 1.5) come
// in as kernel arguments, so the compiler cannot fold a masked chain into
// one multiply; rotate and roll by a constant are register renames all
// the same, and the where chain may fold into one add: what remains is
// read from the SASS.
//
// Bound on the H100: operations, the least instructions of a pass
// (isa_probe.py LEAST_PER_PASS: two a step for most bodies) at the SM's
// issue rate of 128 a clock, whatever the mix of int32 and f32 pipes;
// rotate and roll do none and where folds to a few, so those are bound
// by their bytes, one read and one write of the (22, B) tile.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace ki3 {

constexpr int L = 22;
constexpr int REP = 64;

enum { MUL, ROW_MUL, ROTATE, ROLL, WHERE, SPLIT, SHIFT_OR, F32, N_PROBES };

struct Args {
  uint32_t cmul, m20;
  int32_t m12, sh, thr;
  float fc;
};

template <int PROBE>
__device__ __forceinline__ void body(int32_t v[L], const Args& g) {
  if (PROBE == MUL) {
#pragma unroll
    for (int i = 0; i < REP; ++i)
#pragma unroll
      for (int r = 0; r < L; ++r)
        v[r] = (int32_t)(((uint32_t)v[r] * g.cmul) & g.m20);
  } else if (PROBE == ROW_MUL) {
#pragma unroll
    for (int i = 0; i < REP; ++i) {
      const uint32_t s = (uint32_t)v[i % L];
#pragma unroll
      for (int r = 0; r < L; ++r)
        v[r] = (int32_t)(((uint32_t)v[r] * s) & g.m20);
    }
  } else if (PROBE == ROTATE) {
#pragma unroll
    for (int i = 0; i < REP; ++i) {
      const int32_t first = v[0];
#pragma unroll
      for (int r = 0; r < L - 1; ++r) v[r] = v[r + 1];
      v[L - 1] = first;
    }
  } else if (PROBE == ROLL) {
#pragma unroll
    for (int i = 0; i < REP; ++i) {
      const int32_t last = v[L - 1];
#pragma unroll
      for (int r = L - 1; r > 0; --r) v[r] = v[r - 1];
      v[0] = last;
    }
  } else if (PROBE == WHERE) {
    const bool m = v[0] > g.thr;
#pragma unroll
    for (int i = 0; i < REP; ++i)
#pragma unroll
      for (int r = 0; r < L; ++r)
        v[r] = m ? v[r] : (int32_t)((uint32_t)v[r] + 1u);
  } else if (PROBE == SPLIT) {
#pragma unroll
    for (int i = 0; i < REP / 4; ++i) {
      int32_t c[L];
#pragma unroll
      for (int r = 0; r < L; ++r) c[r] = v[r] >> g.sh;   // arithmetic
      v[0] &= g.m12;
#pragma unroll
      for (int r = 1; r < L; ++r) v[r] = (v[r] & g.m12) + c[r - 1];
    }
  } else if (PROBE == SHIFT_OR) {
#pragma unroll
    for (int i = 0; i < REP; ++i)
#pragma unroll
      for (int r = 0; r < L; ++r) v[r] = ((v[r] >> 1) & g.m12) | v[r];
  } else {  // F32 on the values' bits
#pragma unroll
    for (int i = 0; i < REP; ++i)
#pragma unroll
      for (int r = 0; r < L; ++r) {
        const float f = __int_as_float(v[r]);
        float m, d;
        asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(m) : "f"(f), "f"(g.fc));
        asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(m), "f"(f));
        v[r] = __float_as_int(d);
      }
  }
}

template <int PROBE>
__global__ void __launch_bounds__(128)
    isa_probe_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                     int B, int iters, Args g) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B) return;
  int32_t v[L];
#pragma unroll
  for (int r = 0; r < L; ++r) v[r] = x[(size_t)r * B + j];
#pragma unroll 1
  for (int it = 0; it < iters; ++it) body<PROBE>(v, g);
#pragma unroll
  for (int r = 0; r < L; ++r) out[(size_t)r * B + j] = v[r];
}

typedef void (*kernel_fn)(const int32_t*, int32_t*, int, int, Args);

kernel_fn probe_fn(int p) {
  switch (p) {
    case MUL: return isa_probe_kernel<MUL>;
    case ROW_MUL: return isa_probe_kernel<ROW_MUL>;
    case ROTATE: return isa_probe_kernel<ROTATE>;
    case ROLL: return isa_probe_kernel<ROLL>;
    case WHERE: return isa_probe_kernel<WHERE>;
    case SPLIT: return isa_probe_kernel<SPLIT>;
    case SHIFT_OR: return isa_probe_kernel<SHIFT_OR>;
    case F32: return isa_probe_kernel<F32>;
    default: return nullptr;
  }
}

}  // namespace ki3

// Launch probe p over the (22, B) tile x (int32, or f32 as its bits) into
// out, `iters` passes of its body, 128 threads a block.  The body's
// constants come as arguments; fc_bits is the f32 factor's bit pattern.
// Returns the CUDA error of the launch, or -1 for an unknown probe.
extern "C" int isa_probe_launch(int p, const void* x, void* out, int B,
                                int iters, int cmul, int m20, int m12, int sh,
                                int thr, int fc_bits, void* stream) {
  ki3::kernel_fn fn = ki3::probe_fn(p);
  if (fn == nullptr) return -1;
  if (B <= 0) return 0;
  ki3::Args g;
  g.cmul = (uint32_t)cmul;
  g.m20 = (uint32_t)m20;
  g.m12 = m12;
  g.sh = sh;
  g.thr = thr;
  uint32_t bits = (uint32_t)fc_bits;
  memcpy(&g.fc, &bits, sizeof g.fc);
  const int threads = 128;
  fn<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, B, iters, g);
  return (int)cudaGetLastError();
}

// out[0..2] = registers a thread, local (stack) bytes a thread and the
// most threads a block of probe p's kernel
extern "C" int isa_probe_attrs(int p, void* out) {
  ki3::kernel_fn fn = ki3::probe_fn(p);
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
