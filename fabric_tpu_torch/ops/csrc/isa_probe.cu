// KI3: instruction-cost probes on (22, B) columns.
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
// The multiplies are done in uint32 (the reference's int32 wraps by
// design; signed overflow is undefined in C++).  The constants (3,
// 0xFFFFF, 4095, 12, 100, 1.5) come in as kernel arguments, so the
// compiler cannot fold a masked chain into one multiply; the where chain
// may fold into one add: what remains is read from the SASS.
//
// Bound on the H100: operations, the least instructions of a pass
// (isa_probe.py LEAST_PER_PASS: two a step for most bodies) at the SM's
// issue rate of 128 a clock, whatever the mix of int32 and f32 pipes;
// rotate and roll do none and where folds to a few, so those are bound
// by their bytes, one read and one write of the (22, B) tile.
//
// Layouts (isa_probe.py probe_plan picks one; every layout computes the
// same values):
//   column  one thread a column, its 22 values in registers; rotate and
//           roll by a constant are register renames.  Where B fills the
//           card (SMs x 2,048 columns) this is the plan's layout, and
//           split's at every B (a column spread over lanes earned it
//           nothing: its mask and shifted add share the integer pipe).
//   quad    one thread the elements (r, j) .. (r, j + 3) of one row, for
//           the bodies whose rows never mix (mul, shift_or, f32), and for
//           where, rotate and roll.  Lanes of a warp hold neighbouring j
//           of one row, so loads and stores coalesce, 16 bytes a thread
//           where the rows are 16-byte aligned.  where: each thread also
//           reads x[0, j] and steps row 0's value itself once a pass (m =
//           r0 > thr; r0 + 64 when not m), the reference's once-a-pass
//           mask with no exchange.  rotate and roll read row (r +- 64
//           iters) mod 22, the net permutation of the column layout's
//           renames.  shift_or runs on the values' bit reverses, so its
//           shift is a multiply (quad_pass).
//   g2      row_mul only: a column on 2 lanes of one warp, lane k holding
//           rows 11 k .. 11 k + 10.  The owner of row i % 22 broadcasts
//           its value at step i's start (__shfl_sync); each step updates
//           and sends the next step's row first, so the shuffle is in
//           flight while the other rows update.  A warp holds 16 columns,
//           no lane idle.
// At the reference's B = 16,384 one thread a column is 128 blocks of 128
// threads, 4 warps on an SM of 64: quad puts about 21 warps and g2 about
// 8 on each of the 132 SMs.  The extra loads and shuffles are the
// layout's cost; the bound stays the least work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace ki3 {

constexpr int L = 22;
constexpr int REP = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;
constexpr int PER = 4;        // quad: values of one row a thread
constexpr int G = 2;          // g2: lanes a column
constexpr int R = L / G;      // g2: rows a lane

enum { MUL, ROW_MUL, ROTATE, ROLL, WHERE, SPLIT, SHIFT_OR, F32, N_PROBES };
enum { COLUMN, QUAD, G2, N_LAYOUTS };

struct Args {
  uint32_t cmul, m20;
  int32_t m12, sh, thr;
  float fc;
  // shift_or's 2 (an argument, so the left shift is issued as an IMAD
  // and not as a SHF) and the bit reverse of m12
  uint32_t two, m12rev;
  bool vec4;              // B % 4 == 0 and x, out 16-byte aligned
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

// ---------------------------------------------------------------------------
// quad: 4 neighbouring columns of one row a thread
// ---------------------------------------------------------------------------

// one pass of a body whose rows never mix, on 4 values of one row.
// shift_or runs on the values' bit reverses (__brev at load and store):
// with y = rev(x), rev(((x >> 1) & m) | x) = ((y << 1) & rev(m)) | y, the
// reference's two operations a step, but the shift is now a left one, a
// multiply by 2 (IMAD, the multiply pipe) beside the LOP3 (the integer
// pipe), as mul's two are.  Right shifts run only on the integer pipe,
// 64 lanes a clock an SM, half the issue rate that the bound counts.
template <int PROBE>
__device__ __forceinline__ void quad_pass(int32_t v[PER], const Args& g) {
#pragma unroll
  for (int i = 0; i < REP; ++i)
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (PROBE == MUL) {
        v[k] = (int32_t)(((uint32_t)v[k] * g.cmul) & g.m20);
      } else if (PROBE == SHIFT_OR) {   // on rev(x)
        const uint32_t y = (uint32_t)v[k];
        v[k] = (int32_t)(((y * g.two) & g.m12rev) | y);
      } else {  // F32
        const float f = __int_as_float(v[k]);
        float m, d;
        asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(m) : "f"(f), "f"(g.fc));
        asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(m), "f"(f));
        v[k] = __float_as_int(d);
      }
    }
}

// 4 neighbouring values of row p from column j0: one 16-byte access
// where the launch found the tile's rows 16-byte aligned (vec), else one
// access a value inside B (zeros past it)
__device__ __forceinline__ void load_row(const int32_t* __restrict__ p,
                                         int j0, int B, bool vec,
                                         int32_t v[PER]) {
  if (vec) {
    const int4 q = *reinterpret_cast<const int4*>(p + j0);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) v[k] = j0 + k < B ? p[j0 + k] : 0;
}

__device__ __forceinline__ void store_row(int32_t* __restrict__ p, int j0,
                                          int B, bool vec,
                                          const int32_t v[PER]) {
  if (vec) {
    *reinterpret_cast<int4*>(p + j0) = make_int4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (j0 + k < B) p[j0 + k] = v[k];
}

// thread t -> row r = t / cols and columns j0 .. j0 + 3 of it, j0 = (t %
// cols) 4, cols = ceil(B / 4): a warp's lanes hold neighbouring columns
// of one row (two rows where a row ends inside it)
template <int PROBE>
__global__ void __launch_bounds__(THREADS)
    isa_probe_quad_kernel(const int32_t* __restrict__ x,
                          int32_t* __restrict__ out, int B, int iters,
                          Args g) {
  const int cols = (B + PER - 1) / PER;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)L * cols) return;
  const int r = (int)(t / cols);
  const int j0 = (int)(t - (size_t)r * cols) * PER;
  int32_t v[PER];
  if (PROBE == ROTATE || PROBE == ROLL) {
    // the net permutation of iters passes of 64 one-row moves
    const int s = (int)((64LL * iters) % L);
    const int src = PROBE == ROTATE ? (r + s) % L : (r + L - s) % L;
    load_row(x + (size_t)src * B, j0, B, g.vec4, v);
    store_row(out + (size_t)r * B, j0, B, g.vec4, v);
    return;
  }
  load_row(x + (size_t)r * B, j0, B, g.vec4, v);
  int32_t r0[PER];
  if (PROBE == WHERE) load_row(x, j0, B, g.vec4, r0);
  if (PROBE == SHIFT_OR) {
#pragma unroll
    for (int k = 0; k < PER; ++k) v[k] = (int32_t)__brev((uint32_t)v[k]);
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    if (PROBE == WHERE) {
      // a pass's 64 selects on the mask of row 0's value at its start,
      // as their net add (the column kernel's compiler folds them so)
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const uint32_t d = r0[k] > g.thr ? 0u : (uint32_t)REP;
        v[k] = (int32_t)((uint32_t)v[k] + d);
        r0[k] = (int32_t)((uint32_t)r0[k] + d);
      }
    } else {
      quad_pass<PROBE>(v, g);
    }
  }
  if (PROBE == SHIFT_OR) {
#pragma unroll
    for (int k = 0; k < PER; ++k) v[k] = (int32_t)__brev((uint32_t)v[k]);
  }
  store_row(out + (size_t)r * B, j0, B, g.vec4, v);
}

// ---------------------------------------------------------------------------
// g2: row_mul on 2 lanes of a warp a column, 11 rows a lane
// ---------------------------------------------------------------------------

// lane = 2 q + k: the warp's column q (of 16), the group's lane k, holding
// rows 11 k .. 11 k + 10 of column j = 16 warp + q.  Every lane of the
// warp runs the body (columns past B on zeros), so each shuffle has the
// whole warp.
__global__ void __launch_bounds__(THREADS)
    isa_probe_row_mul_g2_kernel(const int32_t* __restrict__ x,
                                int32_t* __restrict__ out, int B, int iters,
                                Args g) {
  constexpr int CPW = 32 / G;
  const int lane = threadIdx.x & 31;
  const int warp = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int q = lane / G;
  const int k = lane - q * G;
  const int base = q * G;
  const int j = warp * CPW + q;
  const bool live = j < B;
  int32_t v[R];
#pragma unroll
  for (int i = 0; i < R; ++i)
    v[i] = live ? x[(size_t)(k * R + i) * B + j] : 0;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    // s: row i % 22's value at step i's start, from its owner.  Each step
    // first updates the register that holds row (i + 1) % 22 and sends
    // the owner's, then updates the other rows while the shuffle is in
    // flight.
    uint32_t s = (uint32_t)__shfl_sync(FULL, v[0], base);
#pragma unroll
    for (int i = 0; i < REP; ++i) {
      const int nrow = (i + 1) % L;
      const int nowner = nrow / R;
      const int nidx = nrow - nowner * R;
      v[nidx] = (int32_t)(((uint32_t)v[nidx] * s) & g.m20);
      uint32_t sn = 0;
      if (i + 1 < REP)
        sn = (uint32_t)__shfl_sync(FULL, v[nidx], base + nowner);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r != nidx) v[r] = (int32_t)(((uint32_t)v[r] * s) & g.m20);
      s = sn;
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < R; ++i) out[(size_t)(k * R + i) * B + j] = v[i];
  }
}

typedef void (*kernel_fn)(const int32_t*, int32_t*, int, int, Args);

kernel_fn probe_fn(int p, int layout) {
  if (layout == COLUMN) {
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
  if (layout == QUAD) {
    switch (p) {
      case MUL: return isa_probe_quad_kernel<MUL>;
      case ROTATE: return isa_probe_quad_kernel<ROTATE>;
      case ROLL: return isa_probe_quad_kernel<ROLL>;
      case WHERE: return isa_probe_quad_kernel<WHERE>;
      case SHIFT_OR: return isa_probe_quad_kernel<SHIFT_OR>;
      case F32: return isa_probe_quad_kernel<F32>;
      default: return nullptr;
    }
  }
  if (layout == G2 && p == ROW_MUL) return isa_probe_row_mul_g2_kernel;
  return nullptr;
}

// threads of a launch over B columns in a layout
long long layout_threads(int layout, int B) {
  switch (layout) {
    case COLUMN: return B;
    case QUAD: return (long long)L * ((B + PER - 1) / PER);
    default: return 32LL * ((B + 32 / G - 1) / (32 / G));
  }
}

}  // namespace ki3

// Launch probe p in a layout (COLUMN, QUAD or G2) over the (22, B) tile
// x (int32, or f32 as its bits) into out, `iters` passes of its body, 128
// threads a block.  The body's constants come as arguments; fc_bits is
// the f32 factor's bit pattern.  Returns the CUDA error of the launch, or
// -1 for a probe or layout with no kernel.
extern "C" int isa_probe_layout_launch(int p, int layout, const void* x,
                                       void* out, int B, int iters, int cmul,
                                       int m20, int m12, int sh, int thr,
                                       int fc_bits, void* stream) {
  ki3::kernel_fn fn = ki3::probe_fn(p, layout);
  if (fn == nullptr) return -1;
  if (B <= 0) return 0;
  ki3::Args g;
  g.cmul = (uint32_t)cmul;
  g.m20 = (uint32_t)m20;
  g.m12 = m12;
  g.sh = sh;
  g.thr = thr;
  g.two = 2u;
  g.m12rev = 0;
  for (int b = 0; b < 32; ++b)
    if ((uint32_t)m12 >> b & 1u) g.m12rev |= 1u << (31 - b);
  g.vec4 = B % 4 == 0 && ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  uint32_t bits = (uint32_t)fc_bits;
  memcpy(&g.fc, &bits, sizeof g.fc);
  const long long blocks =
      (ki3::layout_threads(layout, B) + ki3::THREADS - 1) / ki3::THREADS;
  fn<<<(unsigned)blocks, ki3::THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, B, iters, g);
  return (int)cudaGetLastError();
}

// out[0..2] = registers a thread, local (stack) bytes a thread and the
// most threads a block of probe p's kernel in a layout
extern "C" int isa_probe_attrs(int p, int layout, void* out) {
  ki3::kernel_fn fn = ki3::probe_fn(p, layout);
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
