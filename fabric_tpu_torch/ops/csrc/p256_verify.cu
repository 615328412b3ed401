// KP2: generic ECDSA-P256 verification, one signature per thread.
//
// Replaces: fabric_tpu/ops/ecp256.py:verify_body (with comb_accumulate,
// add_mixed, dbl, add_nodbl, add_complete and _inv_n), the generic lane
// of fabric_tpu/bccsp/jaxtpu.py; its verdicts also equal those of the
// round-1 ladder fabric_tpu/ops/p256.py:verify_words.
//
// Per signature: r, s in [1, n); low-S (s < (n-1)/2 + 1) when asked;
// qx, qy < p and Q on the curve; w = s^-1 mod n (Fermat);
// u1 = e*w, u2 = r*w mod n; u1*G by an 8-bit fixed-base comb over the
// (32 x 256)-entry affine table of G (digits LSB-first, digit 0 adds
// nothing); u2*Q by a 4-bit window ladder over a 16-entry Jacobian table
// of Q (64 digits MSB-first); a complete add of the two; then
// X == r*Z^2 or (r + n < p and X == (r+n)*Z^2), with the result neither
// infinity nor Z == 0.  Infinity is a flag, never Z == 0.
//
// The TPU version selects comb entries with a one-hot f32 matmul on the
// MXU; here each thread loads row j*256 + d of the table directly (64 B,
// the whole 512 KB table stays in L2).  The TPU inverts s with a product
// tree across the batch; here each thread runs its own Fermat chain.
//
// Bound on the H100: integer multiply-adds.  The least work of a verify
// is about 3,530 Montgomery multiplies and squares mod p and 6 mod n,
// with s^-1 batched (3 multiplies per signature, one Fermat chain per
// launch); the exact count for given u1, u2 is fabric_tpu_torch/ops/
// p256.py:field_ops_per_verify, weighed by the least work of each
// (ops/field.py:IMADS, see p256_field.cuh) against 64 multiply-adds per
// SM per clock; each signature moves 161 bytes.
//
// Design: the point routines run on field_ptx.cuh's PtxField, with
// operands in registers: mod p the PTX carry-chain product with the
// reduction from p's special form (adds only, no q*p products), one real
// call shared by every site (its operands and result pass in registers),
// mod n a carry-chain CIOS inlined; both end fully reduced, so the adds,
// subtractions and comparisons of the point layer are unchanged.  What still holds
// it back from the bound:
//   - the 16-entry table of Q (1.5 KB a thread) lives in local memory,
//     and the ladder reads one entry a window from it;
//   - s^-1 is still one Fermat chain per thread (423 multiplies mod n),
//     not batched across the launch;
//   - one thread per signature leaves few warps per SM at block sizes
//     (40k signatures = 313 blocks of 128 on 132 SMs), and a small batch
//     is one serial chain of ~4,000 multiplies.
// The field probe (p256_field_probe_plan_launch, below) runs mul_p, sqr_p
// and mont_mul_ptx<MOD_N> once a lane, through PtxField as KP2 calls
// them, and mul_25519 as KE5 and KE6 call it, so that each can be held
// bit for bit against the plain field on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field_ptx.cuh"
#include "p256_point.cuh"

using namespace p256;

__global__ void __launch_bounds__(128) p256_verify_kernel(
    const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
    const uint32_t* __restrict__ rw, const uint32_t* __restrict__ sw,
    const uint32_t* __restrict__ ew, const uint32_t* __restrict__ table,
    uint8_t* __restrict__ out, int n, int require_low_s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t QX[8], QY[8], R[8], S[8], E[8];
  load_be(QX, qx, i, n);
  load_be(QY, qy, i, n);
  load_be(R, rw, i, n);
  load_be(S, sw, i, n);
  load_be(E, ew, i, n);

  // --- range and key checks (ecp256.py:455-469) ---
  const bool r_ok = !fe_is_zero(R) && fe_lt(R, C_N);
  bool s_ok = !fe_is_zero(S) && fe_lt(S, C_N);
  if (require_low_s) s_ok = s_ok && fe_lt(S, C_HALF_N_PLUS_1);
  bool q_ok = fe_lt(QX, C_P) && fe_lt(QY, C_P);

  uint32_t xm[8], ym[8], lhs[8], rhs[8];
  PtxField::p_to_mont(xm, QX);
  PtxField::p_to_mont(ym, QY);
  PtxField::sqr(lhs, ym);           // y^2
  PtxField::sqr(rhs, xm);
  fp_add(rhs, rhs, C_A_MONT);
  PtxField::mul(rhs, rhs, xm);
  fp_add(rhs, rhs, C_B_MONT);       // x^3 + a x + b
  q_ok = q_ok && fe_eq(lhs, rhs);

  // --- u1 = e / s, u2 = r / s mod n ---
  uint32_t u1[8], u2[8];
  scalars<PtxField>(u1, u2, R, S, E);

  // --- u1*G: 8-bit comb, windows LSB-first, digit 0 adds nothing ---
  Jac acc_g;
  pt_comb<PtxField>(acc_g, table, u1);

  // --- u2*Q: 16-entry table, 4-bit digits MSB-first ---
  Jac T[16];
  pt_set_inf(T[0]);
  fe_copy(T[1].X, xm);
  fe_copy(T[1].Y, ym);
  fe_copy(T[1].Z, C_P_ONE);
  T[1].inf = 0;
  pt_dbl<PtxField>(T[2], T[1]);
#pragma unroll 1
  for (int k = 3; k < 16; ++k) pt_add_nodbl<PtxField>(T[k], T[k - 1], T[1]);

  Jac acc;
  pt_set_inf(acc);
#pragma unroll 1
  for (int win = 63; win >= 0; --win) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) pt_dbl<PtxField>(acc, acc);
    const uint32_t d = (u2[win >> 3] >> (4 * (win & 7))) & 0xFu;
    pt_add_nodbl<PtxField>(acc, acc, T[d]);
  }

  // --- combine (complete: u1*G == +-u2*Q is reachable), then the
  // projective x check: X == (r + k n) Z^2, k in {0, 1} ---
  Jac res;
  pt_add_complete<PtxField>(res, acc_g, acc);
  out[i] = r_ok && s_ok && q_ok && x_matches_r<PtxField>(res, R);
}

extern "C" int p256_verify_launch(const void* qx, const void* qy,
                                  const void* r, const void* s, const void* e,
                                  const void* table, void* out, int n,
                                  int require_low_s, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  p256_verify_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)qx, (const uint32_t*)qy, (const uint32_t*)r,
      (const uint32_t*)s, (const uint32_t*)e, (const uint32_t*)table,
      (uint8_t*)out, n, require_low_s);
  return (int)cudaGetLastError();
}

// -- the field probe ----------------------------------------------------------
// a, b, out: (n, 8) uint32, little-endian words of input i at i * 8 + j,
// each 16-byte aligned; out aliases neither input.  OP 0: mul_p(a, b),
// written over a; 1: sqr_p(a), in place (b is not read); 2:
// mont_mul_ptx<MOD_N>(a, b), written over b (KP2's call sites alias the
// same ways); 3: mul_25519(a, b) through mul_25519_call, as KE5 and KE6
// call it.  Inputs must meet the routines' preconditions (a < 2^256;
// b < p, < n for op 2, < p25519 for op 3; a < p for sqr_p): the kernel
// does not check.
//
// Bound: bytes (96 a lane, 64 for sqr_p), so the design is on the memory
// side; the routines are the main path's, called as it calls them.
//   - One kernel an op (template <int OP>): a launch holds one routine's
//     code and registers.
//   - A warp moves one tile of 32 lanes, 1 KB of each operand: thread t
//     loads 16-byte chunks t and t + 32 (ld.global.nc.v4, 512 contiguous
//     bytes an instruction), parks them in a padded shared-memory tile,
//     and takes its own lane's two chunks back out; the result goes back
//     into the tile and out the same way (st.global.cs.v4).  One spare
//     chunk every 8 (`probe_slot`) puts a quarter-warp's chunks 2t and
//     2t + 1 on eight distinct bank groups, and chunks t on eight too.
//     The last tile guards each chunk and lane against n.
//   - Blocks of PROBE_THREADS (256), one lane a thread; the host gives the
//     block count (`p256.field_probe_plan`), and the entry refuses a grid
//     that does not cover every tile.
// What holds it back (tools/probe_ab.py, H100, inputs read from device
// memory): at 65,536 lanes the launch and one wave that loads, then
// multiplies, then stores, with nothing to overlap; and the tile's trip
// through shared memory, which costs the L1/shared path more wavefronts
// than a lane's own two 16-byte loads at a 32-byte stride would.  At
// SMs x 2,048 lanes the tile is the faster of the two.

constexpr int PROBE_THREADS = 256;
constexpr int PROBE_TILE_CHUNKS = 64;                  // 32 lanes x 2 chunks
constexpr int PROBE_PADDED = PROBE_TILE_CHUNKS + PROBE_TILE_CHUNKS / 8;

__device__ __forceinline__ int probe_slot(int c) { return c + (c >> 3); }

__device__ __forceinline__ uint4 probe_load(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void probe_store(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

template <int OP>
__device__ __forceinline__ void probe_op(uint32_t* x, uint32_t* y) {
  if (OP == 0) {
    PtxField::mul(x, x, y);
  } else if (OP == 1) {
    PtxField::sqr(x, x);
  } else if (OP == 3) {
    fe8 u, v;
    fe_copy(u.w, x);
    fe_copy(v.w, y);
    u = mul_25519_call(u, v);
    fe_copy(x, u.w);
  } else {
    PtxField::n_mul(y, x, y);
    fe_copy(x, y);
  }
}

template <int OP>
__global__ void __launch_bounds__(PROBE_THREADS)
    p256_field_probe_kernel(const uint4* __restrict__ a,
                            const uint4* __restrict__ b,
                            uint4* __restrict__ out, int n) {
  constexpr int OPS = OP == 1 ? 1 : 2;                 // operands read
  __shared__ uint4 probe_tiles[PROBE_THREADS / 32 * OPS * PROBE_PADDED];
  const long long tile =
      (blockIdx.x * (long long)PROBE_THREADS + threadIdx.x) >> 5;
  if (tile * 32 >= n) return;                  // the whole warp: no lanes
  const int t = threadIdx.x & 31;
  uint4* ta = probe_tiles + (threadIdx.x >> 5) * (OPS * PROBE_PADDED);
  uint4* tb = ta + PROBE_PADDED;
  const long long c0 = tile * PROBE_TILE_CHUNKS + t;
  const long long chunks = 2LL * n;
  uint4 ra[2], rb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (c0 + h * 32 < chunks) {
      ra[h] = probe_load(a + c0 + h * 32);
      if (OPS == 2) rb[h] = probe_load(b + c0 + h * 32);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (c0 + h * 32 < chunks) {
      ta[probe_slot(h * 32 + t)] = ra[h];
      if (OPS == 2) tb[probe_slot(h * 32 + t)] = rb[h];
    }
  __syncwarp();
  if (tile * 32 + t < n) {
    const uint4 a0 = ta[probe_slot(2 * t)], a1 = ta[probe_slot(2 * t + 1)];
    uint32_t x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    uint32_t y[8];
    if (OPS == 2) {
      const uint4 b0 = tb[probe_slot(2 * t)], b1 = tb[probe_slot(2 * t + 1)];
      y[0] = b0.x; y[1] = b0.y; y[2] = b0.z; y[3] = b0.w;
      y[4] = b1.x; y[5] = b1.y; y[6] = b1.z; y[7] = b1.w;
    }
    probe_op<OP>(x, y);
    ta[probe_slot(2 * t)] = make_uint4(x[0], x[1], x[2], x[3]);
    ta[probe_slot(2 * t + 1)] = make_uint4(x[4], x[5], x[6], x[7]);
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (c0 + h * 32 < chunks)
      probe_store(out + c0 + h * 32, ta[probe_slot(h * 32 + t)]);
}

// blocks (p256.field_probe_plan) of PROBE_THREADS, a warp a tile of 32
// lanes: refused unless they cover every tile
extern "C" int p256_field_probe_plan_launch(int op, int blocks,
                                            const void* a, const void* b,
                                            void* out, int n, void* stream) {
  typedef void (*ProbeFn)(const uint4*, const uint4*, uint4*, int);
  static const ProbeFn kernels[4] = {
      &p256_field_probe_kernel<0>, &p256_field_probe_kernel<1>,
      &p256_field_probe_kernel<2>, &p256_field_probe_kernel<3>};
  if (n <= 0) return 0;
  if (op < 0 || op > 3 || blocks < 1 ||
      (long long)blocks * (PROBE_THREADS / 32) < (n + 31LL) / 32)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  kernels[op]<<<blocks, PROBE_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)a, (const uint4*)b, (uint4*)out, n);
  return (int)cudaGetLastError();
}
