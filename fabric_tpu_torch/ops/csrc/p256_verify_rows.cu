// KP3: ECDSA-P256 verification under device-resident keys, one
// signature per thread.
//
// Replaces: fabric_tpu/ops/p256_fixed.py:verify_words_rows (with
// _verify_core and ecp256.py:comb_accumulate_rows), the fixed-key row
// lane of fabric_tpu/bccsp/jaxtpu.py; for one key it is also
// p256_fixed.py:verify_words_fixed.
//
// Per signature: r, s in [1, n); low-S (s < (n-1)/2 + 1) when asked;
// w = s^-1 mod n (batched over the block); u1 = e*w, u2 = r*w mod n;
// u1*G by the 8-bit comb over G's (32 x 256)-entry affine table and
// u2*Q by the same comb over Q's table, which sits in slot slot[i] of
// the bank (digits LSB-first, digit 0 adds nothing); a complete add of
// the two; then X == r*Z^2 or (r + n < p and X == (r+n)*Z^2), with the
// result neither infinity nor Z == 0.  The key never reaches the device: the on-curve
// check happened once, when its table was built on the host, so there is
// no qx/qy range or curve check here.
//
// The TPU version packs signatures into an (R, C) grid whose rows share
// a key and selects table rows with one-hot f32 matmuls per row.  Here
// the batch is flat, key-major, with one int32 slot per signature: each
// thread loads row j*256 + d of its own key's table directly (64 B).
// Neighbouring threads mostly share a key, so their loads hit the same
// 512 KB table; the tables of a block's keys (67 of them, 33.5 MB) fit in
// the H100's 50 MB L2.
//
// Bound on the H100: integer multiply-adds.  The least work of a verify
// is about 62 mixed adds mod p and 6 multiplies mod n, with s^-1 batched
// (3 multiplies per signature, one Fermat chain per launch); the exact
// count for given u1, u2 is fabric_tpu_torch/ops/p256_fixed.py:
// field_ops_per_verify_rows, weighed by ops/field.py:IMADS against 64
// multiply-adds per SM per clock.  Each signature moves 101 bytes plus
// its share of the key tables read once.
//
// Design.  The per-thread state is two Jacobian points (no 16-entry
// table of Q as in KP2), so the frame stays small.  The field is
// field_ptx.cuh's PtxField, KP2's: the multiply mod p is mul_p_call, one
// real call with operands and result in registers, and mod n
// mont_mul_ptx inline.  s^-1 is batched over the thread block by
// Montgomery's trick (block_inv_n): each thread brings s in Montgomery
// form mod n (1 when s is refused or the thread lies past the batch),
// the warps take inclusive prefix and suffix products by shuffles, one
// thread multiplies the four warp totals and runs the block's one Fermat
// chain, and each thread gets s^-1 as (the products before it) x (the
// products after it) x the inverse: 17 multiplies mod n a signature in
// place of ~425.  The chain is ~380 dependent multiplies on each block's
// critical path, while the block's other threads wait at a barrier; on
// a block's 39,544 fixed-key signatures it still ran 1.28x faster than
// PtxField with a Fermat chain a thread, and 1.82x faster than the
// generic CIOS before it (tools/kp2_ab.py on an H100, PERF.md).  Later
// work: comb rows staged through shared memory per key run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field_ptx.cuh"
#include "p256_point.cuh"

using namespace p256;

// R mod n: Montgomery one mod n, what a refused thread brings
static __constant__ uint32_t C_N_ONE[8] = {
    0x039CDAAFu, 0x0C46353Du, 0x58E8617Bu, 0x43190552u,
    0x00000000u, 0x00000000u, 0xFFFFFFFFu, 0x00000000u};

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void mul_n(uint32_t r[8], const uint32_t a[8],
                                      const uint32_t b[8]) {
  mont_mul_ptx<MOD_N>(r, a, b);
}

// w = v^-1 for every thread of the block (Montgomery form mod n, v != 0
// and < n), by Montgomery's trick.  Every thread of the block calls it.
__device__ __forceinline__ void block_inv_n(uint32_t w[8],
                                            const uint32_t v[8]) {
  __shared__ uint32_t tot[WARPS][8], before[WARPS][8], after[WARPS][8];
  __shared__ uint32_t inv[8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // inclusive prefix and suffix products within the warp
  uint32_t pre[8], suf[8], t[8];
  fe_copy(pre, v);
  fe_copy(suf, v);
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int k = 0; k < 8; ++k) t[k] = __shfl_up_sync(FULL, pre[k], d);
    if (lane >= d) mul_n(pre, t, pre);
#pragma unroll
    for (int k = 0; k < 8; ++k) t[k] = __shfl_down_sync(FULL, suf[k], d);
    if (lane + d < 32) mul_n(suf, suf, t);
  }
  if (lane == 31) fe_copy(tot[warp], pre);
  __syncthreads();
  // one thread: the warps' exclusive products and the block's inverse
  if (threadIdx.x == 0) {
    uint32_t acc[8];
    fe_copy(acc, C_N_ONE);
#pragma unroll 1
    for (int k = WARPS - 1; k >= 0; --k) {
      fe_copy(after[k], acc);
      mul_n(acc, tot[k], acc);
    }
    fe_copy(acc, C_N_ONE);
#pragma unroll 1
    for (int k = 0; k < WARPS; ++k) {
      fe_copy(before[k], acc);
      mul_n(acc, acc, tot[k]);
    }
    mont_inv_ptx<MOD_N>(inv, acc);
  }
  __syncthreads();
  // v^-1 = (products before v) (products after v) / (all products)
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    pre[k] = __shfl_up_sync(FULL, pre[k], 1);
    suf[k] = __shfl_down_sync(FULL, suf[k], 1);
  }
  if (lane == 0) fe_copy(pre, C_N_ONE);
  if (lane == 31) fe_copy(suf, C_N_ONE);
  mul_n(pre, before[warp], pre);
  mul_n(suf, suf, after[warp]);
  mul_n(pre, pre, suf);
  mul_n(w, pre, inv);
}

}  // namespace

__global__ void __launch_bounds__(THREADS) p256_verify_rows_kernel(
    const uint32_t* __restrict__ rw, const uint32_t* __restrict__ sw,
    const uint32_t* __restrict__ ew, const int32_t* __restrict__ slot,
    const uint32_t* __restrict__ bank, const uint32_t* __restrict__ table,
    uint8_t* __restrict__ out, int n, int require_low_s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  uint32_t R[8], S[8], E[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) R[k] = S[k] = E[k] = 0;
  if (live) {
    load_be(R, rw, i, n);
    load_be(S, sw, i, n);
    load_be(E, ew, i, n);
  }

  // --- range checks (p256_fixed.py:43-47) ---
  const bool r_ok = !fe_is_zero(R) && fe_lt(R, C_N);
  bool s_ok = !fe_is_zero(S) && fe_lt(S, C_N);
  if (require_low_s) s_ok = s_ok && fe_lt(S, C_HALF_N_PLUS_1);

  // --- w = s^-1 over the block, then u1 = e w, u2 = r w mod n ---
  uint32_t w[8], u1[8], u2[8];
  if (live && s_ok)
    PtxField::n_to_mont(w, S);
  else
    fe_copy(w, C_N_ONE);
  block_inv_n(w, w);
  if (!live) return;
  mul_n(u1, E, w);
  mul_n(u2, R, w);

  // --- two fixed-base combs: u1*G over G's table, u2*Q over Q's ---
  const uint32_t* qtab = bank + (size_t)slot[i] * (32 * 256 * 16);
  Jac acc_g, acc_q, res;
  pt_comb<PtxField>(acc_g, table, u1);
  pt_comb<PtxField>(acc_q, qtab, u2);

  // --- complete combine, then the projective x check ---
  pt_add_complete<PtxField>(res, acc_g, acc_q);
  out[i] = (r_ok && s_ok && x_matches_r<PtxField>(res, R)) ? 1 : 0;
}

extern "C" int p256_verify_rows_launch(const void* r, const void* s,
                                       const void* e, const void* slot,
                                       const void* bank, const void* table,
                                       void* out, int n, int require_low_s,
                                       void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  p256_verify_rows_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)r, (const uint32_t*)s, (const uint32_t*)e,
      (const int32_t*)slot, (const uint32_t*)bank, (const uint32_t*)table,
      (uint8_t*)out, n, require_low_s);
  return (int)cudaGetLastError();
}
