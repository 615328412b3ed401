// Edwards25519 point arithmetic for Hopper (sm_90a), four lanes a point:
// extended coordinates on the parallel formulas of Hisil, Wong, Carter
// and Dawson ("Twisted Edwards Curves Revisited", ASIACRYPT 2008, a = -1),
// the signed 7-bit comb over a niels table, the signed 4-bit window
// ladder over a cached table in shared memory, RFC 8032 decompression,
// the inversion chain and the recompression compare.  Shared by KE5
// (ed25519_verify.cu) and KE6 (ed25519_verify_rows.cu).
//
// Replaces: fabric_tpu/ops/edwards.py:add, dbl, add_niels, neg,
// comb_digits_signed, comb_accumulate, comb_accumulate_rows,
// ladder_digits, windowed_mul, decompress, batch_zinv and
// compressed_equals.  The plain PyTorch versions are in
// fabric_tpu_torch/ops/edwards.py.
//
// One signature takes a quad: four neighbouring lanes of a warp (8
// signatures a warp).  Lane j of the quad holds coordinate j of each
// running point (X, Y, Z, T), 8 words.  A point operation is two steps of
// four independent multiplies, one a lane, with __shfl_sync exchanges of
// 8-word values inside the quad (width 4) before and between them:
//
//   add (P + Q, Q cached: lane j holds component j of
//   (Y - X, Y + X, 2Z, 2dT)):   A = (Y1 - X1)(Y2 - X2), B = (Y1 + X1)
//                               (Y2 + X2), D = Z1 2Z2, C = T1 2dT2;
//   doubling:                   X^2, Y^2, Z^2, (X + Y)^2;
//   niels add (y - x, y + x, 2dxy): the add with 2Z2 = 2;
//
// then every lane reads the four results, forms E, F, G, H and lane j
// multiplies the pair of coordinate j of (EF, GH, FG, EH).  The serial
// part, decompression, runs on the four lanes side by side (KE5: A on
// lanes 0, 2, 3 and R on lane 1); Z^-1 is batched over the block.
//
// Values are Montgomery forms mod p = 2^255 - 19 with R = 2^256, fully
// reduced, multiplied by field_ptx.cuh's mul_25519 (p's special form on
// PTX carry chains) through one real call with 8-word values passed and
// returned in registers; adds and subtractions are p256_field.cuh's.  The
// reference keeps lazily reduced 22 x 12-bit limbs with R = 2^264; the
// values are the same.  The reference selects comb rows with one-hot
// f32 matmuls; here each lane of a quad loads its own component of its
// row (a quad's loads are one 96-byte row).  It inverts Z with a product
// tree over the batch; here KE6 inverts over its block by Montgomery's
// trick, the block's product by the binary extended Euclid, and KE5
// compares the sum with R decompressed, inverting nothing.

#pragma once
#include <stdint.h>

#include "field_ptx.cuh"

namespace ed25519 {

using namespace p256;

enum {
  COMB_WINDOWS = 37,
  COMB_ROWS = 65,
  ROW_WORDS = 24,
  LADDER_WINDOWS = 64,
  LADDER_ENTRIES = 9,                    // |digit| in 0..8, entry 0 = identity
  // one quad's ladder table in shared memory: LADDER_ENTRIES x 4
  // components x 8 words, the stride padded to 1 mod 32 words so that the
  // 8 quads of a warp read 32 different banks
  QUAD_TAB_WORDS = LADDER_ENTRIES * 4 * 8 + 1,
};

// the group order L, little-endian limbs
static __constant__ uint32_t C_ED_L[8] = {
    0x5CF5D3EDu, 0x5812631Au, 0xA2F79CD6u, 0x14DEF9DEu,
    0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u};
// d, 2d and sqrt(-1), Montgomery form mod p
static __constant__ uint32_t C_ED_D_MONT[8] = {
    0xDF47E9FAu, 0x80ED8BFEu, 0xAFC62973u, 0x10A18777u,
    0xBC188690u, 0xE5939207u, 0x729FC526u, 0x2C822B5Au};
static __constant__ uint32_t C_ED_D2_MONT[8] = {
    0xBE8FD3F4u, 0x01DB17FDu, 0x5F8C52E7u, 0x21430EEFu,
    0x78310D20u, 0xCB27240Fu, 0xE53F8A4Du, 0x590456B4u};
static __constant__ uint32_t C_ED_SQRTM1_MONT[8] = {
    0xFE2BDB04u, 0x3B5807D4u, 0xB51BE9EDu, 0x03F590FDu,
    0x336202D1u, 0x6D6E16BFu, 0xD6C71BA8u, 0x75776B0Bu};

typedef fe8 fe;

// ---------------------------------------------------------------------------
// the field, by value
// ---------------------------------------------------------------------------

__device__ __forceinline__ fe fe_of(const uint32_t* c) {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = c[j];
  return r;
}
// small integer k as a field element (not Montgomery form)
__device__ __forceinline__ fe fe_small(uint32_t k) {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = 0;
  r.w[0] = k;
  return r;
}
// Montgomery one and two: 2^256 mod p = 38, 2 * 38
__device__ __forceinline__ fe fq_one() { return fe_small(38u); }
__device__ __forceinline__ fe fq_two() { return fe_small(76u); }

__device__ __forceinline__ fe fq_mul(fe a, fe b) {
  return mul_25519_call(a, b);
}
__device__ __forceinline__ fe fq_sqr(fe a) { return mul_25519_call(a, a); }
__device__ __forceinline__ fe fq_add(fe a, fe b) {
  fe r;
  mod_add<MOD_25519>(r.w, a.w, b.w);
  return r;
}
__device__ __forceinline__ fe fq_sub(fe a, fe b) {
  fe r;
  mod_sub<MOD_25519>(r.w, a.w, b.w);
  return r;
}
__device__ __forceinline__ fe fq_neg(fe a) { return fq_sub(fe_small(0u), a); }
// Montgomery form -> canonical integer
__device__ __forceinline__ fe fq_from_mont(fe a) {
  return fq_mul(a, fe_small(1u));
}
__device__ __forceinline__ fe fe_sel(bool c, fe a, fe b) {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = c ? a.w[j] : b.w[j];
  return r;
}

// a /= 2 (a even) and x = x / 2 mod p (x < p: x + p when odd, < 2^256)
__device__ __forceinline__ void fe_halve_mod(uint32_t a[8], uint32_t x[8]) {
#pragma unroll
  for (int k = 0; k < 7; ++k) a[k] = __funnelshift_r(a[k], a[k + 1], 1);
  a[7] >>= 1;
  uint32_t pm[8];
  const uint32_t odd = 0u - (x[0] & 1u);
#pragma unroll
  for (int k = 0; k < 8; ++k) pm[k] = C_F25519[k] & odd;
  const uint32_t c = fe_add_raw(x, x, pm);
#pragma unroll
  for (int k = 0; k < 7; ++k) x[k] = __funnelshift_r(x[k], x[k + 1], 1);
  x[7] = (x[7] >> 1) | (c << 31);
}

__device__ __noinline__ fe fq_sqr_n(fe t, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) t = fq_sqr(t);
  return t;
}

// z^(2^250 - 1) and z^11: the head of ref10's fixed-exponent chains
// (fe_pow22523 here; edwards.py:_pow_2_250_1)
struct Pow250 {
  fe t1, z11;
};
__device__ __forceinline__ Pow250 pow_2_250_1(fe z) {
  fe t0 = fq_sqr(z);                                // 2
  fe t1 = fq_mul(z, fq_sqr_n(t0, 2));               // 9
  const fe z11 = fq_mul(t0, t1);                    // 11
  t1 = fq_mul(t1, fq_sqr(z11));                     // 2^5 - 1
  t1 = fq_mul(fq_sqr_n(t1, 5), t1);                 // 2^10 - 1
  fe t2 = fq_mul(fq_sqr_n(t1, 10), t1);             // 2^20 - 1
  t2 = fq_mul(fq_sqr_n(t2, 20), t2);                // 2^40 - 1
  t1 = fq_mul(fq_sqr_n(t2, 10), t1);                // 2^50 - 1
  t2 = fq_mul(fq_sqr_n(t1, 50), t1);                // 2^100 - 1
  t2 = fq_mul(fq_sqr_n(t2, 100), t2);               // 2^200 - 1
  t1 = fq_mul(fq_sqr_n(t2, 50), t1);                // 2^250 - 1
  return {t1, z11};
}

// z^((p - 5) / 8) = z^(2^252 - 3)
__device__ __noinline__ fe fq_pow22523(fe z) {
  const Pow250 h = pow_2_250_1(z);
  return fq_mul(fq_sqr_n(h.t1, 2), z);
}

// z^-1 for Montgomery z (z = a R -> a^-1 R; 0 < z < p) by the binary
// extended Euclid on the integers, variable time (verification handles
// public values only): u = z, v = p, x1 = 1, x2 = 0 with x1 z = u and
// x2 z = v mod p; halve the even one of u, v (and its x, adding p first
// when odd), subtract the smaller from the larger, until u or v is 1.
// About 2 x 255 halvings and half as many subtractions, 8-word ALU
// passes: on an H100 about 90 multiplies' latency, where ref10's Fermat
// chain is 265 multiplies (PERF.md).  The integer inverse z^-1 =
// a^-1 R^-1 times R^3 (38^3 = 54,872 mod p), by one Montgomery
// multiply, is a^-1 R.
__device__ __noinline__ fe fq_inv_vartime(fe z) {
  uint32_t u[8], v[8], x1[8], x2[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    u[k] = z.w[k];
    v[k] = C_F25519[k];
    x1[k] = k == 0 ? 1u : 0u;
    x2[k] = 0u;
  }
  for (;;) {
    while ((u[0] & 1u) == 0u) fe_halve_mod(u, x1);
    while ((v[0] & 1u) == 0u) fe_halve_mod(v, x2);
    bool u_one = u[0] == 1u, v_one = v[0] == 1u;
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      u_one = u_one && u[k] == 0u;
      v_one = v_one && v[k] == 0u;
    }
    if (u_one || v_one)
      return fq_mul(fe_of(u_one ? x1 : x2), fe_small(54872u));
    if (fe_lt(u, v)) {
      mod_sub<MOD_25519>(v, v, u);
      mod_sub<MOD_25519>(x2, x2, x1);
    } else {
      mod_sub<MOD_25519>(u, u, v);
      mod_sub<MOD_25519>(x1, x1, x2);
    }
  }
}

// ---------------------------------------------------------------------------
// the quad
// ---------------------------------------------------------------------------

__device__ __forceinline__ int quad_lane() { return threadIdx.x & 3; }

// lane src's value of v, within this lane's quad
__device__ __forceinline__ fe quad_read(fe v, int src) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v.w[j] = __shfl_sync(0xFFFFFFFFu, v.w[j], src, 4);
  return v;
}

// the quad's lane 0 ... 3 flags, ANDed
__device__ __forceinline__ bool quad_all(bool f) {
  uint32_t v = f ? 1u : 0u;
  v &= __shfl_xor_sync(0xFFFFFFFFu, v, 1, 4);
  v &= __shfl_xor_sync(0xFFFFFFFFu, v, 2, 4);
  return v != 0u;
}

// the common second step: lane j's coordinate of (EF, GH, FG, EH)
__device__ __forceinline__ fe quad_finish(int j, fe E, fe F, fe G, fe H) {
  const fe x = j == 1 ? G : j == 2 ? F : E;
  const fe y = j == 0 ? F : j == 2 ? G : H;
  return fq_mul(x, y);
}

// lane j's coordinate of the identity (0, 1, 1, 0)
__device__ __forceinline__ fe quad_identity() {
  const int j = quad_lane();
  return fe_sel(j == 1 || j == 2, fq_one(), fe_small(0u));
}

// P + Q (add-2008-hwcd-3, a = -1), complete: v is lane j's coordinate of
// P, c lane j's component of Q's cached form (Y - X, Y + X, 2Z, 2dT)
__device__ __noinline__ fe quad_add(fe v, fe c) {
  const int j = quad_lane();
  const fe o = quad_read(v, j ^ 1);        // lane 0 <- Y1, lane 1 <- X1
  const fe m = j == 0 ? fq_sub(o, v) : j == 1 ? fq_add(v, o) : v;
  const fe r = fq_mul(m, c);               // A, B, D = 2 Z1 Z2, C = 2d T1 T2
  const fe A = quad_read(r, 0), B = quad_read(r, 1);
  const fe D = quad_read(r, 2), C = quad_read(r, 3);
  return quad_finish(j, fq_sub(B, A), fq_sub(D, C), fq_add(D, C),
                     fq_add(B, A));
}

// 2P (dbl-2008-hwcd, a = -1), complete; T is not read
__device__ __noinline__ fe quad_dbl(fe v) {
  const int j = quad_lane();
  const fe X = quad_read(v, 0), Y = quad_read(v, 1);
  const fe r = fq_sqr(j == 3 ? fq_add(X, Y) : v);   // X^2, Y^2, Z^2, (X+Y)^2
  const fe A = quad_read(r, 0), B = quad_read(r, 1);
  const fe Z2 = quad_read(r, 2), S = quad_read(r, 3);
  const fe H = fq_add(A, B), G = fq_sub(A, B);
  return quad_finish(j, fq_sub(H, S), fq_add(fq_add(Z2, Z2), G), G, H);
}

// lane j's component of P's cached form (Y - X, Y + X, 2Z, 2dT)
__device__ __noinline__ fe quad_cached(fe v) {
  const int j = quad_lane();
  const fe o = quad_read(v, j ^ 1);
  const fe m = j == 0 ? fq_sub(o, v) : j == 1 ? fq_add(v, o)
             : j == 2 ? fq_add(v, v) : v;
  // lane 3 multiplies by 2d, the others by one
  return fq_mul(m, j == 3 ? fe_of(C_ED_D2_MONT) : fq_one());
}

// ---------------------------------------------------------------------------
// the signed comb (edwards.py:comb_digits_signed, comb_accumulate)
// ---------------------------------------------------------------------------

// acc + u * T over T's (37 x 65)-row niels table: window k's raw 7 bits
// plus the carry v in [0, 128]; v >= 64 gives the digit v - 128 and a
// carry into the next window (the last carry is dropped).  A negative
// digit swaps (y - x, y + x) and negates 2dxy after the lookup of row
// k*65 + |digit|; row k*65 is the identity.  u: little-endian limbs, any
// 256-bit value, shifted down 7 bits a window (no indexing by a running
// count, which would put it in local memory).  Lane j loads its
// component of the row's cached form (y - x, y + x, 2, 2dxy): lane 2's
// is the constant 2.
__device__ __forceinline__ fe quad_comb(fe acc,
                                        const uint32_t* __restrict__ table,
                                        const uint32_t u_in[8]) {
  const int j = quad_lane();
  uint32_t u[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) u[w] = u_in[w];
  uint32_t carry = 0;
#pragma unroll 1
  for (int k = 0; k < COMB_WINDOWS; ++k) {
    const uint32_t v = (u[0] & 0x7Fu) + carry;
#pragma unroll
    for (int w = 0; w < 7; ++w) u[w] = __funnelshift_r(u[w], u[w + 1], 7);
    u[7] >>= 7;
    const bool neg = v >= 64u;
    carry = neg ? 1u : 0u;
    const uint32_t mag = neg ? 128u - v : v;
    const uint32_t* row = table + ((size_t)k * COMB_ROWS + mag) * ROW_WORDS;
    // lane 0 reads y - x (y + x when negative), lane 1 the other, lane 3
    // 2dxy; lane 2 reads 2dxy too and keeps the constant
    const int col = j >= 2 ? 16 : ((j == 1) != neg ? 8 : 0);
    fe e;
#pragma unroll
    for (int w = 0; w < 8; ++w) e.w[w] = __ldg(row + col + w);
    if (j == 3 && neg) e = fq_neg(e);
    if (j == 2) e = fq_two();
    acc = quad_add(acc, e);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// the signed 4-bit window ladder (edwards.py:ladder_digits, windowed_mul)
// ---------------------------------------------------------------------------

// u * Q: v is lane j's coordinate of Q; tab this quad's QUAD_TAB_WORDS
// words of shared memory.  The table holds 0Q ... 8Q in cached form,
// lane j writing component j of each entry.  u is recoded into 64 digits
// in [-8, 7]: the nibbles of u + 0x88...8 less 8 (the add's carries are
// the recoding's), read MSB-first off the top of a register shifted up 4
// bits a window: 4 doublings and one complete add a window.  The carry
// out of the add (u >= 2^256 - 0x88...8) is a 65th digit, 1: the quad
// starts from Q, and the first window's doublings, skipped otherwise,
// run for every quad of the warp.  A negative digit reads entry |d| with
// (Y - X, Y + X) swapped and 2dT negated.  Every lane of the warp runs
// the same steps.
__device__ __forceinline__ fe quad_ladder(fe v, const uint32_t u[8],
                                          uint32_t* tab) {
  const int j = quad_lane();
  // the table: entry 0 the identity's cached form (1, 1, 2, 0), entry 1
  // Q, 2 = 2Q, e = (e - 1) Q + Q
  const fe e0 = j == 2 ? fq_two() : j == 3 ? fe_small(0u) : fq_one();
  const fe q1 = quad_cached(v);
  fe p = v;
#pragma unroll 1
  for (int e = 0; e < LADDER_ENTRIES; ++e) {
    if (e >= 2) p = e == 2 ? quad_dbl(v) : quad_add(p, q1);
    const fe c = e == 0 ? e0 : e == 1 ? q1 : quad_cached(p);
#pragma unroll
    for (int w = 0; w < 8; ++w) tab[(e * 4 + j) * 8 + w] = c.w[w];
  }
  __syncwarp();
  uint32_t d[8];
  uint64_t acc8 = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    acc8 += (uint64_t)u[w] + 0x88888888u;
    d[w] = (uint32_t)acc8;
    acc8 >>= 32;
  }
  const bool carry = acc8 != 0;
  fe acc = fe_sel(carry, v, quad_identity());
  const bool top = __any_sync(0xFFFFFFFFu, carry);
#pragma unroll 1
  for (int win = LADDER_WINDOWS - 1; win >= 0; --win) {
    if (win != LADDER_WINDOWS - 1 || top) {
#pragma unroll 1
      for (int i = 0; i < 4; ++i) acc = quad_dbl(acc);
    }
    const uint32_t nib = d[7] >> 28;
#pragma unroll
    for (int w = 7; w > 0; --w) d[w] = __funnelshift_l(d[w - 1], d[w], 4);
    d[0] <<= 4;
    const bool neg = nib < 8u;
    const uint32_t m = neg ? 8u - nib : nib - 8u;
    const int comp = neg && j < 2 ? j ^ 1 : j;
    fe c;
#pragma unroll
    for (int w = 0; w < 8; ++w) c.w[w] = tab[(m * 4 + comp) * 8 + w];
    if (neg && j == 3) c = fq_neg(c);
    acc = quad_add(acc, c);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// decompression and the recompression compare
// ---------------------------------------------------------------------------

struct Decoded {
  fe x, y;            // Montgomery form
  bool ok;
};

// RFC 8032 5.1.3 (edwards.py:decompress): y canonical integer limbs
// (< 2^255), sign 0/1 -> x, y Montgomery; ok is false for y >= p, a y
// with no x, or x = 0 with sign 1; the point is then garbage and the
// caller's verdict false.  Every lane of a quad runs it alike.
__device__ __forceinline__ Decoded ed_decompress(const uint32_t y[8],
                                                 int sign) {
  const fe ye = fe_of(y);
  const bool y_ok = fe_lt(y, C_F25519);
  const fe y_m = fq_mul(ye, fe_of(C_F25519_R2));    // to Montgomery form
  const fe y2 = fq_sqr(y_m);
  const fe u = fq_sub(y2, fq_one());                // y^2 - 1
  const fe v = fq_add(fq_mul(y2, fe_of(C_ED_D_MONT)), fq_one());  // d y^2 + 1
  const fe v3 = fq_mul(fq_sqr(v), v);               // v^3
  const fe uv7 = fq_mul(u, fq_mul(fq_sqr(v3), v));  // u v^7
  const fe pw = fq_pow22523(uv7);
  fe x = fq_mul(fq_mul(u, v3), pw);                 // u v^3 (u v^7)^((p-5)/8)
  const fe vx2 = fq_mul(v, fq_sqr(x));              // v x^2
  const bool root_ok = fe_eq(vx2.w, u.w);
  const bool root_neg = fe_eq(vx2.w, fq_neg(u).w);
  if (root_neg) x = fq_mul(x, fe_of(C_ED_SQRTM1_MONT));
  bool ok = y_ok && (root_ok || root_neg);
  const fe xc = fq_from_mont(x);
  const bool x_zero = fe_is_zero(xc.w);
  ok = ok && !(x_zero && sign == 1);
  if ((int)(xc.w[0] & 1u) != sign && !x_zero) x = fq_neg(x);
  return {x, y_m, ok};
}

// does the quad's point (v: lane j's coordinate) equal the encoding
// (y, sign)?  (edwards.py:compressed_equals) zi: Z^-1 (0 for Z = 0); y:
// canonical integer limbs; y >= p never matches, nor sign 1 with x = 0.
// Lane 0 checks x's parity, lane 1 y.
__device__ __forceinline__ bool quad_compressed_equals(fe v, fe zi,
                                                       const uint32_t y[8],
                                                       int sign) {
  const int j = quad_lane();
  const fe a = fq_from_mont(fq_mul(v, zi));         // lane 0 x, lane 1 y
  const bool mine = j == 0   ? (int)(a.w[0] & 1u) == sign
                    : j == 1 ? fe_lt(y, C_F25519) && fe_eq(a.w, y)
                             : true;
  return quad_all(mine);
}

// does the quad's point (v) equal (x, y), a decompressed encoding whose
// x and y lanes 0 and 1 hold (Montgomery form)?  X == x Z on lane 0, Y ==
// y Z on lane 1: no inversion.  Given that the encoding decompressed,
// this is compressed_equals: y fixes x up to its sign, which the parity
// of the encoding fixes.
__device__ __forceinline__ bool quad_equals_point(fe v, fe xy) {
  const int j = quad_lane();
  const fe zr = fq_mul(xy, quad_read(v, 2));
  return quad_all(j >= 2 || fe_eq(zr.w, v.w));
}

// Z^-1 for every quad of the block (Montgomery form; 0 for Z = 0) by
// Montgomery's trick, one inversion a block (KP3's block_inv_n, a quad a
// value; the inversion is fq_inv_vartime): z is the quad's Z on each of
// its lanes; a quad with use false
// (past n, or its verdict already false) or with Z = 0 brings 1, so that
// no quad's garbage reaches the block's product.  Every thread of the
// block calls it (it holds two barriers).
template <int WARPS>
__device__ __forceinline__ fe quad_block_inv(fe z, bool use) {
  __shared__ uint32_t tot[WARPS][8], before[WARPS][8], after[WARPS][8];
  __shared__ uint32_t inv[8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = lane >> 2;
  const bool zero = fe_is_zero(z.w);
  const fe v = fe_sel(use && !zero, z, fq_one());
  // inclusive prefix and suffix products over the warp's 8 quads
  fe pre = v, suf = v;
#pragma unroll 1
  for (int d = 1; d < 8; d <<= 1) {
    fe t = pre;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      t.w[k] = __shfl_up_sync(0xFFFFFFFFu, t.w[k], 4 * d);
    pre = fe_sel(q >= d, fq_mul(t, pre), pre);
    t = suf;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      t.w[k] = __shfl_down_sync(0xFFFFFFFFu, t.w[k], 4 * d);
    suf = fe_sel(q + d < 8, fq_mul(suf, t), suf);
  }
  if (lane == 28) {
#pragma unroll
    for (int k = 0; k < 8; ++k) tot[warp][k] = pre.w[k];
  }
  __syncthreads();
  // one thread: the warps' exclusive products and the block's inverse
  if (threadIdx.x == 0) {
    fe acc = fq_one();
#pragma unroll 1
    for (int w = WARPS - 1; w >= 0; --w) {
#pragma unroll
      for (int k = 0; k < 8; ++k) after[w][k] = acc.w[k];
      acc = fq_mul(fe_of(tot[w]), acc);
    }
    acc = fq_one();
#pragma unroll 1
    for (int w = 0; w < WARPS; ++w) {
#pragma unroll
      for (int k = 0; k < 8; ++k) before[w][k] = acc.w[k];
      acc = fq_mul(acc, fe_of(tot[w]));
    }
    acc = fq_inv_vartime(acc);
#pragma unroll
    for (int k = 0; k < 8; ++k) inv[k] = acc.w[k];
  }
  __syncthreads();
  // v^-1 = (products before v) (products after v) / (all products)
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    pre.w[k] = __shfl_up_sync(0xFFFFFFFFu, pre.w[k], 4);
    suf.w[k] = __shfl_down_sync(0xFFFFFFFFu, suf.w[k], 4);
  }
  pre = fq_mul(fe_of(before[warp]), fe_sel(q == 0, fq_one(), pre));
  suf = fq_mul(fe_sel(q == 7, fq_one(), suf), fe_of(after[warp]));
  const fe w = fq_mul(fq_mul(pre, suf), fe_of(inv));
  return fe_sel(zero, fe_small(0u), w);
}

}  // namespace ed25519
