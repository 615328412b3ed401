// Group multiply for Hopper (sm_90a): one lane's 256-bit Montgomery
// multiply, r = a * b * 2^-256 mod m, shared by a group of TPI threads of
// one warp (TPI = 4 or 8), after CGBN's threads-per-instance layout
// (NVlabs, "Cooperative Groups Big Numbers").
//
// Why.  KP1 and KF2 ran one thread a lane.  At the reference's 16,384
// lanes that is 128 blocks of 128 threads on 132 SMs, one warp a
// scheduler, and a Montgomery multiply's carry chain is serial: nothing
// hides its latency, and a multiply cost ~2,200 SM cycles where its 128
// multiply-adds need 256 issue cycles of one scheduler.  With TPI threads
// a lane, 16,384 lanes are 16,384 x TPI threads, and each row of the
// multiply is a short chain on 8 / TPI limbs.  The launcher takes TPI = 4
// (~15.5 warps an SM at 16,384 lanes): measured on an H100 it beat 8,
// whose one limb a thread puts the shift's shuffle on q's path.  So the
// kernels (field_chain.cu, field_chain_variants.cu) instantiate 4 only;
// the header keeps TPI = 8 (its L = 1 chains below), which only the CPU
// model of tests/test_torch_field_group.py runs.
//
// Layout.  Thread `rank` of a group holds limbs rank * L .. rank * L +
// L - 1 (L = 8 / TPI) of the distributed operand a, of the modulus and
// of the accumulator t, in registers.  The other operand enters as its 8
// words in every thread (`group_gather`: 8 shuffles; a chain whose
// multiplier is fixed gathers it once).  The group exchanges values with
// __shfl_sync (width TPI) and __ballot_sync; each names the whole warp
// (`Group`): with each group's own mask the warp ran the groups'
// exchanges apart and a multiply took ~1.9x as long (tools/field_ab.py
// on an H100).  So a kernel keeps whole warps alive: a group whose lane
// lies past the end repeats the last lane and stores nothing.
//
// A row (CIOS, one word b_i of b a row, eight rows):
//   1. t += b_i * a on each thread's limbs (grp_mul_row*: one carry
//      chain; the high word of the top limb and the carries go to two
//      boundary words z, z2 at the thread's position L).
//   2. the reduction word q: t_0 lives in rank 0, which forms q (generic:
//      t_0 * (-m^-1); mod p: t_0 itself; mod p25519: t_0 * 19^-1) and
//      broadcasts it (one shuffle);
//   3. the reduction, each modulus with its least work:
//        generic (P-256's n, BN254's p; KF2's presets but `min`): the q m
//          row on each thread's limbs (grp_red_row*, field_ptx.cuh's
//          ptx_red_row split over the group);
//        mod P-256's p: no q p row.  With q = t_0, (t + q p) / 2^32 adds
//          q at word 3, q at word 6, -q mod 2^32 at word 7 and q - [q > 0]
//          at word 8 (field_ptx.cuh ptx_red_p), and word 0 is dropped:
//          each thread adds the words of its positions (grp_add_words*);
//        mod p25519: with q = t_0 19^-1 and uh = floor(19 q / 2^32),
//          (t + q p) / 2^32 adds W = q 2^223 - uh at words 1..8, formed
//          from q as field_ptx.cuh ptx_red_25519 forms it, and word 0 is
//          dropped (grp_add_words*).
//   4. the shift by one word: each thread takes its upper neighbour's
//      t_0 (one shuffle down), and its own top limb becomes z + that word,
//      whose carry is the thread's new boundary word e (grp_shift).
//
// Carries are deferred (CGBN's redundant form): a row never ripples a
// carry across threads.  Each thread keeps one word e <= 3 at its position
// L, which belongs to the next thread's limb 0 (the top thread's e is the
// lane's word 8).  Bound: at a row's shift, the boundary value is at most
// e + two high words + four carries < 2^33 + 4, plus the neighbour's word:
// < 3 * 2^32 + 3, so e stays <= 3.  Once a multiply (`group_resolve`)
// each thread adds its lower neighbour's e (grp_add_small*); the rare
// carries that ripple on through threads of all-ones limbs come from two
// ballots (carry lookahead: with generate bits G and propagate bits P,
// the carries in are ((G | P) + G) ^ P), taken only when a ballot shows
// a carry out of some thread of the warp; the conditional subtraction of
// m resolves its borrows by the same lookahead.
//
// Reduction bounds: the result is fully reduced in [0, m) (LAZY false),
// or lazy in [0, 2^256) (LAZY true: m is subtracted only when bit 256 is
// set, KF2's relaxed presets).  Preconditions as field_ptx.cuh's: a <
// 2^256 and b < m, so that a b < m 2^256 and t < 2m after every row.  r
// may alias a (r is written after the last read of a).
//
// Work.  A row costs each thread one shuffle for q and one for the shift;
// a multiply adds one shuffle and three ballots (five when a deferred
// carry ripples out of a thread).  Deferring the carries keeps a row's
// chain inside one thread.  Measured (tools/field_ab.py, H100 80GB HBM3
// at 700 W, 16,384 lanes, TPI 4): a multiply costs 12.6 SM-cycles of
// the card mod n (a chain ~1,560 cycles a multiply), 11.8 mod BN254's p,
// 13.3 mod p and 18.6 mod p25519 (the special step's words are formed in
// every thread); least work: 2 mod p (PERF.md §6).
//
// Nothing goes to local memory: every array is indexed by constants
// after unrolling, the modulus words of a thread are read once from the
// constant bank by its rank (`group_mod`).  ptxas reports frame 0 and
// spills 0 for every instantiation (PERF.md §6).
//
// Every carry chain lives whole inside one asm statement, as in
// field_ptx.cuh.  tests/test_torch_field_group.py runs the PTX text of
// each statement below through the carry-semantics model of
// tests/test_torch_field_ptx.py, under a Python mirror of the C around
// it in which each thread has its own registers and each shuffle and
// ballot is an explicit exchange, and holds the result against ints.

#pragma once
#include <stdint.h>

#include "p256_field.cuh"

namespace fgroup {

using p256::MOD_BN254;
using p256::MOD_N;
using p256::MOD_P;
using p256::MOD_25519;

// the reduction a group multiply runs
enum { RED_GENERIC = 0, RED_P = 1, RED_25519 = 2 };

// each modulus's least-work reduction
template <int M>
struct least_red {
  static constexpr int value = M == MOD_P       ? RED_P
                               : M == MOD_25519 ? RED_25519
                                                : RED_GENERIC;
};

// a thread's place in its group.  Every exchange names the whole warp
// (width TPI keeps it inside the group): all the groups of a warp run
// the same multiply, each on its own lane, so every thread of the warp
// reaches each shuffle and ballot.  A kernel keeps whole warps alive.
template <int TPI>
struct Group {
  static_assert(TPI == 4 || TPI == 8, "a group is 4 or 8 threads");
  static constexpr uint32_t mask = 0xFFFFFFFFu;
  int rank;        // 0 .. TPI - 1
  int shift;       // the warp lane of rank 0
  __device__ __forceinline__ Group() {
    const int lane = threadIdx.x & 31;
    rank = lane & (TPI - 1);
    shift = lane - rank;
  }
};

// a thread's words of the modulus and of the special reductions, read
// once
template <int TPI>
struct GroupMod {
  static constexpr int L = 8 / TPI;
  uint32_t m[L];    // m's limbs rank * L + l
  uint32_t k0[L];   // the special reductions' words, by position
  uint32_t k1[L];
  uint32_t k2[L];
  uint32_t top;     // all ones in the top thread
  uint32_t below;   // all ones in every other thread
};

// the special reductions' words, by position relative to the row's word
// 0.  Mod p, k0 is the multiplier of q at each word: 1 at words 3 and 6,
// 2^32 - 1 at word 7, whose high half q - [q > 0] lands at word 8 (the
// top thread's boundary word: __umulhi(q, top)); (p + 1) / 2^32 spelled
// as words, with no product of q and p's own words.  Mod p25519, masks:
// k0 takes -uh (word 1), k1 the borrow words (2..6), k2 the low word of
// q 2^31 - [uh > 0] (word 7), `top` its high word (word 8).
template <int TPI, int M, int RED>
__device__ __forceinline__ GroupMod<TPI> group_mod(const Group<TPI>& g) {
  constexpr int L = 8 / TPI;
  GroupMod<TPI> gm;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int pos = g.rank * L + l;
    gm.m[l] = p256::mword<M>(pos);
    const bool p = RED == RED_P, x = RED == RED_25519;
    gm.k0[l] = p && (pos == 3 || pos == 6) ? 1u
               : (p && pos == 7) || (x && pos == 1) ? ~0u
                                                     : 0u;
    gm.k1[l] = x && pos >= 2 && pos <= 6 ? ~0u : 0u;
    gm.k2[l] = x && pos == 7 ? ~0u : 0u;
  }
  gm.top = g.rank == TPI - 1 ? ~0u : 0u;
  gm.below = ~gm.top;
  return gm;
}

// the group's bits of a ballot, rank 0 in bit 0
template <int TPI>
__device__ __forceinline__ uint32_t group_bits(const Group<TPI>& g,
                                               bool pred) {
  return (__ballot_sync(g.mask, pred) >> g.shift) & ((1u << TPI) - 1u);
}

// ---------------------------------------------------------------------------
// the chains, L = 1 (TPI = 8) and L = 2 (TPI = 4)
// ---------------------------------------------------------------------------

// t[0] += lo(w a[0]); z (in: e) += hi(w a[0]) + carry; z2 = the carry
__device__ __forceinline__ void grp_mul_row1(uint32_t* t, uint32_t& z,
                                             uint32_t& z2, uint32_t w,
                                             const uint32_t* a) {
  asm("mad.lo.cc.u32  %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32       %2, 0, 0;"
      : "+r"(t[0]), "+r"(z), "=r"(z2)
      : "r"(w), "r"(a[0]));
}

// t[0..1] += w a[0..1], one product at a time (its two halves adjacent,
// one wide multiply-add each): w a[0] into t[0..1], its carry into z
// (in: e <= 3, so no carry leaves z), then w a[1] into t[1] and z, whose
// carry is z2
__device__ __forceinline__ void grp_mul_row2(uint32_t* t, uint32_t& z,
                                             uint32_t& z2, uint32_t w,
                                             const uint32_t* a) {
  asm("mad.lo.cc.u32  %0, %4, %5, %0;\n\t"
      "madc.hi.cc.u32 %1, %4, %5, %1;\n\t"
      "addc.u32       %2, %2, 0;\n\t"
      "mad.lo.cc.u32  %1, %4, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %4, %6, %2;\n\t"
      "addc.u32       %3, 0, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(z), "=r"(z2)
      : "r"(w), "r"(a[0]), "r"(a[1]));
}

// the q m row: t[0] += lo(q m[0]); z += hi(q m[0]) + carry; z2 += carry
__device__ __forceinline__ void grp_red_row1(uint32_t* t, uint32_t& z,
                                             uint32_t& z2, uint32_t q,
                                             const uint32_t* m) {
  asm("mad.lo.cc.u32  %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32       %2, %2, 0;"
      : "+r"(t[0]), "+r"(z), "+r"(z2)
      : "r"(q), "r"(m[0]));
}

// the q m row on two limbs, one product at a time: q m[0] into t[0..1]
// (its carry through z into z2), then q m[1] into t[1] and z (the carry
// into z2)
__device__ __forceinline__ void grp_red_row2(uint32_t* t, uint32_t& z,
                                             uint32_t& z2, uint32_t q,
                                             const uint32_t* m) {
  asm("mad.lo.cc.u32  %0, %4, %5, %0;\n\t"
      "madc.hi.cc.u32 %1, %4, %5, %1;\n\t"
      "addc.cc.u32    %2, %2, 0;\n\t"
      "addc.u32       %3, %3, 0;\n\t"
      "mad.lo.cc.u32  %1, %4, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %4, %6, %2;\n\t"
      "addc.u32       %3, %3, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(z), "+r"(z2)
      : "r"(q), "r"(m[0]), "r"(m[1]));
}

// the special reductions' words: t[0] += w[0]; z += wl + carry; z2 += carry
__device__ __forceinline__ void grp_add_words1(uint32_t* t, uint32_t& z,
                                               uint32_t& z2,
                                               const uint32_t* w,
                                               uint32_t wl) {
  asm("add.cc.u32  %0, %0, %3;\n\t"
      "addc.cc.u32 %1, %1, %4;\n\t"
      "addc.u32    %2, %2, 0;"
      : "+r"(t[0]), "+r"(z), "+r"(z2)
      : "r"(w[0]), "r"(wl));
}

__device__ __forceinline__ void grp_add_words2(uint32_t* t, uint32_t& z,
                                               uint32_t& z2,
                                               const uint32_t* w,
                                               uint32_t wl) {
  asm("add.cc.u32  %0, %0, %4;\n\t"
      "addc.cc.u32 %1, %1, %5;\n\t"
      "addc.cc.u32 %2, %2, %6;\n\t"
      "addc.u32    %3, %3, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(z), "+r"(z2)
      : "r"(w[0]), "r"(w[1]), "r"(wl));
}

// the shift's top limb: top = z + x; e = z2 + carry
__device__ __forceinline__ void grp_shift(uint32_t& top, uint32_t& e,
                                          uint32_t z, uint32_t z2,
                                          uint32_t x) {
  asm("add.cc.u32 %0, %2, %4;\n\t"
      "addc.u32   %1, %3, 0;"
      : "=r"(top), "=r"(e)
      : "r"(z), "r"(z2), "r"(x));
}

// t[0] += c; g = the carry out
__device__ __forceinline__ void grp_add_small1(uint32_t* t, uint32_t& g,
                                               uint32_t c) {
  asm("add.cc.u32 %0, %0, %2;\n\t"
      "addc.u32   %1, 0, 0;"
      : "+r"(t[0]), "=r"(g)
      : "r"(c));
}

// t[0..1] += c; g = the carry out
__device__ __forceinline__ void grp_add_small2(uint32_t* t, uint32_t& g,
                                               uint32_t c) {
  asm("add.cc.u32  %0, %0, %3;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.u32    %2, 0, 0;"
      : "+r"(t[0]), "+r"(t[1]), "=r"(g)
      : "r"(c));
}

// d[0] -= m[0]; bo = 0 - the borrow (all ones when it borrowed)
__device__ __forceinline__ void grp_sub1(uint32_t* d, uint32_t& bo,
                                         const uint32_t* m) {
  asm("sub.cc.u32 %0, %0, %2;\n\t"
      "subc.u32   %1, 0, 0;"
      : "+r"(d[0]), "=r"(bo)
      : "r"(m[0]));
}

// d[0..1] -= m[0..1]; bo = 0 - the borrow
__device__ __forceinline__ void grp_sub2(uint32_t* d, uint32_t& bo,
                                         const uint32_t* m) {
  asm("sub.cc.u32  %0, %0, %3;\n\t"
      "subc.cc.u32 %1, %1, %4;\n\t"
      "subc.u32    %2, 0, 0;"
      : "+r"(d[0]), "+r"(d[1]), "=r"(bo)
      : "r"(m[0]), "r"(m[1]));
}

// d[0..1] -= c (the borrow out is the lookahead's)
__device__ __forceinline__ void grp_sub_small2(uint32_t* d, uint32_t c) {
  asm("sub.cc.u32 %0, %0, %2;\n\t"
      "subc.u32   %1, %1, 0;"
      : "+r"(d[0]), "+r"(d[1])
      : "r"(c));
}

template <int L>
__device__ __forceinline__ void grp_mul_row(uint32_t* t, uint32_t& z,
                                            uint32_t& z2, uint32_t w,
                                            const uint32_t* a) {
  if constexpr (L == 1)
    grp_mul_row1(t, z, z2, w, a);
  else
    grp_mul_row2(t, z, z2, w, a);
}

template <int L>
__device__ __forceinline__ void grp_red_row(uint32_t* t, uint32_t& z,
                                            uint32_t& z2, uint32_t q,
                                            const uint32_t* m) {
  if constexpr (L == 1)
    grp_red_row1(t, z, z2, q, m);
  else
    grp_red_row2(t, z, z2, q, m);
}

template <int L>
__device__ __forceinline__ void grp_add_words(uint32_t* t, uint32_t& z,
                                              uint32_t& z2,
                                              const uint32_t* w,
                                              uint32_t wl) {
  if constexpr (L == 1)
    grp_add_words1(t, z, z2, w, wl);
  else
    grp_add_words2(t, z, z2, w, wl);
}

template <int L>
__device__ __forceinline__ void grp_add_small(uint32_t* t, uint32_t& g,
                                              uint32_t c) {
  if constexpr (L == 1)
    grp_add_small1(t, g, c);
  else
    grp_add_small2(t, g, c);
}

template <int L>
__device__ __forceinline__ void grp_sub(uint32_t* d, uint32_t& bo,
                                        const uint32_t* m) {
  if constexpr (L == 1)
    grp_sub1(d, bo, m);
  else
    grp_sub2(d, bo, m);
}

template <int L>
__device__ __forceinline__ void grp_sub_small(uint32_t* d, uint32_t c) {
  if constexpr (L == 1)
    d[0] -= c;
  else
    grp_sub_small2(d, c);
}

// ---------------------------------------------------------------------------
// the multiply
// ---------------------------------------------------------------------------

// every thread gets x's 8 words (x distributed, L words a thread)
template <int TPI>
__device__ __forceinline__ void group_gather(uint32_t w[8],
                                             const uint32_t* x,
                                             const Group<TPI>& g) {
  constexpr int L = 8 / TPI;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    w[j] = __shfl_sync(g.mask, x[j % L], j / L, TPI);
}

// a thread's L words of a value every thread holds whole
template <int TPI>
__device__ __forceinline__ void group_own(uint32_t* x, const uint32_t w[8],
                                          const Group<TPI>& g) {
  constexpr int L = 8 / TPI;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j / L == g.rank) x[j % L] = w[j];
}

// t (L words a thread, with the boundary words e) -> r: the deferred
// carries added, then m subtracted when the value is >= m (LAZY: when
// bit 256 is set).  The value is < 2m.  r may alias t.
template <int TPI, bool LAZY>
__device__ __forceinline__ void group_resolve(uint32_t* r, uint32_t* t,
                                              uint32_t e,
                                              const Group<TPI>& g,
                                              const GroupMod<TPI>& gm) {
  constexpr int L = 8 / TPI;
  // each thread's e belongs to the next thread's limb 0; the top
  // thread's is the value's word 8
  const uint32_t up = __shfl_up_sync(g.mask, e, 1, TPI);
  uint32_t gen;
  grp_add_small<L>(t, gen, g.rank == 0 ? 0u : up);
  // a carry out of a thread's limbs ripples on through the threads whose
  // limbs are all ones: carry lookahead over the group, generate G and
  // propagate P (disjoint: a thread that carried out holds at most 3 in
  // its limbs).  Rare; the branch is the warp's, so it stays uniform.
  uint32_t carry_top = 0u;
  if (__ballot_sync(g.mask, gen != 0u) != 0u) {
    uint32_t ones = t[0];
#pragma unroll
    for (int l = 1; l < L; ++l) ones &= t[l];
    const uint32_t G = group_bits(g, gen != 0u);
    const uint32_t P = group_bits(g, ones == ~0u);
    const uint32_t S = (G | P) + G;
    uint32_t drop;
    grp_add_small<L>(t, drop, ((S ^ P) >> g.rank) & 1u);
    carry_top = (S >> TPI) & 1u;
  }
  // the value's bit 256, in the top thread: hi <= 1 since the value < 2m
  const uint32_t hi = (e + carry_top) & gm.top;
  // d = t - m, borrows by the same lookahead: generate = borrowed,
  // propagate = t's limbs equal m's.  The top thread's hi absorbs a
  // borrow: there hi = 1 neither generates nor propagates.  LAZY: with
  // hi = 0 the top generates, so that m is subtracted only when hi = 1.
  uint32_t d[L], bo;
#pragma unroll
  for (int l = 0; l < L; ++l) d[l] = t[l];
  grp_sub<L>(d, bo, gm.m);
  uint32_t diff = d[0];
#pragma unroll
  for (int l = 1; l < L; ++l) diff |= d[l];
  const bool force = LAZY && gm.top != 0u;
  const uint32_t GB = group_bits(g, hi == 0u && (bo != 0u || force));
  const uint32_t PB = group_bits(g, hi == 0u && diff == 0u && !force);
  const uint32_t SB = (GB | PB) + GB;
  grp_sub_small<L>(d, ((SB ^ PB) >> g.rank) & 1u);
  // d when nothing borrows out of the top
  const bool use_d = ((SB >> TPI) & 1u) == 0u;
#pragma unroll
  for (int l = 0; l < L; ++l) r[l] = use_d ? d[l] : t[l];
}

// r = a * b * 2^-256 mod m: a distributed (L words a thread), b's 8 words
// in every thread (group_gather); a < 2^256, b < m.  RED: the reduction
// (least_red<M> for each modulus's least work; KF2's generic presets run
// RED_GENERIC mod p).  LAZY: r in [0, 2^256), else in [0, m).  r may
// alias a.
template <int TPI, int M, int RED, bool LAZY>
__device__ __forceinline__ void group_mul(uint32_t* r, const uint32_t* a,
                                          const uint32_t bw[8],
                                          const Group<TPI>& g,
                                          const GroupMod<TPI>& gm) {
  constexpr int L = 8 / TPI;
  uint32_t t[L], e = 0u;
#pragma unroll
  for (int l = 0; l < L; ++l) t[l] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t z = e, z2;
    grp_mul_row<L>(t, z, z2, bw[i], a);
    if constexpr (RED == RED_GENERIC) {
      const uint32_t q =
          __shfl_sync(g.mask, t[0] * p256::minv<M>(), 0, TPI);
      grp_red_row<L>(t, z, z2, q, gm.m);
    } else if constexpr (RED == RED_P) {
      const uint32_t q = __shfl_sync(g.mask, t[0], 0, TPI);
      uint32_t w[L];
#pragma unroll
      for (int l = 0; l < L; ++l) w[l] = q * gm.k0[l];
      grp_add_words<L>(t, z, z2, w, __umulhi(q, gm.top));
    } else {
      const uint32_t q =
          __shfl_sync(g.mask, t[0], 0, TPI) * F25519_MINV;
      const uint32_t uh = __umulhi(q, 19u);
      const uint32_t b = uh != 0u ? 1u : 0u;
      const uint32_t w0 = 0u - uh;
      const uint32_t wm = 0u - b;
      const uint64_t v = ((uint64_t)q << 31) - b;
      const uint32_t w6 = (uint32_t)v;
      const uint32_t w7 = (uint32_t)(v >> 32);
      uint32_t w[L];
#pragma unroll
      for (int l = 0; l < L; ++l)
        w[l] = (w0 & gm.k0[l]) | (wm & gm.k1[l]) | (w6 & gm.k2[l]);
      grp_add_words<L>(t, z, z2, w, w7 & gm.top);
    }
    // word 0 is 0 mod 2^32 (generic) or dropped: shift down one word
    const uint32_t x = __shfl_down_sync(g.mask, t[0], 1, TPI) & gm.below;
#pragma unroll
    for (int l = 0; l + 1 < L; ++l) t[l] = t[l + 1];
    grp_shift(t[L - 1], e, z, z2, x);
  }
  group_resolve<TPI, LAZY>(r, t, e, g, gm);
}

// any value < 2m, distributed, exact words -> [0, m)
template <int TPI>
__device__ __forceinline__ void group_reduce(uint32_t* r, uint32_t* t,
                                             const Group<TPI>& g,
                                             const GroupMod<TPI>& gm) {
  group_resolve<TPI, false>(r, t, 0u, g, gm);
}

}  // namespace fgroup
