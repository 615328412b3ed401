// KV7: the gate fold and in-order MVCC of one block: three grid-wide
// launches (phase 1), then a walk in one thread block (phase 2).
//
// Replaces: fabric_tpu/committer/device_validate.py:418
// DeviceValidator._program -> local (:433-498), the jitted gate+MVCC
// program of the reference's fused device validation.
//
// What it computes (exactly local's result, without its padding):
//   1. gate fold: m[e] = sum of verdict[sig_item] << sig_bit over the
//      sig lanes of entry e (the bits of one entry are distinct, so the
//      sum is an OR); entry e fails when tables[ent_off[e] + m[e]] == 0;
//      cre_ok = c_live && verdict[c_idx]; gate = !cre_ok ? 4 :
//      (any entry of the tx failed ? 10 : 0); a tx with no plan keeps its
//      pre code; code0 = 22 where gate == 0 and the lane status is BAD.
//   2. MVCC in tx order: a tx whose code is 0 checks each of its reads
//      against the in-block last writer of the read's key slot, if there
//      is one (has = !deleted, block = blk_num, txn = the writer tx), else
//      against the committed (c_has, c_blk, c_txn); a read with a version
//      must match it, a read without one must see no value; any miss
//      makes the code 11, and only a tx that passes applies its writes.
// Outputs: gate codes and final codes, uint8, one per tx.
//
// The reference keeps wseq = 1 + the largest global write-lane index per
// slot and rescans every read lane at every step of a fori_loop over the
// txs (O(T * R)).  Here the lanes come in tx order with per-tx CSR
// offsets (the wrapper checks the order), and the last-writer state of a
// slot is one int32, (tx + 1) << 1 | deleted, which is the same
// information: the last applied write to a slot is the one with the
// largest index, and a later tx's word is larger, so writes land with
// atomicMax.  Each read lane is reduced in phase 1 to one int32 that
// holds its committed verdict, whether it has a version, and the state
// word an in-block writer must have for it to pass.
//
// Phase 1, across the card, on the caller's stream after one memset of
// the entry masks and fail counts: kv7_fold_kernel (sig lanes into entry
// masks by atomicAdd; each read lane to its int32, each write lane to
// slot << 1 | deleted), kv7_entry_kernel (each failed entry adds one to
// its tx's fail count), kv7_gate_kernel (gate codes and code0).
//
// The multi-device branch (the reference's shard_map over a device list,
// device_validate.py:499-511) splits the sig lanes and the read lanes
// over shards and replicates the rest.  Each shard runs
// block_validate_fold_range_launch on its device: kv7_fold_range_kernel
// folds its sig lanes into a full-length partial entry mask (sig_ent
// indexes global entry rows) and reduces its read lanes to their int32
// codes.  The first shard's device then runs
// block_validate_finish_launch on the whole packed buffer, the k partial
// masks stacked [k, E] and the read codes gathered in global lane order:
// the write codes, kv7_entry_kernel summing the k masks (each sig lane
// lies in one shard, so the sum is the reference's psum of the masks),
// kv7_gate_kernel and the walk.  The reference's per-step psum of the
// read failures needs no exchange: every read lane of a tx is in the
// gathered codes, so the one walk sees the same sum.  Its bound adds to
// KV7's the packed lanes once more for each further distinct device and
// the copy of those devices' partial masks and codes to the first
// (ops/block_validate.py:sharded_bytes_moved); the depth term is the
// same, since the walk is one chain on one device.
//
// Phase 2, kv7_walk_kernel, one block of WALK_THREADS: warp 0 walks the
// txs in windows of WIN_T, which the other warps stage into shared
// memory one window ahead (two buffers; a window whose lanes exceed RCAP
// or WCAP is walked from device memory).  The walk decides a group of up
// to 32 txs a step, lane i owning tx g + i with its code, reads (slot
// and reduced code) and writes in registers:
//   - every code-0 lane stamps the slots it writes, atomicMax of
//     (group id << 5 | 31 - lane) into a hashed table of STAMPS words
//     that is never cleared (group ids only grow), so a slot's stamp
//     names the lowest lane of this group that writes a slot of its
//     bucket;
//   - every code-0 lane checks its reads against the state at the
//     group's start and, from the stamps, whether an earlier lane of
//     the group (a code-0 writer, whatever its fate) may write one of its
//     slots; such a lane is dependent (a shared bucket can only add
//     dependent lanes, never hide one);
//   - the dependent lanes are resolved in lane order, in registers: for
//     each read of lane d, every valid lane below d offers the word it
//     would write to that slot and __reduce_max_sync takes the largest
//     (the last writer's: a later tx's word is larger), else the read
//     sees the state at the group's start; a dependent lane never sees a
//     write of a lane above it;
//   - the group's valid writes land together by atomicMax, which keeps
//     the last writer whatever the order of landing.
// A tx with more than LANE_MAX reads or writes ends the group before it
// and is walked alone by the whole warp (the old per-tx step).  The
// last-writer state sits in shared memory beside the stamps and the two
// window buffers when the slots fit (block_validate_smem_slots: 42,236
// on an H100, 232,448 B a block), else in device memory.
//
// Bound on the H100.  Bytes: the packed lanes read once and the outputs
// written once, 4 B x (7T + 2 + 2E + 3S + 4R + 2W + 3K + |tables| + V)
// + 2T: about 1.8 MB for a 10,000-tx block of transfers, 0.5 us at
// 3.35 TB/s.  Steps: a walk must take one dependent step, at least one
// shared-memory round trip (~30 cycles), per link of the block's longest
// chain of txs each reading a slot whose last code-0 writer is the one
// before (the dependency depth, ops/block_validate.py:dep_depth).  The
// bound is the larger of the two.  The walk is far from it: one warp
// runs alone, so a group step costs the latencies of its dependent
// instructions and memory round trips, ~2,000 cycles (block 2 of
// chip_smoke.py's commit stream: ~0.39 ms a block against 3.44 ms for
// the one-tx-a-step walk before it, tools/kv7_ab.py on an H100,
// PERF.md).  Later work: the next group's loads overlapped with the
// current step, the verdicts taken straight from the P-256 kernels'
// output on the device, and a CUDA graph around the block's launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int FOLD_THREADS = 256;
constexpr int FOLD_BLOCKS_MAX = 132 * 8;
constexpr int WALK_THREADS = 512;
constexpr int WIN_T = 256;      // txs per window
constexpr int RCAP = 1024;      // staged read lanes per window
constexpr int WCAP = 1024;      // staged write lanes per window
constexpr int LANE_MAX = 8;     // reads and writes a lane holds
constexpr int STAMPS = 8192;    // hashed stamp words (a power of two)
constexpr int BUF_INTS = WIN_T + 2 * (WIN_T + 1) + 2 * RCAP + WCAP;
constexpr int STATUS_BAD = 2;
constexpr unsigned FULL = 0xffffffffu;

struct Lanes {
  // per tx
  const int32_t *pre, *status, *has_plan, *c_idx, *c_live, *r_off, *w_off;
  // per entry, per sig lane
  const int32_t *ent_tx, *ent_off, *sig_ent, *sig_item, *sig_bit;
  // per read, per write
  const int32_t *r_slot, *r_has, *r_blk, *r_txn, *w_slot, *w_del;
  // per slot
  const int32_t *c_has, *c_blk, *c_txn;
  const int32_t *tables, *verdict;
};

struct Scratch {
  int32_t *mask, *ent_fail, *rcode, *wcode, *gstate, *code0;
};

// --- phase 1 ---------------------------------------------------------------

// Read lane j reduced to one int32: the state word an in-block writer
// must hold for it to pass (written by tx txn of this block and not
// deleted; 0 matches no state, a state is > 0) << 2, whether it has a
// version << 1, and its verdict against the committed version.
__device__ __forceinline__ int read_code(const Lanes& L, int j, int T,
                                         int blk_num) {
  const int slot = L.r_slot[j];
  const int has = L.r_has[j], blk = L.r_blk[j], txn = L.r_txn[j];
  const int cok = has ? (L.c_has[slot] != 0 && L.c_blk[slot] == blk &&
                         L.c_txn[slot] == txn)
                      : (L.c_has[slot] == 0);
  const int want = (has && blk == blk_num && txn >= 0 && txn < T)
                       ? (txn + 1) << 1 : 0;
  return (want << 2) | (has ? 2 : 0) | cok;
}

__global__ void __launch_bounds__(FOLD_THREADS) kv7_fold_kernel(
    Lanes L, int S, int R, int W, int T, int blk_num, Scratch X) {
  const int stride = gridDim.x * blockDim.x;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  for (int s = i0; s < S; s += stride)
    atomicAdd(&X.mask[L.sig_ent[s]], L.verdict[L.sig_item[s]] << L.sig_bit[s]);
  for (int j = i0; j < R; j += stride)
    X.rcode[j] = read_code(L, j, T, blk_num);
  for (int j = i0; j < W; j += stride)
    X.wcode[j] = (L.w_slot[j] << 1) | (L.w_del[j] != 0);
}

// One shard's part of the fold: sig lanes [s_lo, s_hi) into the
// full-length entry mask `mask` (zeroed first), read lanes [r_lo, r_hi)
// into rcode[0, r_hi - r_lo).  T is the block's, not the shard's.
__global__ void __launch_bounds__(FOLD_THREADS) kv7_fold_range_kernel(
    Lanes L, int s_lo, int s_hi, int r_lo, int r_hi, int T, int blk_num,
    int32_t* __restrict__ mask, int32_t* __restrict__ rcode) {
  const int stride = gridDim.x * blockDim.x;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  for (int s = s_lo + i0; s < s_hi; s += stride)
    atomicAdd(&mask[L.sig_ent[s]], L.verdict[L.sig_item[s]] << L.sig_bit[s]);
  for (int j = r_lo + i0; j < r_hi; j += stride)
    rcode[j - r_lo] = read_code(L, j, T, blk_num);
}

// Each failed entry adds one to its tx's fail count; an entry's mask is
// the sum of its k partial masks, stacked [k, E] (k = 1: phase 1's own).
__global__ void __launch_bounds__(FOLD_THREADS) kv7_entry_kernel(
    Lanes L, int E, const int32_t* __restrict__ masks, int k, Scratch X) {
  const int stride = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < E; e += stride) {
    int m = 0;
    for (int i = 0; i < k; ++i) m += masks[(size_t)i * E + e];
    if (L.tables[L.ent_off[e] + m] == 0)
      atomicAdd(&X.ent_fail[L.ent_tx[e]], 1);
  }
}

__global__ void __launch_bounds__(FOLD_THREADS) kv7_gate_kernel(
    Lanes L, int T, Scratch X, uint8_t* __restrict__ gate_out) {
  const int stride = gridDim.x * blockDim.x;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < T; t += stride) {
    const bool cre_ok = L.c_live[t] != 0 && L.verdict[L.c_idx[t]] != 0;
    const int gate = !cre_ok ? 4 : (X.ent_fail[t] > 0 ? 10 : 0);
    const int gc = L.has_plan[t] ? gate : L.pre[t];
    gate_out[t] = (uint8_t)gc;
    X.code0[t] = (gc == 0 && L.status[t] == STATUS_BAD) ? 22 : gc;
  }
}

// --- phase 2 ---------------------------------------------------------------

// one window's staged lanes in shared memory; offsets are absolute
struct Win {
  int32_t *code, *roff, *woff, *rslot, *rcode, *wcode;
};

__device__ __forceinline__ Win win_at(int32_t* p) {
  Win w;
  w.code = p;
  w.roff = w.code + WIN_T;
  w.woff = w.roff + WIN_T + 1;
  w.rslot = w.woff + WIN_T + 1;
  w.rcode = w.rslot + RCAP;
  w.wcode = w.rcode + RCAP;
  return w;
}

// One window's codes and offsets, and its read and write lanes when they
// fit the buffers, by threads tid of nthr: the six arrays as one run of
// words, four loads in flight a thread, so that staging a window costs a
// few load round trips and hides behind the walk of the one before.
__device__ __forceinline__ void stage(const Lanes& L, const Scratch& X,
                                      Win w, int t0, int t1, int tid,
                                      int nthr) {
  const int ra = L.r_off[t0], wa = L.w_off[t0];
  int nr = L.r_off[t1] - ra, nw = L.w_off[t1] - wa;
  if (nr > RCAP || nw > WCAP) nr = nw = 0;  // walked from device memory
  const int nt = t1 - t0;
  const int32_t* src[6] = {X.code0 + t0, L.r_off + t0, L.w_off + t0,
                           L.r_slot + ra, X.rcode + ra, X.wcode + wa};
  int32_t* dst[6] = {w.code, w.roff, w.woff, w.rslot, w.rcode, w.wcode};
  const int len[6] = {nt, nt + 1, nt + 1, nr, nr, nw};
  const int total = 3 * nt + 2 + 2 * nr + nw;
  for (int j0 = tid; j0 < total; j0 += 4 * nthr) {
    int32_t v[4];
    int32_t* to[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int k = j0 + u * nthr;
      to[u] = nullptr;
      if (k >= total) continue;
      int a = 0;  // the array word k falls in; constant indices below,
                  // so src, dst and len stay in registers
#pragma unroll
      for (int q = 0; q < 5; ++q)
        if (a == q && k >= len[q]) {
          k -= len[q];
          a = q + 1;
        }
      const int32_t* from = src[0];
      to[u] = dst[0];
#pragma unroll
      for (int q = 1; q < 6; ++q)
        if (a == q) {
          from = src[q];
          to[u] = dst[q];
        }
      v[u] = __ldg(from + k);
      to[u] += k;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (to[u]) *to[u] = v[u];
  }
}

// a read (reduced code rc) against the slot's state word st
__device__ __forceinline__ bool read_ok(int st, int rc) {
  return st ? ((rc & 2) ? st == (rc >> 2) : (st & 1) != 0) : (rc & 1) != 0;
}

// a slot's state word: shared memory, or device memory past L1 (the
// walk's atomics land in L2)
template <bool SMEM>
__device__ __forceinline__ int load_state(const int32_t* state, int k) {
  return SMEM ? state[k] : __ldcg(state + k);
}

// warp 0: walk the txs [t0, t1) of one staged window (SMEM: the state in
// shared memory)
template <bool SMEM>
__device__ __forceinline__ void walk_window(const Lanes& L,
                                            const Scratch& X, Win w, int t0,
                                            int t1, int32_t* state,
                                            unsigned* stamps, unsigned& gid,
                                            uint8_t* __restrict__ final_out) {
  const int lane = threadIdx.x;
  const int ra = w.roff[0], wa = w.woff[0];
  const bool staged = w.roff[t1 - t0] - ra <= RCAP &&
                      w.woff[t1 - t0] - wa <= WCAP;  // as stage() chose
  const int32_t* rs = staged ? w.rslot : L.r_slot + ra;
  const int32_t* rc = staged ? w.rcode : X.rcode + ra;
  const int32_t* wc = staged ? w.wcode : X.wcode + wa;
  int g = t0;
  while (g < t1) {
    const int i = g - t0 + lane;
    const bool in = g + lane < t1;
    int code = 1, a = 0, nr = 0, c = 0, nw = 0;
    if (in) {
      code = w.code[i];
      a = w.roff[i] - ra;
      nr = w.roff[i + 1] - ra - a;
      c = w.woff[i] - wa;
      nw = w.woff[i + 1] - wa - c;
    }
    const unsigned wide =
        __ballot_sync(FULL, in && (nr > LANE_MAX || nw > LANE_MAX));
    if (wide & 1u) {
      // tx g alone, the whole warp on its lanes
      const int code_g = __shfl_sync(FULL, code, 0);
      int out = code_g;
      if (code_g == 0) {
        const int ri = __shfl_sync(FULL, a, 0);
        const int re = ri + __shfl_sync(FULL, nr, 0);
        bool bad = false;
        for (int j = ri + lane; j < re; j += 32)
          bad |= !read_ok(load_state<SMEM>(state, rs[j]), rc[j]);
        if (__any_sync(FULL, bad)) {
          out = 11;
        } else {
          const int wi = __shfl_sync(FULL, c, 0);
          const int we = wi + __shfl_sync(FULL, nw, 0);
          const int word = (g + 1) << 1;
          for (int j = wi + lane; j < we; j += 32) {
            const int v = wc[j];
            atomicMax(state + (v >> 1), word | (v & 1));
          }
        }
      }
      __syncwarp();
      if (lane == 0) final_out[g] = (uint8_t)out;
      g += 1;
      continue;
    }
    const int n = min(t1 - g, wide ? __ffs(wide) - 1 : 32);
    const bool act = lane < n;
    const bool live = act && code == 0;
    // One warp runs alone here, so a step costs its instructions'
    // latencies: every loop over a lane's reads or writes stops at the
    // group's most (mr, mw), not at LANE_MAX.
    const int mr = __reduce_max_sync(FULL, live ? nr : 0);
    const int mw = __reduce_max_sync(FULL, live ? nw : 0);
    int rsl[LANE_MAX], rcd[LANE_MAX], wcd[LANE_MAX], st0[LANE_MAX];
#pragma unroll
    for (int k = 0; k < LANE_MAX; ++k) rsl[k] = rcd[k] = wcd[k] = st0[k] = 0;
#pragma unroll
    for (int k = 0; k < LANE_MAX; ++k) {
      if (k >= mr) break;
      if (live && k < nr) {
        rsl[k] = rs[a + k];
        rcd[k] = rc[a + k];
      }
    }
#pragma unroll
    for (int k = 0; k < LANE_MAX; ++k) {
      if (k >= mw) break;
      if (live && k < nw) wcd[k] = wc[c + k];
    }
    ++gid;
    const unsigned mine = (gid << 5) | (unsigned)(31 - lane);
#pragma unroll
    for (int k = 0; k < LANE_MAX; ++k) {
      if (k >= mw) break;
      if (live && k < nw)
        atomicMax(stamps + ((wcd[k] >> 1) & (STAMPS - 1)), mine);
    }
    __syncwarp();
    // each read against the state at the group's start (st0), and whether
    // a lane below may write its slot
    bool dep = false, ok = true;
#pragma unroll
    for (int k = 0; k < LANE_MAX; ++k) {
      if (k >= mr) break;
      if (live && k < nr) {
        const unsigned st = stamps[rsl[k] & (STAMPS - 1)];
        dep |= (st >> 5) == gid && 31 - (int)(st & 31u) < lane;
        st0[k] = load_state<SMEM>(state, rsl[k]);
        ok &= read_ok(st0[k], rcd[k]);
      }
    }
    unsigned dmask = __ballot_sync(FULL, live && dep);
    unsigned vmask = __ballot_sync(FULL, live && !dep && ok);
    const int word = (g + lane + 1) << 1;
    // the dependent lanes in lane order: each read sees the last write to
    // its slot by a valid lane below it, forwarded in registers (the
    // largest word: a later tx's is larger), else the group's start
    while (dmask) {
      const int d = __ffs(dmask) - 1;
      const int nrd = __shfl_sync(FULL, nr, d);
      const bool below = ((vmask >> lane) & 1u) && lane < d;
      bool okd = true;
#pragma unroll
      for (int k = 0; k < LANE_MAX; ++k) {
        if (k >= nrd) break;
        const int slot = __shfl_sync(FULL, rsl[k], d);
        int mine_w = 0;
#pragma unroll
        for (int q = 0; q < LANE_MAX; ++q) {
          if (q >= mw) break;
          if (below && q < nw && (wcd[q] >> 1) == slot)
            mine_w = word | (wcd[q] & 1);
        }
        const int top = __reduce_max_sync(FULL, mine_w);
        okd &= read_ok(top ? top : st0[k], rcd[k]);
      }
      if (__shfl_sync(FULL, (int)okd, d)) vmask |= 1u << d;
      dmask &= dmask - 1;
    }
    // the group's valid writes land together
    if ((vmask >> lane) & 1u) {
#pragma unroll
      for (int k = 0; k < LANE_MAX; ++k) {
        if (k >= mw) break;
        if (k < nw) atomicMax(state + (wcd[k] >> 1), word | (wcd[k] & 1));
      }
    }
    __syncwarp();
    if (act)
      final_out[g + lane] =
          (uint8_t)(code != 0 ? code : ((vmask >> lane) & 1u) ? 0 : 11);
    g += n;
  }
}

// SMEM: the last-writer state in shared memory (else in device memory)
template <bool SMEM>
__global__ void __launch_bounds__(WALK_THREADS) kv7_walk_kernel(
    Lanes L, int T, int K, Scratch X, uint8_t* __restrict__ final_out) {
  extern __shared__ int32_t smem[];
  unsigned* stamps = (unsigned*)smem;
  int32_t* bufs = smem + STAMPS;
  int32_t* state = SMEM ? bufs + 2 * BUF_INTS : X.gstate;
  const int tid = threadIdx.x;
  for (int k = tid; k < STAMPS; k += WALK_THREADS) stamps[k] = 0;
  for (int k = tid; k < K; k += WALK_THREADS) state[k] = 0;
  stage(L, X, win_at(bufs), 0, min(T, WIN_T), tid, WALK_THREADS);
  __syncthreads();
  unsigned gid = 0;
  int b = 0;
  for (int t0 = 0; t0 < T; t0 += WIN_T, b ^= 1) {
    const int t1 = min(T, t0 + WIN_T);
    if (tid >= 32) {
      if (t1 < T)
        stage(L, X, win_at(bufs + (b ^ 1) * BUF_INTS), t1,
              min(T, t1 + WIN_T), tid - 32, WALK_THREADS - 32);
    } else {
      walk_window<SMEM>(L, X, win_at(bufs + b * BUF_INTS), t0, t1, state,
                        stamps, gid, final_out);
    }
    __syncthreads();
  }
}

Lanes lanes_of(const void* buf, int T, int E, int S, int R, int W, int K,
               int TB) {
  const int32_t* p = (const int32_t*)buf;
  Lanes L;
  L.pre = p; p += T;
  L.status = p; p += T;
  L.has_plan = p; p += T;
  L.c_idx = p; p += T;
  L.c_live = p; p += T;
  L.r_off = p; p += T + 1;
  L.w_off = p; p += T + 1;
  L.ent_tx = p; p += E;
  L.ent_off = p; p += E;
  L.sig_ent = p; p += S;
  L.sig_item = p; p += S;
  L.sig_bit = p; p += S;
  L.r_slot = p; p += R;
  L.r_has = p; p += R;
  L.r_blk = p; p += R;
  L.r_txn = p; p += R;
  L.w_slot = p; p += W;
  L.w_del = p; p += W;
  L.c_has = p; p += K;
  L.c_blk = p; p += K;
  L.c_txn = p; p += K;
  L.tables = p; p += TB;
  L.verdict = p;
  return L;
}

Scratch scratch_of(void* scratch, int T, int E, int R, int W, int K) {
  Scratch X;
  X.mask = (int32_t*)scratch;
  X.ent_fail = X.mask + E;
  X.rcode = X.ent_fail + T;
  X.wcode = X.rcode + R;
  X.gstate = X.wcode + W;
  X.code0 = X.gstate + K;
  return X;
}

template <bool SMEM>
int launch_walk(const Lanes& L, int T, int K, const Scratch& X,
                uint8_t* final_out, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kv7_walk_kernel<SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not sticky: clear it for the next launch
    return (int)err;
  }
  kv7_walk_kernel<SMEM><<<1, WALK_THREADS, smem, stream>>>(L, T, K, X,
                                                           final_out);
  return (int)cudaGetLastError();
}

// the walk, one block, its state in shared memory when smem_state is set
int walk(const Lanes& L, int T, int K, const Scratch& X, uint8_t* final_out,
         int smem_state, cudaStream_t stream) {
  const size_t smem = (size_t)(STAMPS + 2 * BUF_INTS + (smem_state ? K : 0)) *
                      sizeof(int32_t);
  return smem_state ? launch_walk<true>(L, T, K, X, final_out, smem, stream)
                    : launch_walk<false>(L, T, K, X, final_out, smem, stream);
}

int fold_blocks(int n) {
  return n <= 0 ? 1 : (int)std::min<long>((n + FOLD_THREADS - 1) / FOLD_THREADS,
                                          FOLD_BLOCKS_MAX);
}

}  // namespace

// The most key slots whose state fits in the current device's shared
// memory beside the stamps and the window buffers (-1 when the query
// fails).
extern "C" int block_validate_smem_slots(void) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return limit / (int)sizeof(int32_t) - (STAMPS + 2 * BUF_INTS);
}

// buf: the int32 lanes packed in the order of the Lanes struct (see
// fabric_tpu_torch/ops/block_validate.py:pack); out: 2T bytes, gate codes
// then final codes; scratch: E + T + R + W + K + T int32 (mask, fail
// counts, read and write codes, the state when smem_state is 0, code0).
// Phase 1: the memset and the three grid-wide launches.
extern "C" int block_validate_phase1_launch(const void* buf, int T, int E,
                                            int S, int R, int W, int K,
                                            int TB, int V, int blk_num,
                                            void* out, void* scratch,
                                            int smem_state, void* stream) {
  (void)V;
  (void)smem_state;
  if (T <= 0) return 0;
  const Lanes L = lanes_of(buf, T, E, S, R, W, K, TB);
  const Scratch X = scratch_of(scratch, T, E, R, W, K);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(X.mask, 0, sizeof(int32_t) * (E + T), st);
  if (err != cudaSuccess) return (int)err;
  kv7_fold_kernel<<<fold_blocks(std::max(S, std::max(R, W))), FOLD_THREADS, 0,
                    st>>>(L, S, R, W, T, blk_num, X);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  kv7_entry_kernel<<<fold_blocks(E), FOLD_THREADS, 0, st>>>(L, E, X.mask, 1,
                                                            X);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  kv7_gate_kernel<<<fold_blocks(T), FOLD_THREADS, 0, st>>>(L, T, X,
                                                          (uint8_t*)out);
  return (int)cudaGetLastError();
}

// Phase 2: the walk, one block (arguments as block_validate_launch).
extern "C" int block_validate_walk_launch(const void* buf, int T, int E,
                                          int S, int R, int W, int K, int TB,
                                          int V, int blk_num, void* out,
                                          void* scratch, int smem_state,
                                          void* stream) {
  (void)V;
  (void)blk_num;
  if (T <= 0) return 0;
  const Lanes L = lanes_of(buf, T, E, S, R, W, K, TB);
  const Scratch X = scratch_of(scratch, T, E, R, W, K);
  return walk(L, T, K, X, (uint8_t*)out + T, smem_state,
              (cudaStream_t)stream);
}

// Both phases on one stream: the wrapper's one call per block.
extern "C" int block_validate_launch(const void* buf, int T, int E, int S,
                                     int R, int W, int K, int TB, int V,
                                     int blk_num, void* out, void* scratch,
                                     int smem_state, void* stream) {
  const int err = block_validate_phase1_launch(buf, T, E, S, R, W, K, TB, V,
                                               blk_num, out, scratch,
                                               smem_state, stream);
  if (err) return err;
  return block_validate_walk_launch(buf, T, E, S, R, W, K, TB, V, blk_num,
                                    out, scratch, smem_state, stream);
}

// The multi-device branch, one shard: sig lanes [s_lo, s_hi) folded into
// mask (E int32, a full-length partial entry mask, zeroed here) and read
// lanes [r_lo, r_hi) reduced into rcode (r_hi - r_lo int32), on the
// shard's device and stream; buf is the whole block's packed buffer (its
// replica on that device).
extern "C" int block_validate_fold_range_launch(const void* buf, int T, int E,
                                                int S, int R, int W, int K,
                                                int TB, int V, int blk_num,
                                                int s_lo, int s_hi, int r_lo,
                                                int r_hi, void* mask,
                                                void* rcode, void* stream) {
  (void)V;
  if (s_lo < 0 || s_lo > s_hi || s_hi > S || r_lo < 0 || r_lo > r_hi ||
      r_hi > R)
    return (int)cudaErrorInvalidValue;
  if (T <= 0) return 0;
  const Lanes L = lanes_of(buf, T, E, S, R, W, K, TB);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (E > 0 &&
      (err = cudaMemsetAsync(mask, 0, sizeof(int32_t) * E, st)) != cudaSuccess)
    return (int)err;
  const int n = std::max(s_hi - s_lo, r_hi - r_lo);
  if (n == 0) return 0;
  kv7_fold_range_kernel<<<fold_blocks(n), FOLD_THREADS, 0, st>>>(
      L, s_lo, s_hi, r_lo, r_hi, T, blk_num, (int32_t*)mask, (int32_t*)rcode);
  return (int)cudaGetLastError();
}

// The multi-device branch, on the first shard's device: the write codes,
// the entry fold over the k partial masks (masks: [k, E] int32), the gate
// and the walk over the gathered read codes (rcode: R int32 in global lane
// order).  Other arguments as block_validate_launch; scratch's mask and
// read-code parts go unused.
extern "C" int block_validate_finish_launch(const void* buf, int T, int E,
                                            int S, int R, int W, int K,
                                            int TB, int V, int blk_num,
                                            void* out, void* scratch,
                                            int smem_state, const void* masks,
                                            int k, const void* rcode,
                                            void* stream) {
  if (T <= 0) return 0;
  if (k < 0) return (int)cudaErrorInvalidValue;
  const Lanes L = lanes_of(buf, T, E, S, R, W, K, TB);
  Scratch X = scratch_of(scratch, T, E, R, W, K);
  X.rcode = (int32_t*)rcode;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(X.ent_fail, 0, sizeof(int32_t) * T, st);
  if (err != cudaSuccess) return (int)err;
  // the write codes alone: no sig or read lane
  kv7_fold_kernel<<<fold_blocks(W), FOLD_THREADS, 0, st>>>(L, 0, 0, W, T,
                                                           blk_num, X);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  kv7_entry_kernel<<<fold_blocks(E), FOLD_THREADS, 0, st>>>(
      L, E, (const int32_t*)masks, k, X);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  kv7_gate_kernel<<<fold_blocks(T), FOLD_THREADS, 0, st>>>(L, T, X,
                                                          (uint8_t*)out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return walk(L, T, K, X, (uint8_t*)out + T, smem_state, st);
}
