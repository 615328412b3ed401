#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (fabric_tpu_torch).

Drives the port's main paths at the size of real blocks, holds every
hand-written kernel against its plain PyTorch version, times them, and
ends with one JSON line.  Phases:

1. device  — the card's name and power limit; aborts without CUDA
2. build   — nvcc builds every kernel from fabric_tpu_torch/ops/csrc/
             (KP1-KP3, KE5, KE6, KV7, KB8, KF2, KI3, one nvcc each, all at
             once), cc
             the C DER parser and the three CPython extensions (ftlv,
             fastparse, fastcollect) from fabric_tpu_torch/native/
3. field   — KP1 (field_mul_chain) against its plain version and Python
             ints, mod p, mod n, mod p25519 and mod BN254's p, edge values
             included; the field probe (p256_field_probe: field_ptx.cuh's
             mul_p, sqr_p and mont_mul_ptx mod n, KP2's, and mul_25519,
             KE5's and KE6's) on 65,536 seeded inputs
             plus edge values each, bit for bit against the plain field and
             Python ints, timed
3b. experiments — the counterparts of the Pallas microbenchmarks in
             experiments/ (fabric_tpu_torch.experiments, each module's
             run()): KP1 at the reference's R = 2^264 (proto_pallas.py) and
             KF2's presets relaxed, stacked (proto_pallas2.py), min
             (proto_pallas4.py), planes (proto_planes.py) and ilp
             (proto_ilp.py) on the scripts' data and grids, KI3's eight
             probes (proto_pallas3.py); at the reference's B = 16,384 and
             at a card-filling B = SMs x 2,048, each held against its plain
             version (the first 16,384 lanes) and Python ints (64 lanes),
             timed, with SM-cycles per multiply, SASS instructions per
             multiply (cuobjdump) and one warp's clock64 cycles per multiply
4. block   — 10,000 txs x (3 endorsements from 3 org keys + 1 creator
             signature from 64 clients) = 40,000 P-256 items, 2% of them
             corrupted (7 kinds), plus 64 Ed25519 items under one-off
             keys, through init_factories(FactoryOpts(default="CUDA")) ->
             batch_verify_async -> resolve(), twice: cold (the bank
             builds the 67 keys' tables) and warm (no builds).  Every
             verdict is checked against its label, a subset against the
             software provider, KP3 and KP2 against their plain versions;
             then a spill drill on a 500-tx block with two bank slots for
             three hot keys
5. ed25519 — BASELINE config 2 (bench.py:1150-1161): 10,000 Ed25519
             signatures over 64-byte messages under 8 keys, 2% corrupted
             (7 kinds), cold (8 table builds) and warm; BASELINE config 3
             (bench.py:1157): the block's first 20,000 P-256 endorsements
             and those 10,000 items as one batch; a generic load of 4,096
             Ed25519 items under keys of their own, 2% corrupted (5 kinds,
             bad encodings of A among them).  Verdicts against labels, a
             subset against the software provider, KE6 and KE5 against
             their plain versions on their whole batches (config 2's and
             config 3's KE6 batches, the generic load's KE5 batch)
6. commit  — the port's block path on the card: a stream of four
             blocks (block 0 seeds --commit-txs accounts in namespace
             cc; blocks 1 and 2 are --commit-txs transfers each, reading
             and writing two accounts, with 1% on 16 hot keys, 2% stale
             reads, 1% deletes read later in the block, 0.5% reads of
             absent keys, 1% bad creator and 1% bad endorsement
             signatures; block 3 holds --commit-last transfers, one with
             a range query), every tx endorsed by Org1-Org3 under
             AND('Org1.member','Org2.member','Org3.member') and created
             by one of 64 clients, signed in the spawn pool.  It goes
             through two stacks on the factory's CUDA provider:
             Committer -> TxValidator (deep path) -> DeviceValidator
             (KV7, window=16384) -> KVLedger (in memory, 8 state shards),
             and the same with the host gate and host MVCC.  Flags,
             metadata flags, state, history and commit hash must be equal
             between the two, the flags equal to the stream's labels,
             KV7 launched once per device-validated block, block 3
             demoted (range_query) and nothing else; KV7 against its
             plain version on blocks 1 and 2's lanes and on two variants
             of block 2's (every tx on one hot slot; every seventh tx
             wider than a lane of the walk), each with its dependency
             depth; KV7 timed on block 2 whole and by phase (the gate
             fold's grid-wide launches, the walk), with its bound from
             the depth; block 2 timed warm on fresh stacks, stage by
             stage, with one profiled run
7. times   — medians of repeated runs (CUDA events for kernels); each
             kernel's plain version is timed by its one comparison call
             on the path's own batch for that kernel; KP2 at two sizes,
             the block's whole device-bound batch and the path's own KP2
             batch (the lanes the provider sent to KP2 in the block runs),
             each against its plain version and the labels, with SM-cycles
             a multiply and registers, frame and spills from the build log;
             one large pinned host-to-device copy gives the link rate that
             bounds a table upload; KE5 on the block's 64 Ed25519 items
             and KE6 on 64 of config 2's signatures (against the plain
             version and the labels) give each one chain's cycles a
             multiply, and with the chain's length (`ed25519.chain_muls`)
             its chain floor, beside registers, frame and spills; the
             warm block and config 2 profiled in one session, each a
             labelled range, for the device's idle share
9. idemix  — (run after 7, before the kernels line) BASELINE config 4:
             the provider's idemix_pair_probe(128), green and red; a
             seeded load of 4,096 pairing checks under 2 issuers, 2%
             corrupted (3 kinds), KB8 against its plain version and the
             labels, timed; a block of 32 txs whose creators are idemix
             signers of two issuers (the port's idemixgen; a presentation
             over another payload, a forged credential and garbage among
             them), endorsed by Org1 under OR('Org1.member'), committed
             by two port stacks (the factory's CUDA provider and the SW
             provider, KV7 on in both): flags, state, history and commit
             hash equal, flags equal to the labels; KB8 against its plain
             version at the block's shape; the creators' items and two
             cross-issuer swaps through batch_verify against SW; the host
             collect, the enqueue, KB8 and one profiled block timed; KB8's
             tower probe, each routine (mul, sqr, cyc_sqr, mul_by_lines,
             pow_u, final_exp) on 4,096 seeded inputs bit for bit against
             its plain version, timed at 4,096 and at 30 inputs
10. mesh   — (run after 9, before the kernels line) parallel/mesh.py and
             its users on the card: node.warmup in a process of its own
             (every library built into build/warmup_probe/, then a block
             with nvcc and cc barred), entry(), dryrun_multichip(2) and
             (4), the warm block, config 2 and config 3 through the plain
             provider and meshes of one and two shards on cuda:0 (equal
             verdicts, one table build a key, one bank replica, launches a
             shard, times in turns, the mesh code's own host ms), the
             spill drill and KB8's 4,096 seeded checks on two shards, and
             a device trace of two warm blocks (capture_device_trace)
11. durable — (run after 10, before the kernels line) the commit stream
             of phase 6 through the port's stack on the factory's CUDA
             provider with KV7, on a durable ledger: KVLedger(root=
             build/durable/..., state_shards=8, snapshot_every=2; the
             reference's 256 cut so that whole checkpoints of the
             stream's state are written and recovered); (a) flags,
             metadata flags, state, history and commit hash equal phase
             6's in-memory KV7 stack after every block; (b) a spawned
             child reopens a copy at height 2, commits block 2 and is
             killed with SIGKILL once the block store's fsync of block 2
             is done, before the state commit; (c) the parent reopens it:
             the replay covers exactly block 2, state, history and commit
             hash equal memory's, then block 3 (demoted by its range
             query) commits on the reopened ledger; (d) config blocks at
             commit: a block endorsed by a new org's peer (Org4) is
             ENDORSEMENT_POLICY_FAILURE, a config update adding Org4
             (submitted by Org1's peer, signed by the Admins of
             Org1-Org3) commits through KP3 and KP2, the same kind of
             block is then valid, an unauthorized and a stale-sequence
             config tx are INVALID_CONFIG_TRANSACTION, the config history
             equal after a reopen; (e) host times: block 2's validate +
             commit on the durable and the in-memory ledger in turns,
             fsyncs by kind of file with their ms and bytes, the state
             WAL's appends, checkpoint writes, recovery on reopen.  Its
             launches are printed on its own lines
12. classic — (run after 11, before the kernels line) the default peer's
             commit tail: TxValidator's classic tail (key-level
             endorsement read from the ledger's state, sbe.statedb_lookup)
             with the verify-once cache (VerdictCache(65536)), no
             DeviceValidator, on the factory's CUDA provider.  (a) phase
             6's stream: flags, metadata flags, state, history and commit
             hash equal phase 6's host stack after every block, flags
             equal the labels, KP3/KP2 launches, items dispatched and
             cache hits and misses per block, no fallback; (b) block 3
             through the Python mirror of the C walker (collect_py),
             equal; (c) verify-once: a SpeculativeVerifier on the cache,
             its worker running, stamps block 2 in the reference
             gateway's batches of 64 and fills every item (none dropped
             from its queue); block 2 then commits with no item
             dispatched and no KP3/KP2 launch, equal; a flipped cached
             verdict is refused (mac) and that item re-verified; an
             epoch bump re-verifies every item; (d) a seeded SBE stream
             of three 1,000-tx blocks (key policies AND(Org1, Org2) and
             OR(Org2) set and deleted by about 5% of the txs, a
             same-block transition, a tx writing keys under both): flags
             equal the labels on a channel with V1_3_KeyLevelEndorsement
             and all valid on one without; (e) early abort
             (EarlyAbortAnalyzer) on blocks 2 and 3, on the classic and
             the KV7 tail: each doomed tx invalid without it and MVCC or
             phantom with it, every other flag equal, state and history
             equal, the commit hash equal unless a doomed tx's code
             differs, items dispatched with and without; (f) phase 9's
             idemix block through the classic tail, flags equal; (g)
             block 2 warm on fresh ledgers at height 2, the default
             peer's stack, the deep host and the deep KV7 stack and the
             default peer's after a speculative fill, in turns, stage by
             stage, and one profiled run of the default peer's.  Its
             main-path launches are counted apart (the kernels line's
             `classic_launches`)
13. window — (run after 12, before the kernels line) the cross-block
             commit window, (c) first: (a) phase 6's stream through
             PipelinedCommitter on KVLedger(commit_window=W), W 2 and 4,
             the parallel commit off and on (commit_workers=4,
             adaptive), on the deep host and the KV7 tail (four runs:
             each W with each tail, each with the parallel commit off and
             on), early abort on the window's pending overlay: after
             every block the flags
             (a doomed tx's MVCC or phantom where phase 6's is invalid),
             metadata flags, state, history and commit hash equal phase
             6's, each block's KP3/KP2 launches equal a serial run's, KV7
             demoted only as the reference does (`savepoint` with a
             predecessor in flight, `range_query`); the wavefront
             scheduler on the serial path, equal to phase 6, with its
             wave widths, workers and fallbacks; (b) (c)'s first stream on
             phase 11's durable configuration at W=4, its directory byte
             for byte the serial durable stack's; a retire failure injected
             in block 2 fails block 2's and block 3's futures, leaves the
             block store at blocks 0-1, and the redelivery finishes
             blocks 2 and 3 once each to the serial hash and directory;
             (c) the stream's wall time serial, W=2 and W=4, on memory
             and on the durable ledger, fresh ledgers, in turns, medians
             of at least 3 with the spread, each block's early and
             deferred txs, overlap_frac, the stages summed; the device
             idle share of the stream at W=4 (profiled in phase 7's
             session);
             (d) snapshot export (every file through serve_chunk),
             install into a fresh root, open: height, state, history and
             commit hash, blocks below the base pruned; phase 11's
             post-crash blocks on the KV7 stack over it to phase 11's
             commit hash; (e) the ACL gate on the CUDA provider, each
             decision equal to the software provider's, a config block
             through the pipeline retargeting peer/Propose to Admins at
             its boundary.  Its main-path launches are counted apart (the
             kernels line's `window_launches`)
8. kernels — one JSON line per the port's kernel table, then the result

Each main-path run (block cold and warm, config 2 cold and warm, config
3, the generic load, the commit stream through the KV7 stack, the idemix
probe, the idemix block through each stack, the idemix batch_verify) sets
every launch count to 0 just before it and reads the counts just after;
the block launches KP3, KP2 (the off-curve keys of the corrupted items)
and KE5, config 2 only KE6, config 3 KP3, KP2 and KE6, the generic load
KE5, the commit stream KP3 and KV7 (KP2 for clients below the fast-lane
threshold at small sizes), the idemix runs KB8 (and KV7 and the Org1
endorsements' P-256 lane in the block).  KP1, KF2 and KI3 are
benchmark kernels, the counterparts of experiments/, and KB8's tower
probe and KP2's field probe tests of their routines; they are on no main
path: their counts there are 0.  Phase 10's mesh providers are not the
main path either: their launches stay out of the kernels line, and its
[mesh] lines give them per provider, cell and shard; nor are phase 11's
durable runs, whose launches its [durable] lines give per run.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--txs N] [--ed N] [--gen N] [--trials K]
                          [--commit-txs N] [--commit-last N]

Any failed check raises, so the script exits non-zero and prints no
result line.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import random
import statistics
import subprocess
import sys
import time

SEED = 20240611
P25519 = 2**255 - 19
N_ORGS = 3
N_CLIENTS = 64
N_ED25519 = 64
CORRUPT_FRAC = 0.02
CORRUPT_KINDS = ("wrong_digest", "high_s", "r_zero", "s_eq_n",
                 "off_curve", "bad_der", "short_point")
HOST_REJECTED_KINDS = ("r_zero", "bad_der", "short_point")
# config 2 keeps every key decodable, so its keys all earn tables and
# only KE6 runs warm; the bad encodings of A ride the generic load
ED_CFG2_KINDS = ("ed_wrong_msg", "ed_flip_r_bit", "ed_s_plus_l",
                 "ed_swap_key", "ed_r_noncanon_y", "ed_r_y1_sign1",
                 "ed_bad_length")
ED_GEN_KINDS = ("ed_wrong_msg", "ed_s_plus_l", "ed_a_noncanon_y",
                "ed_a_y1_sign1", "ed_r_noncanon_y")
ED_KEYS = 8
FAST_THRESHOLD = 64             # the provider's default fast_key_threshold
SLICE = 4096
SW_SUBSET = 512
FIELD_LANES = 4096
PROBE_LANES = 65536            # inputs of each op of KP2's field probe
SMALL_BATCH = 64               # KE6's lone-chain batch (the block's KE5 64)
CHAIN_K = 256
SPILL_TXS = 500
H2D_BYTES = 1 << 28            # the one large copy that gives the link rate
FILL_THREADS_PER_SM = 2048     # the card-filling size of phase 3b: SMs x this
# the commit stream: the mix of blocks 1 and 2 (fractions of txs; the
# rest are plain transfers), its policy, and the validator's window
COMMIT_MIX = (("hot", 0.01), ("stale", 0.02), ("delete", 0.01),
              ("absent", 0.005), ("bad_creator", 0.01),
              ("bad_endorsement", 0.01))
COMMIT_HOT_KEYS = 16
COMMIT_POLICY = "AND('Org1.member', 'Org2.member', 'Org3.member')"
COMMIT_WINDOW = 16384
COMMIT_TS = 1_760_000_000
SHMEM_CYCLES = 30              # one shared-memory round trip, the walk's step
# the idemix phase: BASELINE config 4's probe batch (bench.py:1172-1183),
# the seeded load of pairing checks and its corrupted kinds, and the
# block of idemix creators (its corrupted txs by position)
DURABLE_SHARDS = 8
DURABLE_SNAPSHOT_EVERY = 2     # the reference's 256, cut (phase 11)
DURABLE_ORG4_TXS = 256
ORG4_POLICY = "AND('Org1.member', 'Org4.member')"
IDEMIX_PROBE = 128
IDEMIX_CHECKS = 4096
PAIR_KINDS = ("x_plus_1", "other_slot", "swapped")
IDEMIX_TXS = 32
IDEMIX_SIGNERS = 2             # per issuer, two issuers
IDEMIX_BAD = {5: "nonce", 13: "forged", 21: "garbage"}
IDEMIX_POLICY = "OR('Org1.member')"
# the default peer's tail (phase 12): the verify-once cache's capacity
# (the reference peer's default), the SBE stream's blocks and txs, its
# chaincode policy (either org), its key policies by name, and the share
# of its txs that set or delete a key policy
CACHE_CAPACITY = 65536
# envelopes a gateway batch hands to the speculative verifier: the
# reference gateway's default max_batch (fabric_tpu/gateway/service.py:72)
SPEC_BATCH = 64
SPEC_DRAIN_S = 300.0         # bound on the worker's drain after a fill
SBE_BLOCKS = 3
SBE_TXS = 1000
SBE_CC_POLICY = "OR('Org1.member', 'Org2.member')"
SBE_POLICIES = {"and": "AND('Org1.member', 'Org2.member')",
                "org2": "OR('Org2.member')"}
SBE_POLICY_FRAC = 0.05
# phase 13: the commit windows driven (W blocks admitted but not
# retired), the wavefront scheduler's worker cap (the reference's
# commit_workers default) and the KV7 demotion reasons the reference
# gives for a windowed block (device_validate.py:218-220: a predecessor
# still in flight; block 3's range query)
WINDOWS = (2, 4)
# (W, parallel commit, KV7 tail) of phase 13 (a)'s pipelined runs: each
# W with each tail once, and each with the parallel commit off and on
WINDOW_RUNS = ((2, False, False), (2, True, True), (4, False, True),
               (4, True, False))
WINDOW_WORKERS = 4
WINDOW_DEMOTIONS = ("savepoint", "range_query")

# H100 SXM rates: HBM 3.35 TB/s (data sheet); 32-bit integer multiply-add
# 64 per SM per clock (CUDA C Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) times the card's SMs and max clock
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_SM_PER_CLOCK = 64


def _sign_job(job):
    """Worker: (scalar, [32-byte digests]) -> [(r, s)]."""
    from fabric_tpu_torch import crypto
    d, digests = job
    key = crypto.p256_key_from_scalar(d)
    return [crypto.p256_sign_digest(key, dg) for dg in digests]


def _ed_sign_job(job):
    """Worker: [(seed, message)] -> [(public key, signature)]."""
    from fabric_tpu_torch import crypto
    keys, out = {}, []
    for seed, msg in job:
        key = keys.get(seed)
        if key is None:
            key = keys[seed] = crypto.ed25519_key_from_seed(seed)
        out.append((crypto.ed25519_public_bytes(key),
                    crypto.ed25519_sign(key, msg)))
    return out


class _Signer:
    """A picklable stand-in for a SigningIdentity in the spawn pool: the
    identity's serialized bytes and its P-256 scalar.  `corrupt` signs
    a different message, so the signature does not verify."""

    def __init__(self, ident: bytes, d: int, corrupt: bool = False):
        self.ident, self.d, self.corrupt = ident, d, corrupt

    def serialize(self) -> bytes:
        return self.ident

    def sign(self, msg: bytes) -> bytes:
        from fabric_tpu_torch import crypto
        from fabric_tpu_torch.bccsp.sw import low_s
        key = _KEYS.get(self.d)
        if key is None:
            key = _KEYS[self.d] = crypto.p256_key_from_scalar(self.d)
        digest = hashlib.sha256(msg + (b"!" if self.corrupt else b"")
                                ).digest()
        return crypto.encode_dss_signature(
            *low_s(*crypto.p256_sign_digest(key, digest)))


_KEYS: dict = {}


class _IdemixCreator:
    """A picklable idemix creator for the spawn pool: a signing identity
    and how its signature is corrupted (None; "nonce": a presentation
    over another payload; "garbage": bytes that do not decode)."""

    def __init__(self, signer, corrupt: str = None):
        self.signer, self.corrupt = signer, corrupt

    def serialize(self) -> bytes:
        return self.signer.serialize()

    def sign(self, msg: bytes) -> bytes:
        if self.corrupt == "garbage":
            return b"\x01\x02\x03"
        return self.signer.sign(msg + (b"!" if self.corrupt == "nonce"
                                       else b""))


def _envelope_job(job):
    """Worker: (signers, [tx spec]) -> [serialized envelope].  A spec is
    (creator, [endorsers], nonce, reads, writes, ranges, corrupt), the
    first two as indices into signers; corrupt is None, "creator" or
    "endorsement"."""
    from fabric_tpu_torch.protocol import (Envelope, KVRead, KVWrite,
                                           NsRwSet, RangeQueryInfo,
                                           TxRwSet, Version, build)
    signers, specs = job
    out = []
    for creator, endorsers, nonce, reads, writes, ranges, corrupt in specs:
        rws = TxRwSet((NsRwSet(
            "cc",
            reads=tuple(KVRead(k, None if v is None else Version(*v))
                        for k, v in reads),
            writes=tuple(KVWrite(k, val, dl) for k, val, dl in writes),
            range_queries=tuple(RangeQueryInfo(a, b, ex, ())
                                for a, b, ex in ranges)),))
        ends = [signers[e] for e in endorsers]
        if corrupt == "endorsement":
            e = ends[-1]
            ends[-1] = _Signer(e.ident, e.d, corrupt=True)
        env = build.endorser_tx("ch", "cc", "1.0", rws, signers[creator],
                                ends, nonce=nonce, timestamp=COMMIT_TS)
        if corrupt == "creator":
            # the signature's last two bytes, the low bytes of s, set to
            # 00 01, or to 00 02 where they already were 00 01
            tail = b"\x00\x02" if env.signature.endswith(b"\x00\x01") \
                else b"\x00\x01"
            env = Envelope(env.payload, env.signature[:-2] + tail)
        out.append(env.serialize())
    return out


_PHASE_S = {}                  # seconds by phase: each line's own, since
_LAST_LINE = [time.perf_counter()]  # the line before it


def phase(tag: str, **kv) -> None:
    now = time.perf_counter()
    _PHASE_S[tag] = _PHASE_S.get(tag, 0.0) + now - _LAST_LINE[0]
    _LAST_LINE[0] = now
    extra = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{tag}] {extra}".rstrip(), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def median_ms(fn, trials: int, warm: bool = True) -> float:
    """Median wall ms of fn() after one warm-up (unless the caller has
    just made that call); fn synchronises."""
    if warm:
        fn()
    out = []
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def event_ms(torch, fn, trials: int) -> float:
    """Median device ms of fn() by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def kernel_launcher(torch, lib_name: str, args, n: int):
    """The C entry point of csrc/<lib_name>.cu on args (device tensors)
    and a fresh (n,) bool output, on the current stream, without the
    wrapper's checks and copies -> a callable that launches once and
    returns the output (a timing launch: no count)."""
    import ctypes
    from fabric_tpu_torch.ops import _build
    fn = getattr(_build.load(lib_name), f"{lib_name}_launch")
    dev = args[0].device

    def run():
        out = torch.empty(n, dtype=torch.bool, device=dev)
        rc = fn(*[ctypes.c_void_p(a.data_ptr()) for a in args],
                ctypes.c_void_p(out.data_ptr()), ctypes.c_int(n),
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        check(rc == 0, f"{lib_name} launch failed: CUDA error {rc}")
        return out
    return run


def device_busy(torch, runs: dict) -> dict:
    """One profiled session over labelled runs, {label: fn} (each fn
    synchronises): -> {label: (device busy ms, wall ms, the three ops
    with the most device time)}.  Each run is a range of its own
    (`record_function`), which the profiler also spans on the device
    over the work launched inside it; a run's busy time is the sum of
    the device events (kernels, copies, memsets) that start inside its
    device span, so the host's and the device's clocks are never
    compared; one stream, so nothing overlaps.  In this process CUPTI
    starts recording some tens of ms after the session starts (on an
    H100: no CUDA call nor device event in the first 25-47 ms, so a run
    shorter than that recorded nothing), so the session first launches a
    marker for `profiling.MARKER_S` in a range of its own
    (`profiling.marker_warmup`); it fails unless the marker was
    recorded, or if a run records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from fabric_tpu_torch.ops_plane.profiling import MARKER, marker_warmup
    walls = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        marker_warmup("busy:" + MARKER)
        for label, fn in runs.items():
            with record_function("busy:" + label):
                t0 = time.perf_counter()
                fn()
                walls[label] = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = {e.name[5:]: e.time_range for e in device
             if e.name.startswith("busy:")}
    check(MARKER in spans, "device_busy: the marker was not recorded: the "
          "profiler was not yet recording")
    out = {}
    for label in runs:
        check(label in spans, f"device_busy: {label}: the profiler recorded "
              "no device time")
        span, per_op = spans[label], {}
        for e in device:
            if not e.name.startswith("busy:") and \
                    span.start <= e.time_range.start <= span.end:
                per_op[e.name] = per_op.get(e.name, 0) + (
                    e.time_range.end - e.time_range.start)
        busy_ms = sum(per_op.values()) / 1e3
        check(busy_ms > 0, f"device_busy: {label}: the profiler recorded no "
              "device time")
        top = sorted(per_op.items(), key=lambda kv: -kv[1])[:3]
        out[label] = (busy_ms, walls[label],
                      [f"{k[:40]}:{us / 1e3:.3f}ms" for k, us in top])
    return out


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def build_block(n_txs: int, pool):
    """-> (items, labels, kinds): P-256 endorsements + creators, then the
    Ed25519 items; kinds[i] is the corruption kind or None."""
    from fabric_tpu_torch import crypto
    from fabric_tpu_torch.bccsp import (SCHEME_ED25519, SCHEME_P256,
                                        VerifyItem)
    from fabric_tpu_torch.ops.field import N, P

    rng = random.Random(SEED)
    scalars = [rng.randrange(1, N) for _ in range(N_ORGS + N_CLIENTS)]
    pubs = [crypto.p256_public_bytes(crypto.p256_key_from_scalar(d))
            for d in scalars]
    owners, digests = [], []
    for t in range(n_txs):
        txid = hashlib.sha256(b"tx" + t.to_bytes(8, "big")
                              + rng.randbytes(16)).digest()
        for org in range(N_ORGS):
            owners.append(org)
            digests.append(hashlib.sha256(b"endorse" + txid
                                          + bytes([org])).digest())
        owners.append(N_ORGS + rng.randrange(N_CLIENTS))
        digests.append(hashlib.sha256(b"envelope" + txid).digest())
    by_key = {}
    for i, k in enumerate(owners):
        by_key.setdefault(k, []).append(i)
    jobs, slots = [], []
    for k, idxs in sorted(by_key.items()):
        for lo in range(0, len(idxs), 500):
            part = idxs[lo:lo + 500]
            jobs.append((scalars[k], [digests[i] for i in part]))
            slots.append(part)
    sigs = [None] * len(owners)
    for part, res in zip(slots, pool.map(_sign_job, jobs)):
        for i, (r, s) in zip(part, res):
            sigs[i] = (r, min(s, N - s))

    n = len(owners)
    kinds = [None] * n
    bad = rng.sample(range(n), max(len(CORRUPT_KINDS),
                                   int(n * CORRUPT_FRAC)))
    for j, i in enumerate(bad):
        kinds[i] = CORRUPT_KINDS[j % len(CORRUPT_KINDS)]
    items, labels = [], []
    for i in range(n):
        pk, dg, (r, s) = pubs[owners[i]], digests[i], sigs[i]
        kind = kinds[i]
        sig = None
        if kind == "wrong_digest":
            dg = bytes([dg[0] ^ 0x01]) + dg[1:]
        elif kind == "high_s":
            s = N - s
        elif kind == "r_zero":
            r = 0
        elif kind == "s_eq_n":
            s = N
        elif kind == "off_curve":
            qy = (int.from_bytes(pk[33:], "big") + 1) % P
            pk = pk[:33] + qy.to_bytes(32, "big")
        elif kind == "bad_der":
            sig = crypto.encode_dss_signature(r, s)[:-1]
        elif kind == "short_point":
            pk = pk[:33]
        if sig is None:
            sig = crypto.encode_dss_signature(r, s)
        items.append(VerifyItem(SCHEME_P256, pk, sig, dg))
        labels.append(kind is None)
    for j in range(N_ED25519):
        key = crypto.ed25519_key_from_seed(rng.randbytes(32))
        msg = rng.randbytes(rng.randrange(1, 200))
        sig = crypto.ed25519_sign(key, msg)
        ok = j % 8 != 3
        if not ok:
            msg = msg + b"!"
        items.append(VerifyItem(SCHEME_ED25519,
                                crypto.ed25519_public_bytes(key), sig, msg))
        labels.append(ok)
        kinds.append(None if ok else "ed25519_wrong_msg")
    return items, labels, kinds


def build_ed25519(n: int, n_keys: int, kinds, seed: int, pool):
    """n Ed25519 items over 64-byte messages (bench.py:gen_ed25519_sigs)
    under n_keys keys in turn (0: a key of its own each), CORRUPT_FRAC of
    them corrupted in `kinds` -> (items, labels, kinds)."""
    from fabric_tpu_torch.bccsp import SCHEME_ED25519, VerifyItem
    from fabric_tpu_torch.ops.ed25519 import L
    rng = random.Random(seed)
    seeds = [rng.randbytes(32) for _ in range(n_keys or n)]
    msgs = [rng.randbytes(64) for _ in range(n)]
    pairs = [(seeds[i % len(seeds)], msgs[i]) for i in range(n)]
    signed = []
    for res in pool.map(_ed_sign_job, [pairs[lo:lo + 500]
                                       for lo in range(0, n, 500)]):
        signed += res
    tags = [None] * n
    bad = rng.sample(range(n), max(len(kinds), int(n * CORRUPT_FRAC)))
    for j, i in enumerate(bad):
        tags[i] = kinds[j % len(kinds)]
    items, labels = [], []
    for i in range(n):
        (pk, sig), msg, kind = signed[i], msgs[i], tags[i]
        if kind == "ed_wrong_msg":
            msg = msg[:-1] + bytes([msg[-1] ^ 1])
        elif kind == "ed_flip_r_bit":
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        elif kind == "ed_s_plus_l":
            s = int.from_bytes(sig[32:], "little") + L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif kind == "ed_swap_key":
            pk = signed[(i + 1) % n][0]
        elif kind == "ed_r_noncanon_y":            # y = p + 1, i.e. 1
            sig = (P25519 + 1).to_bytes(32, "little") + sig[32:]
        elif kind == "ed_r_y1_sign1":
            sig = (1 | 1 << 255).to_bytes(32, "little") + sig[32:]
        elif kind == "ed_a_noncanon_y":
            pk = (P25519 + 1).to_bytes(32, "little")
        elif kind == "ed_a_y1_sign1":
            pk = (1 | 1 << 255).to_bytes(32, "little")
        elif kind == "ed_bad_length":
            sig = sig[:63]
        items.append(VerifyItem(SCHEME_ED25519, pk, sig, msg))
        labels.append(kind is None)
    return items, labels, tags


def root_neg(y: int) -> bool:
    """Does decompressing y take the x * sqrt(-1) fix?  (The candidate
    root squares to -x^2 rather than x^2.)"""
    from fabric_tpu_torch.ops.edwards import D
    p = P25519
    x2 = (y * y - 1) * pow(D * y * y + 1, p - 2, p) % p
    c = pow(x2, (p + 3) // 8, p)
    return c * c % p != x2 and c * c % p == (-x2) % p


def item_words(items, idxs):
    """Word arrays for P-256 items whose DER decodes and whose key is 65
    bytes, whatever r and s are (the kernel sees r = 0 here, which the
    provider rejects on the host)."""
    from fabric_tpu_torch.crypto import decode_dss_signature
    from fabric_tpu_torch.ops.p256 import ints_to_words
    cols = [[], [], [], [], []]
    for i in idxs:
        it = items[i]
        r, s = decode_dss_signature(it.signature)
        vals = (int.from_bytes(it.pubkey[1:33], "big"),
                int.from_bytes(it.pubkey[33:65], "big"), r, s,
                int.from_bytes(it.payload, "big"))
        for c, v in zip(cols, vals):
            c.append(v)
    return [ints_to_words(c) for c in cols]


def fast_lane_items(items, kinds, n_p256, on_curve):
    """Indices of the items the provider must send to KP3: well-formed
    P-256 items under on-curve keys that bring at least FAST_THRESHOLD
    well-formed signatures to the block."""
    wf = [i for i in range(n_p256) if kinds[i] not in HOST_REJECTED_KINDS]
    counts = {}
    for i in wf:
        counts[items[i].pubkey] = counts.get(items[i].pubkey, 0) + 1
    hot = {pk for pk, c in counts.items() if c >= FAST_THRESHOLD
           and on_curve(int.from_bytes(pk[1:33], "big"),
                        int.from_bytes(pk[33:65], "big"))}
    return [i for i in wf if items[i].pubkey in hot], len(wf), len(hot)


def drive(provider, items, fns, total):
    """One main-path run: counts set to 0 just before, read just after
    and added to `total`.  -> (verdicts, seconds, launches, stats
    delta)."""
    before = dict(provider.stats)
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    verdicts = provider.batch_verify_async(items)()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n
    delta = {k: v - before[k] for k, v in provider.stats.items()}
    return verdicts, seconds, launches, delta


def check_launches(run: str, launches: dict, on: tuple,
                   maybe: tuple = ()) -> None:
    """The kernels in `on` launched in this run, those in `maybe` may
    have, the others did not."""
    for name, n in launches.items():
        if name in on:
            check(n > 0, f"{run}: {name} was not launched on the main path")
        elif name not in maybe:
            check(n == 0, f"{run}: {name} launched {n} times, expected 0")


def check_verdicts(run: str, verdicts, want, kinds) -> None:
    check(verdicts.shape == want.shape, f"{run}: verdict shape")
    wrong = [int(i) for i in (verdicts != want).nonzero()[0]]
    check(not wrong, f"{run}: {len(wrong)} verdicts differ from labels, "
          f"first {[(i, kinds[i]) for i in wrong[:5]]}")


def sw_subset(run: str, items, verdicts, kinds, seed: int) -> int:
    """A random subset plus up to 4 items of each corrupted kind against
    the software provider -> the subset's size."""
    from fabric_tpu_torch.bccsp.sw import SoftwareProvider
    rng = random.Random(seed)
    subset = set(rng.sample(range(len(items)), min(SW_SUBSET, len(items))))
    for kind in {k for k in kinds if k is not None}:
        subset.update([i for i, k in enumerate(kinds) if k == kind][:4])
    subset = sorted(subset)
    sw = SoftwareProvider().batch_verify([items[i] for i in subset])
    check((sw == verdicts[subset]).all(), f"{run}: CUDA provider != SW")
    return len(subset)


def timed_once(torch, fn):
    """(fn(), its wall ms, synchronised): one timed call of a plain
    version, which is also the call the kernel is held against."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# the commit stream
# ---------------------------------------------------------------------------

def commit_identities():
    """Three orgs (the port's MSP CA), one endorser per org and
    N_CLIENTS client identities spread over them -> (orgs, signers,
    endorser indices, client indices)."""
    from fabric_tpu_torch.msp.ca import DevOrg
    orgs = [DevOrg(f"Org{i + 1}") for i in range(N_ORGS)]
    idents = [o.new_identity("peer0") for o in orgs]
    idents += [orgs[c % N_ORGS].new_identity(f"client{c}")
               for c in range(N_CLIENTS)]
    signers = [_Signer(i.serialize(),
                       i._key.key.private_numbers().private_value)
               for i in idents]
    return orgs, signers, list(range(N_ORGS)), list(range(
        N_ORGS, N_ORGS + N_CLIENTS))


def build_stream(n_txs: int, n_last: int, signers, endorsers, clients,
                 pool):
    """The commit stream -> ([block of serialized envelopes], [labels],
    {kind: count}).  Block 0 seeds n_txs accounts; blocks 1 and 2 are
    n_txs transfers each (read two accounts at the version committed
    before the block, write both) with the mix of COMMIT_MIX; block 3
    holds n_last transfers, the first with a range query.  Labels come
    from simulating the reference's MVCC (ledger/mvcc.py) over the
    stream: a read passes when its version is the key's current one
    (committed, or an earlier valid tx of the block's write), a valid
    tx's writes land; a bad creator gives 4, a bad endorsement 10."""
    rng = random.Random(SEED + 9)
    accts = [f"acct{i:05d}" for i in range(n_txs)]
    hot = accts[:COMMIT_HOT_KEYS]
    committed: dict = {}
    blocks, labels, counts = [], [], {}

    def tx(reads, writes, ranges=(), corrupt=None):
        return (rng.choice(clients), endorsers, rng.randbytes(24),
                reads, writes, list(ranges), corrupt)

    for blk in range(4):
        specs, lab, inblock = [], [], {}
        n = n_txs if blk < 3 else n_last
        deleted_here: list = []
        for t in range(n):
            if blk == 0:
                specs.append(tx([], [(accts[t], b"100", False)]))
                lab.append(0)
                inblock[accts[t]] = (0, t)
                continue
            u = rng.random()
            kind, acc = "transfer", 0.0
            for name, frac in COMMIT_MIX:
                acc += frac
                if u < acc:
                    kind = name
                    break
            if blk == 3 and t == 0:
                kind = "range_query"
            a, b = rng.sample(accts, 2)
            if kind == "hot":
                a = rng.choice(hot)
                b = b if b != a else accts[-1]
            elif kind == "transfer" and deleted_here:
                a = deleted_here.pop()            # reads a key deleted
                b = b if b != a else accts[-1]    # earlier in the block
            reads = [(a, committed.get(a)), (b, committed.get(b))]
            val = f"{blk}.{t}".encode()
            writes = [(a, val, False), (b, val, False)]
            ranges, corrupt = [], None
            if kind == "stale":
                v = committed.get(a) or (0, 0)
                reads[0] = (a, (v[0], v[1] + 7))
            elif kind == "delete":
                writes = [(a, b"", True)]
                reads = reads[:1]
                deleted_here.append(a)
            elif kind == "absent":
                reads.append((f"absent.{blk}.{t}", None))
            elif kind == "range_query":
                ranges = [("zz0", "zz1", True)]
            elif kind == "bad_creator":
                corrupt = "creator"
            elif kind == "bad_endorsement":
                corrupt = "endorsement"
            counts[kind] = counts.get(kind, 0) + 1
            specs.append(tx(reads, writes, ranges, corrupt))
            if corrupt:
                lab.append(4 if corrupt == "creator" else 10)
                continue
            cur = {k: (inblock[k] if k in inblock else committed.get(k))
                   for k, _ in reads}
            if any(cur[k] != v for k, v in reads):
                lab.append(11)
                continue
            lab.append(0)
            for k, _val, dl in writes:
                inblock[k] = None if dl else (blk, t)
        for k, v in inblock.items():
            if v is None:
                committed.pop(k, None)
            else:
                committed[k] = v
        jobs = [(signers, specs[lo:lo + 250])
                for lo in range(0, len(specs), 250)]
        blocks.append([e for part in pool.map(_envelope_job, jobs)
                       for e in part])
        labels.append(lab)
    return blocks, labels, counts


def sbe_stream(n_blocks: int, n_txs: int, clients, seed: int):
    """The key-level endorsement (SBE) stream -> ([block of tx specs],
    [labels], {kind: count}).  A spec is (creator, endorser orgs,
    nonce, written keys, [(key, key policy name or None)]): the creator
    one of `clients`, the orgs 0 (Org1) and 1 (Org2).  Every write is
    blind, so MVCC decides nothing.  Block 0 opens with a key under each
    key policy; then about SBE_POLICY_FRAC of the txs set or delete a
    key's policy, the rest write a key, under a key policy or not,
    endorsed by one org or both.  Block 1 opens with a same-block
    transition (tx 0 puts a fresh key under OR(Org2), tx 1 writes it
    endorsed by Org1 alone), and the middle tx of every block writes two
    keys under the two key policies.  The labels simulate the
    reference's gate (validator_keylevel.go): a written key needs its
    key policy, or the chaincode's when it has none; a policy update
    needs the key's current policy, or the chaincode's; a valid tx's
    updates hold for the later txs of its block.  0 valid, 10
    ENDORSEMENT_POLICY_FAILURE; without the channel capability every tx
    is valid (the chaincode policy takes any endorser)."""
    rng = random.Random(seed)
    sat = {"and": lambda e: 0 in e and 1 in e, "org2": lambda e: 1 in e,
           None: bool}
    committed: dict = {}                 # key -> its key policy's name
    n_keys = [0]

    def fresh():
        n_keys[0] += 1
        return f"sbe{n_keys[0]:06d}"

    blocks, labels, counts = [], [], {}
    for blk in range(n_blocks):
        cur = dict(committed)
        specs, lab = [], []
        for t in range(n_txs):
            ends = rng.choice(((0,), (1,), (0, 1)))
            writes, meta = [], []
            by_pol = {p: sorted(k for k, v in cur.items() if v == p)
                      for p in SBE_POLICIES}
            if blk == 0 and t < 2:
                kind, ends = "set", (0, 1)
                meta = [(fresh(), ("and", "org2")[t])]
            elif blk == 1 and t == 0:
                kind, ends = "transition_set", (0, 1)
                trans = fresh()
                meta = [(trans, "org2")]
            elif blk == 1 and t == 1:
                kind, ends, writes = "transition_write", (0,), [trans]
            elif t == n_txs // 2 and all(by_pol.values()):
                kind = "two_policies"
                writes = [rng.choice(by_pol["and"]),
                          rng.choice(by_pol["org2"])]
            elif rng.random() < SBE_POLICY_FRAC:
                if cur and rng.random() < 0.4:
                    key = rng.choice(sorted(cur))
                    pol = rng.choice((None, "and", "org2"))
                else:
                    key, pol = fresh(), rng.choice(("and", "org2"))
                kind = "set" if pol else "delete"
                meta = [(key, pol)]
            elif cur and rng.random() < 0.3:
                kind, writes = "write_policed", [rng.choice(sorted(cur))]
            else:
                kind, writes = "write", [fresh()]
            counts[kind] = counts.get(kind, 0) + 1
            ok = all(sat[cur.get(k)](ends) for k in writes) and all(
                sat[cur.get(k)](ends) for k, _ in meta)
            lab.append(0 if ok else 10)
            if ok:
                for k, pol in meta:
                    if pol is None:
                        cur.pop(k, None)
                    else:
                        cur[k] = pol
            specs.append((rng.choice(clients), ends, rng.randbytes(24),
                          writes, meta))
        committed = cur
        blocks.append(specs)
        labels.append(lab)
    return blocks, labels, counts


def _sbe_envelope_job(job):
    """Worker: (signers, org endorser indices, [SBE tx spec]) ->
    [serialized envelope]; the key policies go to cc#meta as the shim's
    SetStateValidationParameter writes them."""
    from fabric_tpu_torch.committer import sbe
    from fabric_tpu_torch.policy import parse_policy
    from fabric_tpu_torch.protocol import KVWrite, NsRwSet, TxRwSet, build
    signers, org_ends, specs = job
    pols = {p: sbe.encode_policy(parse_policy(s))
            for p, s in SBE_POLICIES.items()}
    out = []
    for creator, ends, nonce, writes, meta in specs:
        ns = [NsRwSet("cc", writes=tuple(KVWrite(k, b"v") for k in writes))]
        if meta:
            ns.append(NsRwSet(sbe.meta_namespace("cc"), writes=tuple(
                KVWrite(k, b"", True) if p is None else KVWrite(k, pols[p])
                for k, p in meta)))
        env = build.endorser_tx(
            "ch", "cc", "1.0", TxRwSet(tuple(ns)), signers[creator],
            [signers[org_ends[o]] for o in ends], nonce=nonce,
            timestamp=COMMIT_TS)
        out.append(env.serialize())
    return out


def chain_blocks(env_blocks):
    """Hash-chained wire bytes of the stream's blocks."""
    from fabric_tpu_torch.protocol import (Envelope, block_header_hash,
                                           build)
    raws, prev = [], b"\x00" * 32
    for num, envs in enumerate(env_blocks):
        block = build.new_block(num, prev,
                                [Envelope.deserialize(e) for e in envs])
        prev = block_header_hash(block.header)
        raws.append(block.serialize())
    return raws


def commit_stack(provider, orgs, device_validate: bool, dev, msps=None,
                 policy: str = COMMIT_POLICY, classic: bool = False,
                 cache=None, early_abort: bool = False, bundle=None,
                 **ledger_kw):
    """Committer -> TxValidator -> DeviceValidator (window=16384) or the
    host gate -> KVLedger (in memory, 8 state shards) -> (committer,
    device validator or None).  The validator's deep tail, or with
    `classic` the default peer's: key-level endorsement read from the
    ledger's state (sbe.statedb_lookup), so the classic tail.  cache: a
    verify-once VerdictCache or None; early_abort: an
    EarlyAbortAnalyzer on the ledger's state (on a windowed ledger fed
    its pending overlay); msps: the orgs' MSPs unless given; bundle: a
    BundleSource whose bundle gives the MSPs; ledger_kw: more
    LedgerConfig fields (commit_window, parallel_commit, ...)."""
    from fabric_tpu_torch.committer import PolicyRegistry
    from fabric_tpu_torch.ledger import KVLedger, LedgerConfig
    from fabric_tpu_torch.msp import CachedMSP
    from fabric_tpu_torch.policy import parse_policy
    if msps is None and bundle is None:
        msps = {o.mspid: CachedMSP(o.msp()) for o in orgs}
    policies = PolicyRegistry()
    policies.set_policy("cc", parse_policy(policy))
    ledger = KVLedger("ch", LedgerConfig(device_validate=device_validate,
                                         state_shards=8, **ledger_kw))
    return wire_stack(ledger, provider, policies, msps, dev, classic=classic,
                      cache=cache, early_abort=early_abort, bundle=bundle)


def wire_stack(ledger, provider, policies, msps, dev, classic=False,
               cache=None, early_abort=False, bundle=None, history=None):
    """The validator and committer over `ledger` -> (committer, device
    validator or None): a DeviceValidator (KV7, window=16384) when the
    ledger's config asks for device validation."""
    from fabric_tpu_torch.committer import Committer, TxValidator, sbe
    from fabric_tpu_torch.committer.device_validate import DeviceValidator
    from fabric_tpu_torch.committer.parallel_commit import (
        EarlyAbortAnalyzer)
    dv = None
    if ledger.config.device_validate:
        dv = DeviceValidator(ledger.statedb, "ch", device=dev,
                             window=COMMIT_WINDOW)
        ledger.set_prepared_source(dv.take_prepared)
    overlay = (ledger.pending_overlay if ledger.config.commit_window
               else None)
    validator = TxValidator(
        "ch", msps, provider, policies, bundle_source=bundle,
        sbe_lookup=sbe.statedb_lookup(ledger.statedb) if classic else None,
        verify_cache=cache, device_validate=dv,
        early_abort=EarlyAbortAnalyzer(ledger.statedb, "ch",
                                       overlay_source=overlay)
        if early_abort else None)
    return Committer(ledger, validator, bundle_source=bundle,
                     provider=provider if bundle is not None else None,
                     confighistory=history), dv


def commit_stream(committer, raws, rows: bool = False):
    """Commit the blocks, each parsed from its bytes as deliver does ->
    [(result, metadata flag bytes, seconds, (state rows, history rows,
    commit hash) after the block when `rows`, else None)]."""
    from fabric_tpu_torch.protocol import wire
    from fabric_tpu_torch.protocol.types import META_TXFLAGS
    out = []
    for raw in raws:
        block = wire.parse_block(raw)
        t0 = time.perf_counter()
        res = committer.store_block(block)
        secs = time.perf_counter() - t0
        after = ((*ledger_rows(committer.ledger),
                  committer.ledger.commit_hash) if rows else None)
        out.append((res, bytes(block.metadata.items[META_TXFLAGS]), secs,
                    after))
    return out


def ledger_rows(ledger):
    state = sorted((k, None if vv is None else
                    (vv.value, vv.version.block_num, vv.version.tx_num))
                   for k, vv in ledger.statedb._data.items())
    hist = ledger.historydb
    history = {k: [(m.block_num, m.tx_num, m.txid, m.value, m.is_delete)
                   for m in hist.get_history(*k)]
               for k in sorted(hist._index)}
    return state, history


def creator_check(committer, raw: bytes, tx: int) -> dict:
    """What a software check says of a tx's creator signature, for the
    diagnosis of a flag that is not the tx's label."""
    from fabric_tpu_torch import crypto
    from fabric_tpu_torch.protocol import Block, Envelope
    env = Envelope.deserialize(Block.deserialize(raw).data[tx])
    ident = committer.validator._deserialize(
        env.header().signature_header.creator)
    return {"tx": tx, "sig_tail": env.signature[-4:].hex(),
            "sw_ok": ident is not None and crypto.p256_verify_digest(
                ident._pub_wire, env.signature,
                hashlib.sha256(env.payload).digest())}


def kv7_variants(ln, num: int) -> dict:
    """A block's lanes changed two ways for KV7's hard cases -> {name:
    lanes}.  "hot slot": every read and write on one slot, no deletes,
    each read at the version the last code-0 writer before its tx left,
    so every code-0 tx is one link of one chain; "wide txs": every
    seventh tx takes the reads and writes of the six before it, more
    than a lane of the walk holds."""
    import numpy as np
    from fabric_tpu_torch.ops import block_validate as kv7
    c0 = kv7.code0(ln, num)
    T = c0.shape[0]
    w_off = np.searchsorted(ln["w_tx"], np.arange(T + 1))
    writer = np.where((c0 == 0) & (np.diff(w_off) > 0), np.arange(T), -1)
    prev = np.concatenate([[-1], np.maximum.accumulate(writer)[:-1]])
    p = prev[ln["r_tx"]]
    zero = np.zeros_like
    hot = dict(ln, r_slot=zero(ln["r_slot"]), w_slot=zero(ln["w_slot"]),
               w_del=zero(ln["w_del"]),
               r_has=np.where(p >= 0, 1, ln["c_has"][0]).astype(np.int32),
               r_blk=np.where(p >= 0, num, ln["c_blk"][0]).astype(np.int32),
               r_txn=np.where(p >= 0, p, ln["c_txn"][0]).astype(np.int32))
    m = np.minimum(7 * (np.arange(T) // 7) + 6, T - 1).astype(np.int32)
    wide = dict(ln, r_tx=m[ln["r_tx"]], w_tx=m[ln["w_tx"]])
    return {"hot slot": hot, "wide txs": wide}


def commit_phase(torch, args, provider, orgs, raws, labels, fns,
                 clock_hz: float) -> tuple:
    """Phase 7: the stream through two port stacks, KV7 on and off; the
    checks; KV7 against its plain version; the timings.  -> (KV7's row
    of the kernels line, the stream's launches, the KV7 stack's (codes,
    metadata flags, (state rows, history rows, commit hash)) after each
    block)."""
    from fabric_tpu_torch.ops import block_validate as kv7
    dev = torch.device("cuda")
    n_blocks = len(raws)

    # the main path: every count to 0, the stream through the KV7 stack,
    # the counts read; pack() is wrapped to keep each block's lanes
    lanes_seen = []
    pack = kv7.pack

    def keep_lanes(lanes):
        lanes_seen.append(lanes)
        return pack(lanes)

    kv7.pack = keep_lanes
    for fn in (*fns.values(), kv7.block_validate_kernel):
        fn.launches = 0
    try:
        dev_c, dv = commit_stack(provider, orgs, True, dev)
        dev_out = commit_stream(dev_c, raws, rows=True)
    finally:
        kv7.pack = pack
    launches = {name: fn.launches for name, fn in fns.items()}
    launches["block_validate"] = kv7.block_validate_kernel.launches
    host_c, _ = commit_stack(provider, orgs, False, dev)
    host_out = commit_stream(host_c, raws, rows=True)
    for num, ((dr, dmeta, dsec, drows), (hr, hmeta, hsec, hrows)) in \
            enumerate(zip(dev_out, host_out)):
        codes = dr.final_flags.codes()
        check(codes == hr.final_flags.codes(),
              f"block {num}: device-on flags != device-off flags")
        check(dmeta == hmeta, f"block {num}: metadata flags differ")
        check(drows[0] == hrows[0], f"block {num}: state rows differ")
        check(drows[1] == hrows[1], f"block {num}: history rows differ")
        check(drows[2] == hrows[2], f"block {num}: commit hashes differ")
        if codes != labels[num]:
            bad = [(i, c, w) for i, (c, w) in
                   enumerate(zip(codes, labels[num])) if c != w][:5]
            check(False, f"block {num}: flags != labels, first (tx, flag, "
                  f"label) {bad}; their creator signatures "
                  f"{[creator_check(dev_c, raws[num], i) for i, _, _ in bad]}")
        phase("commit", block=num, txs=len(codes),
              valid=codes.count(0), mvcc=codes.count(11),
              bad_creator=codes.count(4), policy=codes.count(10),
              device_on_s=round(dsec, 4), device_off_s=round(hsec, 4))
    st = dv.stats
    demoted = {k: v for k, v in
               st["validator_device_demotions_total"].items() if v}
    check(demoted == {"range_query": 1}, f"demotions {demoted}")
    check(st["validator_device_blocks_total"] == n_blocks - 1
          and st["validator_device_dispatches_total"] == n_blocks - 1,
          f"device blocks {st}")
    check(launches["block_validate"] == n_blocks - 1,
          f"KV7 launched {launches['block_validate']} times, expected "
          f"one per device-validated block ({n_blocks - 1})")
    check_launches("commit", launches, ("p256_verify_rows",
                                        "block_validate"),
                   maybe=("p256_verify",))
    check(len(lanes_seen) == n_blocks - 1, "lanes of each device block")
    phase("commit", commit_hash=dev_c.ledger.commit_hash.hex()[:16],
          flags_vs_labels="equal", device_vs_host="equal (flags, metadata,"
          " state, history, commit hash)", demotions=demoted,
          launches=launches)

    # KV7 against its plain version on blocks 1 and 2's full lanes and on
    # block 2's hot-slot and wide-tx variants; the plain version's time
    # is its one comparison call on block 2
    err = 0
    cases = [(f"block {num}", lanes_seen[num], num) for num in (1, 2)]
    cases += [(name, ln, 2) for name, ln in
              kv7_variants(lanes_seen[2], 2).items()]
    for name, ln, num in cases:
        buf, d = kv7.pack(ln)
        buf_d = kv7.upload(buf, dev)
        got = kv7.block_validate_kernel(buf_d, d, num).cpu()
        (gate, final), ms = timed_once(
            torch, lambda: kv7.block_validate_plain(ln, num))
        check(torch.equal(got[:d["T"]], gate)
              and torch.equal(got[d["T"]:], final),
              f"KV7 != block_validate_plain on {name}")
        err = max(err, int((got.to(torch.int16) - torch.cat(
            [gate, final]).to(torch.int16)).abs().max()))
        depth = kv7.dep_depth(ln, num)
        row = {"kv7_vs_plain": f"equal on {name}", "kv7_dep_depth": depth,
               "valid": int((final == 0).sum()),
               "mvcc": int((final == 11).sum()), **d}
        if name != "block 2":
            row["kv7_ms"] = round(event_ms(torch, lambda: (
                kv7.block_validate_kernel(buf_d, d, num)), args.trials), 4)
        phase("commit", **row)
        if name == "block 2":
            plain_ms, depth2, b2 = ms, depth, (buf_d, d)
    buf_d, d = b2
    kv7_ms = event_ms(torch, lambda: kv7.block_validate_kernel(
        buf_d, d, 2), args.trials)
    _, phase1, walk = kv7.block_validate_parts(buf_d, d, 2)
    phase1()
    phase1_ms = event_ms(torch, phase1, args.trials)
    walk_ms = event_ms(torch, walk, args.trials)
    bytes_s = kv7.bytes_moved(d) / HBM_BYTES_PER_S
    # the walk's least dependent steps: one shared-memory round trip per
    # link of the block's longest chain
    ops_s = depth2 * SHMEM_CYCLES / clock_hz
    serial_ms = d["T"] * SHMEM_CYCLES / clock_hz * 1e3

    # block 2, warm, on fresh stacks holding blocks 0 and 1: validate +
    # commit, its stages, and one profiled run
    stages = {True: [], False: []}
    for trial in range(args.trials):
        for on in (True, False):
            c, dvt = commit_stack(provider, orgs, on, dev)
            commit_stream(c, raws[:2])
            (res, _meta, secs, _rows), = commit_stream(c, raws[2:3])
            vr = res.validation
            row = {"total": secs, "collect": vr.collect_s,
                   "dispatch_wait": vr.dispatch_s, "gate": vr.gate_s,
                   "commit": res.commit_s, **c.validator.last_timings}
            if on:
                row.update(dvt.last_timings)
            stages[on].append(row)
            if trial == args.trials - 1 and on:
                c, _ = commit_stack(provider, orgs, True, dev)
                commit_stream(c, raws[:2])
                busy_ms, wall_ms, top = device_busy(torch, {
                    "block 2": lambda: commit_stream(c, raws[2:3])})[
                        "block 2"]
    n2, v2 = len(labels[2]), labels[2].count(0)
    for on in (True, False):
        med = {k.removesuffix("_s"): statistics.median(
            r[k] for r in stages[on]) * 1e3 for k in stages[on][0]}
        phase("commit", block=2, kv7="on" if on else "off", warm=True,
              validate_commit_ms=round(med["total"], 3),
              committed_tx_per_s=round(n2 / med["total"] * 1e3, 1),
              valid_tx_per_s=round(v2 / med["total"] * 1e3, 1),
              **{f"{k}_ms": round(v, 3) for k, v in med.items()
                 if k != "total"})
    phase("commit", kv7_ms=round(kv7_ms, 4),
          kv7_phase1_ms=round(phase1_ms, 4), kv7_walk_ms=round(walk_ms, 4),
          kv7_plain_ms=round(plain_ms, 2), kv7_dep_depth=depth2,
          kv7_bound_ms=round(max(bytes_s, ops_s) * 1e3, 6),
          kv7_bound_by="operations" if ops_s >= bytes_s else "bytes",
          kv7_old_serial_floor_ms=round(serial_ms, 4),
          kv7_bytes=kv7.bytes_moved(d), smem_slots=kv7.smem_slots())
    phase("commit", profiled="block 2, KV7 on", wall_ms=round(wall_ms, 3),
          device_busy_ms=round(busy_ms, 3),
          device_idle_share=round(1 - busy_ms / wall_ms, 4),
          top_device_ops=top)
    phase("commit", library="none: no PyTorch call computes the gate fold "
          "and the in-order MVCC walk")
    return {"name": "block_validate", "route": "cuda",
            "source": "fabric_tpu_torch/ops/csrc/block_validate.cu",
            "replaces": "fabric_tpu/committer/device_validate.py:418",
            "launches": launches["block_validate"], "max_abs_err": err,
            "ms": kv7_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "library_ms": None, "on_main_path": True,
            "phase1_ms": phase1_ms, "walk_ms": walk_ms,
            "dep_depth": depth2}, launches, [
                (dr.final_flags.codes(), dmeta, drows)
                for dr, dmeta, _s, drows in dev_out]


# ---------------------------------------------------------------------------
# the durable ledger and commit-time config blocks
# ---------------------------------------------------------------------------

def org_config(C, org):
    """The channel config's entry of a DevOrg."""
    mc = org.msp_config()
    return C.OrgConfig(org.mspid, tuple(mc.root_certs_pem),
                       tuple(mc.admin_certs_pem),
                       tuple(mc.intermediate_certs_pem), tuple(mc.crls_pem))


def durable_stack(provider, dev, root, msps=None, bundle=None, history=None,
                  **ledger_kw):
    """Committer -> TxValidator (deep path) -> DeviceValidator (KV7,
    window=16384) -> KVLedger(root, 8 state shards, a checkpoint every
    DURABLE_SNAPSHOT_EVERY blocks) -> (committer, device validator).
    msps: a static MSP set; bundle: a BundleSource whose current bundle
    gives the MSPs and takes committed config blocks (with `history`, a
    ConfigHistory); ledger_kw: more LedgerConfig fields."""
    from fabric_tpu_torch.committer import PolicyRegistry
    from fabric_tpu_torch.ledger import KVLedger, LedgerConfig
    from fabric_tpu_torch.policy import parse_policy
    policies = PolicyRegistry()
    policies.set_policy("cc", parse_policy(COMMIT_POLICY))
    policies.set_policy("cc4", parse_policy(ORG4_POLICY))
    ledger = KVLedger("ch", LedgerConfig(
        root=root, device_validate=True, state_shards=DURABLE_SHARDS,
        snapshot_every=DURABLE_SNAPSHOT_EVERY, **ledger_kw))
    return wire_stack(ledger, provider, policies, msps, dev, bundle=bundle,
                      history=history)


def _crash_child(root, raw_path, msp_configs, ready, dev_name):
    """Spawned: reopen the ledger under root, commit block 2 through a
    KV7 stack, and once the block store has appended and fsynced the
    block, signal `ready` and wait, before the state commit, to be
    killed.  Its provider sends every key to KP2 (no table builds)."""
    import torch
    from fabric_tpu_torch.bccsp.cuda import CudaProvider
    from fabric_tpu_torch.msp import MSP, CachedMSP
    from fabric_tpu_torch.protocol import wire
    msps = {c.mspid: CachedMSP(MSP(c)) for c in msp_configs}
    prov = CudaProvider(device=dev_name, fast_key_threshold=1 << 30)
    committer, _ = durable_stack(prov, torch.device(dev_name), root,
                                 msps=msps)

    def stop(batch, num):
        ready.set()
        time.sleep(3600)

    committer.ledger.statedb.apply_updates = stop
    with open(raw_path, "rb") as f:
        raw = f.read()
    committer.store_block(wire.parse_block(raw))


class _DiskMeter:
    """os.fsync timed and attributed while installed: each call's
    seconds and the bytes its file grew since the last fsync of that
    file (or since `prime`; the whole file when new), by kind of file
    (block segments, state WAL, history WAL, checkpoint shards and
    manifests, directories)."""

    def __init__(self):
        self.calls = []         # (kind, seconds, bytes)
        self._seen = {}
        self._real = None

    @staticmethod
    def kind(path: str) -> str:
        name = os.path.basename(path)
        if name.startswith("blocks_"):
            return "blocks"
        if name in ("state.wal", "history.wal"):
            return name.replace(".", "_")
        return "checkpoint"

    def prime(self, root: str) -> None:
        """Take the files under root at their present sizes."""
        self._seen = {}
        for d, _s, fs in os.walk(root):
            for f in fs:
                st = os.stat(os.path.join(d, f))
                self._seen[(st.st_dev, st.st_ino)] = st.st_size

    def install(self):
        import stat
        self._real = real = os.fsync

        def fsync(fd):
            st = os.fstat(fd)
            if stat.S_ISDIR(st.st_mode):
                kind, grew = "dir", 0
            else:
                path = os.readlink(f"/proc/self/fd/{fd}")
                kind = self.kind(path)
                last = self._seen.get((st.st_dev, st.st_ino), 0)
                grew = st.st_size - last if st.st_size >= last \
                    else st.st_size
                self._seen[(st.st_dev, st.st_ino)] = st.st_size
            t0 = time.perf_counter()
            real(fd)
            self.calls.append((kind, time.perf_counter() - t0, grew))

        os.fsync = fsync

    def remove(self):
        os.fsync = self._real

    def take(self) -> dict:
        """{kind: (fsyncs, ms, bytes)} since the last take."""
        out = {}
        for kind, s, b in self.calls:
            n, ms, nb = out.get(kind, (0, 0.0, 0))
            out[kind] = (n + 1, ms + s * 1e3, nb + b)
        self.calls = []
        return {k: (n, round(ms, 3), nb) for k, (n, ms, nb) in out.items()}


def timed_method(obj, name: str, log: list):
    """Wrap obj.name so each call appends its wall seconds to log."""
    real = getattr(obj, name)

    def fn(*a, **k):
        t0 = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            log.append(time.perf_counter() - t0)

    setattr(obj, name, fn)


def org4_block(num, prev, org4_peer, signers, clients, tag):
    """DURABLE_ORG4_TXS txs on namespace cc4 under ORG4_POLICY, each
    created by a stream client and endorsed by Org1's and Org4's peers
    -> block bytes."""
    from fabric_tpu_torch.protocol import (KVWrite, NsRwSet, TxRwSet,
                                           build)
    rng = random.Random(SEED + 20 + num)
    envs = []
    for t in range(DURABLE_ORG4_TXS):
        rws = TxRwSet((NsRwSet("cc4", writes=(
            KVWrite(f"org4.{tag}.{t:04d}", b"%d" % t),)),))
        envs.append(build.endorser_tx(
            "ch", "cc4", "1.0", rws, signers[clients[t % len(clients)]],
            [signers[0], org4_peer], nonce=rng.randbytes(24),
            timestamp=COMMIT_TS))
    return build.new_block(num, prev, envs)


def durable_phase(torch, args, provider, orgs, signers, clients, raws,
                  mem_rows, fns, name_power, dev) -> dict:
    """Phase 11.  The commit stream through a durable KV7 stack, a real
    crash and its recovery, config blocks at commit, host times.  Its
    launches are its own and stay out of the kernels line.  mem_rows:
    phase 6's in-memory KV7 stack after each block, (codes, metadata
    flags, (state rows, history rows, commit hash)).  -> its numbers."""
    import shutil
    import signal
    from fabric_tpu_torch import config as C
    from fabric_tpu_torch.ledger import ConfigHistory, KVLedger
    from fabric_tpu_torch.ledger import LedgerConfig
    from fabric_tpu_torch.msp import CachedMSP
    from fabric_tpu_torch.msp.ca import DevOrg
    from fabric_tpu_torch.ops import block_validate as kv7
    from fabric_tpu_torch.protocol import block_header_hash, build, wire
    from fabric_tpu_torch.protocol.types import META_TXFLAGS
    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, "build", "durable")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    dirs = {k: os.path.join(base, k) for k in ("a", "b", "pristine")}
    msps = {o.mspid: CachedMSP(o.msp()) for o in orgs}
    all_fns = (*fns.values(), kv7.block_validate_kernel)
    out = {"reduced": f"snapshot_every={DURABLE_SNAPSHOT_EVERY} "
           "(the reference's 256), so the stream writes and recovers "
           "whole checkpoints of its real state"}
    phase("durable", root="build/durable", state_shards=DURABLE_SHARDS,
          snapshot_every=DURABLE_SNAPSHOT_EVERY, reduced=out["reduced"],
          card=name_power)

    def du(root):
        return sum(os.path.getsize(os.path.join(d, f))
                   for d, _s, fs in os.walk(root) for f in fs)

    def launches_now():
        got = {name: fn.launches for name, fn in fns.items()}
        got["block_validate"] = kv7.block_validate_kernel.launches
        return {k: n for k, n in got.items() if n}

    # (a) the stream through the durable KV7 stack, held to phase 6's
    # in-memory KV7 stack after every block; fsyncs, the state WAL's
    # appends and the checkpoints timed
    meter = _DiskMeter()
    meter.prime(base)
    wal_s, ckpt_s = [], {"state": [], "history": []}
    for fn in all_fns:
        fn.launches = 0
    c, dv = durable_stack(provider, dev, dirs["a"], msps=msps)
    lg = c.ledger
    timed_method(lg.statedb, "_wal_append", wal_s)
    timed_method(lg.statedb, "_checkpoint_locked", ckpt_s["state"])
    timed_method(lg.historydb, "_checkpoint_locked", ckpt_s["history"])
    meter.install()
    try:
        for num, raw in enumerate(raws):
            block = wire.parse_block(raw)
            before = du(dirs["a"])
            t0 = time.perf_counter()
            res = c.store_block(block)
            secs = time.perf_counter() - t0
            disk = meter.take()
            codes = res.final_flags.codes()
            mcodes, mmeta, mrows = mem_rows[num]
            rows = (*ledger_rows(lg), lg.commit_hash)
            check(codes == mcodes, f"durable block {num}: flags != memory")
            check(bytes(block.metadata.items[META_TXFLAGS]) == mmeta,
                  f"durable block {num}: metadata flags != memory")
            check(rows[0] == mrows[0], f"durable block {num}: state rows")
            check(rows[1] == mrows[1], f"durable block {num}: history rows")
            check(rows[2] == mrows[2], f"durable block {num}: commit hash")
            st = res.commit_stats
            phase("durable", block=num, vs_memory="equal (flags, metadata,"
                  " state, history, commit hash)",
                  validate_commit_ms=round(secs * 1e3, 3),
                  block_store_ms=round(st.block_commit_s * 1e3, 3),
                  state_ms=round(st.state_commit_s * 1e3, 3),
                  history_ms=round(st.history_commit_s * 1e3, 3),
                  dir_bytes_delta=du(dirs["a"]) - before,
                  fsyncs_ms_bytes=disk)
            if num == 1:
                for k in ("b", "pristine"):
                    shutil.copytree(dirs["a"], dirs[k])
    finally:
        meter.remove()
    launches = launches_now()
    st = dv.stats
    check(st["validator_device_blocks_total"] == len(raws) - 1
          and launches.get("block_validate") == len(raws) - 1,
          f"durable: KV7 blocks {st}, launches {launches}")
    check(st["validator_device_stash_misses_total"] == 0,
          "durable: a stash miss on the stream")
    check_launches("durable", launches, ("p256_verify_rows",
                                         "block_validate"),
                   maybe=("p256_verify",))
    out["wal_append_ms"] = [round(s * 1e3, 3) for s in wal_s]
    out["checkpoint_ms"] = {k: [round(s * 1e3, 3) for s in v]
                            for k, v in ckpt_s.items()}
    ckpt_files = [os.path.join(d, f) for d, _s, fs in
                  os.walk(os.path.join(dirs["a"], "ch", "state", "ckpt"))
                  for f in fs]
    phase("durable", stream="equal to memory after every block",
          launches=launches, wal_append_ms=out["wal_append_ms"],
          checkpoint_ms=out["checkpoint_ms"],
          state_checkpoint_bytes=sum(os.path.getsize(p)
                                     for p in ckpt_files),
          dir_bytes=du(dirs["a"]), card=name_power)

    # (b) a real crash: a spawned child reopens a copy at height 2,
    # commits block 2, and is killed with SIGKILL once the block store's
    # fsync of block 2 is done, before the state commit
    raw_path = os.path.join(base, "block2.bin")
    with open(raw_path, "wb") as f:
        f.write(raws[2])
    ctx = multiprocessing.get_context("spawn")
    ready = ctx.Event()
    t0 = time.perf_counter()
    child = ctx.Process(target=_crash_child, args=(
        dirs["b"], raw_path, [o.msp_config() for o in orgs], ready,
        dev.type))
    child.start()
    try:
        signalled = ready.wait(600)
    finally:
        os.kill(child.pid, signal.SIGKILL)
        child.join(60)
    check(signalled, "crash child: no signal after block 2's fsync")
    check(child.exitcode == -signal.SIGKILL,
          f"crash child: exit code {child.exitcode}, not SIGKILL")
    phase("durable", crash="child killed by SIGKILL after block 2's block"
          " store fsync, before its state commit",
          child_s=round(time.perf_counter() - t0, 2))

    # (c) recovery: the parent reopens, block 2 is replayed from the
    # block store, and the reopened ledger goes on committing
    src = C.BundleSource(C.Bundle(C.ChannelConfig(
        "ch", 0, tuple(org_config(C, o) for o in orgs),
        C.default_policies([o.mspid for o in orgs]))))
    hist_dir = os.path.join(dirs["b"], "ch", "confighistory")
    t0 = time.perf_counter()
    c, dv = durable_stack(provider, dev, dirs["b"], bundle=src,
                          history=ConfigHistory(hist_dir))
    recovery_ms = (time.perf_counter() - t0) * 1e3
    lg = c.ledger
    rec = dict(lg.last_recovery)
    check(rec == {"replayed_blocks": 1, "start": 2, "height": 3},
          f"recovery replayed {rec}, not exactly block 2")
    check(lg.statedb.last_recovery["source"] == "manifest"
          and lg.statedb.last_recovery["savepoint"] == 1,
          f"state recovery {lg.statedb.last_recovery}")
    rows = (*ledger_rows(lg), lg.commit_hash)
    check(rows == mem_rows[2][2], "recovered ledger != memory after block 2")
    out["recovery_ms"] = recovery_ms
    phase("durable", recovery_ms=round(recovery_ms, 3), last_recovery=rec,
          state_recovery=lg.statedb.last_recovery,
          history_recovery=lg.historydb.last_recovery,
          vs_memory="equal (state, history, commit hash)", card=name_power)

    # the blocks after the reopen: block 3 (its range query demotes it,
    # host MVCC on a stash with no entry), then Org4's and the config
    # blocks, KV7 wherever a block is expressible
    org4 = DevOrg("Org4")
    org4_peer = org4.new_identity("peer0")
    prev = block_header_hash(wire.parse_block(raws[3]).header)
    cfg1 = C.ChannelConfig("ch", 1, tuple(
        org_config(C, o) for o in (*orgs, org4)), C.default_policies(
            [o.mspid for o in (*orgs, org4)]))
    stale = C.ChannelConfig("ch", 1, cfg1.orgs, cfg1.policies,
                            batch=C.BatchConfig(max_message_count=100))
    nxt = C.ChannelConfig("ch", 2, cfg1.orgs, cfg1.policies)
    admins = [o.admin for o in orgs]
    tail = []
    for num, what in enumerate(("org4_before", "config", "org4_after",
                                "config_unauthorized", "config_stale"),
                               start=4):
        if what.startswith("org4"):
            block = org4_block(num, prev, org4_peer, signers, clients, what)
        else:
            cfg, who = {"config": (cfg1, admins),
                        "config_unauthorized": (nxt, admins[:1]),
                        "config_stale": (stale, admins)}[what]
            env = C.build_config_envelope(cfg, [signers[0], *who])
            block = build.new_block(num, prev, [env])
        prev = block_header_hash(block.header)
        tail.append((what, block.serialize()))
    want = {"block3": None, "org4_before": [10] * DURABLE_ORG4_TXS,
            "config": [0], "org4_after": [0] * DURABLE_ORG4_TXS,
            "config_unauthorized": [6], "config_stale": [6]}
    fb0 = provider.stats["fallbacks"]
    out["tail"], out["tail_codes"] = tail, {}
    for what, raw in [("block3", raws[3])] + tail:
        for fn in all_fns:
            fn.launches = 0
        miss0 = dv.stats["validator_device_stash_misses_total"]
        blocks0 = dv.stats["validator_device_blocks_total"]
        dem0 = dict(dv.stats["validator_device_demotions_total"])
        t0 = time.perf_counter()
        res = c.store_block(wire.parse_block(raw))
        secs = time.perf_counter() - t0
        codes = res.final_flags.codes()
        out["tail_codes"][what] = codes
        got = launches_now()
        dem = {k: v - dem0[k] for k, v in
               dv.stats["validator_device_demotions_total"].items()
               if v - dem0[k]}
        row = {"block": lg.height - 1, "what": what,
               "valid": codes.count(0), "txs": len(codes),
               "kv7": dv.stats["validator_device_blocks_total"] - blocks0,
               "stash_misses":
                   dv.stats["validator_device_stash_misses_total"] - miss0,
               "demotions": dem, "launches": got,
               "validate_commit_ms": round(secs * 1e3, 3),
               "sequence": src.current().sequence}
        if what == "block3":
            check(codes == mem_rows[3][0], "block 3 after reopen: flags")
            check((*ledger_rows(lg), lg.commit_hash) == mem_rows[3][2],
                  "block 3 after reopen != memory")
            check(dem == {"range_query": 1} and row["kv7"] == 0,
                  f"block 3 after reopen: {row}")
        else:
            check(codes == want[what], f"{what}: flags {codes[:8]}...")
            check(what.startswith("config") or row["kv7"] == 1,
                  f"{what}: not through KV7 ({row})")
        if what == "config":
            check(got.get("p256_verify_rows", 0) > 0
                  and got.get("p256_verify", 0) > 0,
                  f"config block: KP3 and KP2 launches {got}")
            check(src.current().sequence == 1
                  and "Org4" in src.current().msps,
                  "config block: the bundle did not move to Org1-Org4")
        phase("durable", **row)
    check(src.current().sequence == 1, "an invalid config tx was applied")
    check(provider.stats["fallbacks"] == fb0 == 0, "durable: fallbacks")
    out["final_hash"] = lg.commit_hash
    entries = ConfigHistory(hist_dir).entries()
    check(entries == [(5, cfg1.serialize())],
          f"config history after a reopen: {[e[0] for e in entries]}")
    t0 = time.perf_counter()
    re = KVLedger("ch", LedgerConfig(root=dirs["b"],
                                     state_shards=DURABLE_SHARDS,
                                     snapshot_every=DURABLE_SNAPSHOT_EVERY))
    reopen_ms = (time.perf_counter() - t0) * 1e3
    check(re.height == lg.height and re.commit_hash == lg.commit_hash,
          "reopen after the config blocks: height or commit hash")
    phase("durable", confighistory=f"{len(entries)} entry at block 5, "
          "equal after a reopen", reopen_ms=round(reopen_ms, 3),
          reopen_recovery=re.last_recovery, fallbacks=0,
          config_bytes=len(cfg1.serialize()))

    # (e) block 2 warm, validate + commit, on the durable and on the
    # in-memory KV7 stack in turns, each holding blocks 0 and 1
    runs = {"durable": [], "memory": []}
    fs = {"fsync_ms": [], "fsyncs": [], "bytes": []}
    for trial in range(args.trials):
        tdir = os.path.join(base, f"t{trial}")
        shutil.copytree(dirs["pristine"], tdir)
        cd, _ = durable_stack(provider, dev, tdir, msps=msps)
        meter.prime(tdir)
        cm, _ = commit_stack(provider, orgs, True, dev)
        commit_stream(cm, raws[:2])
        for name, cc in (("durable", cd), ("memory", cm)):
            if name == "durable":
                meter.install()
            try:
                (res, _meta, secs, _rows), = commit_stream(cc, raws[2:3])
            finally:
                if name == "durable":
                    meter.remove()
            runs[name].append(secs * 1e3)
        disk = meter.take()
        fs["fsync_ms"].append(sum(v[1] for v in disk.values()))
        fs["fsyncs"].append(sum(v[0] for v in disk.values()))
        fs["bytes"].append(sum(v[2] for v in disk.values()))
        shutil.rmtree(tdir)
    med = {k: statistics.median(v) for k, v in runs.items()}
    out.update(block2_ms=med, fsync=fs)
    print(name_power, flush=True)
    phase("durable", block=2, warm=True, trials=args.trials,
          durable_validate_commit_ms=round(med["durable"], 3),
          memory_validate_commit_ms=round(med["memory"], 3),
          durable_runs_ms=[round(v, 3) for v in runs["durable"]],
          memory_runs_ms=[round(v, 3) for v in runs["memory"]],
          fsyncs=fs["fsyncs"][0],
          fsync_ms_median=round(statistics.median(fs["fsync_ms"]), 3),
          bytes_written=fs["bytes"][0], card=name_power)
    shutil.rmtree(base, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# the default peer's commit tail (phase 12)
# ---------------------------------------------------------------------------

def build_sbe_stream(signers, endorsers, clients, pool):
    """The SBE stream (sbe_stream) signed in the pool -> (hash-chained
    block bytes, labels, {kind: count})."""
    # creators of Org1 and Org2 only: the SBE channel has no Org3
    specs, labels, counts = sbe_stream(
        SBE_BLOCKS, SBE_TXS, [c for i, c in enumerate(clients)
                              if i % N_ORGS < 2], SEED + 14)
    env_blocks = []
    for blk in specs:
        jobs = [(signers, endorsers[:2], blk[lo:lo + 250])
                for lo in range(0, len(blk), 250)]
        env_blocks.append([e for part in pool.map(_sbe_envelope_job, jobs)
                           for e in part])
    return chain_blocks(env_blocks), labels, counts


class _Dispatches:
    """A provider that counts the items the validator dispatches
    (batch_verify_async) and passes everything to `inner`."""

    def __init__(self, inner):
        self.inner, self.items = inner, 0

    def batch_verify_async(self, items):
        items = list(items)
        self.items += len(items)
        return self.inner.batch_verify_async(items)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def at_height(committer, raws, mem_rows, n: int):
    """Set-up: blocks 0..n-1 straight into the committer's ledger with
    the flags phase 6 gave them (MVCC re-runs on them), checked against
    phase 6's commit hash."""
    from fabric_tpu_torch.protocol import wire
    from fabric_tpu_torch.protocol.types import META_TXFLAGS
    for num in range(n):
        block = wire.parse_block(raws[num])
        block.metadata.items[META_TXFLAGS] = mem_rows[num][1]
        committer.ledger.commit(block)
    check(committer.ledger.commit_hash == mem_rows[n - 1][2][2],
          f"set-up at height {n}: commit hash != phase 6's")
    return committer


def spec_fill(cache, provider, msps, raw: bytes) -> dict:
    """A SpeculativeVerifier on `cache`, its worker started, takes the
    block's envelopes as the reference gateway hands them over: batches
    of SPEC_BATCH, back to back, the highest rate a gateway gives.  Each
    stamp verifies its batch's creators in one dispatch and queues the
    endorsement sets; the worker verifies what it finds queued.  Once
    the queue is empty the verifier is stopped, which lets the worker
    finish what it holds.  The queue keeps 4,096 envelopes and drops the
    oldest beyond: `dropped` counts the block's unique endorsement items
    left without a verdict -> its counts."""
    from fabric_tpu_torch.protocol import Block
    from fabric_tpu_torch.verify_plane import (SpeculativeVerifier,
                                               derive_items, item_digest)
    envs = Block.deserialize(raw).data
    spec = SpeculativeVerifier(cache, lambda: provider,
                               lambda cid: msps).start()
    t0 = time.perf_counter()
    deadline = time.monotonic() + SPEC_DRAIN_S
    attested = 0
    try:
        for lo in range(0, len(envs), SPEC_BATCH):
            batch = envs[lo:lo + SPEC_BATCH]
            attested += sum(map(bool, spec.stamp(batch,
                                                 ["ch"] * len(batch))))
        stamp_s = time.perf_counter() - t0
        while spec._queue and time.monotonic() < deadline:
            time.sleep(0.001)
    finally:
        spec.stop()
    while spec._thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.001)
    fill_s = time.perf_counter() - t0
    check(not spec._queue and not spec._thread.is_alive(),
          f"speculative fill: the worker did not drain in {SPEC_DRAIN_S} s")
    memo, endorse = {}, {}
    for env in envs:
        for it in derive_items(env, "ch", msps, memo)[1]:
            endorse[item_digest(it)] = it
    return {"stamped": len(envs), "batches": -(-len(envs) // SPEC_BATCH),
            "attested": attested, "dispatched": spec.dispatched,
            "endorsement_items": len(endorse),
            "dropped": sum(cache.peek(it) is None
                           for it in endorse.values()),
            "stamp_ms": round(stamp_s * 1e3, 3),
            "fill_ms": round(fill_s * 1e3, 3)}


def classic_phase(torch, args, provider, orgs, raws, labels, mem_rows,
                  sbe, idemix, fns, name_power, dev) -> dict:
    """Phase 12.  The default peer's commit tail on the card: the classic
    tail (key-level endorsement read from the ledger's state) with the
    verify-once cache, on the factory's CUDA provider, no
    DeviceValidator.  mem_rows: phase 6's KV7 stack after each block,
    (codes, metadata flags, (state, history, commit hash)), which phase
    6 held equal to its host stack; sbe: (raws, labels, counts) of the
    SBE stream; idemix: (configs, block bytes, labels) of phase 9.  ->
    {kernel: launches} of its main-path runs (each count set to 0 just
    before a run and read just after)."""
    from fabric_tpu_torch import config as C
    from fabric_tpu_torch.bccsp.sw import SoftwareProvider
    from fabric_tpu_torch.idemix.msp import IdemixMSP
    from fabric_tpu_torch.msp import CachedMSP
    from fabric_tpu_torch.ops import block_validate as kv7
    from fabric_tpu_torch.protocol import wire
    from fabric_tpu_torch.protocol.types import META_TXFLAGS
    from fabric_tpu_torch.protocol import Block
    from fabric_tpu_torch.verify_plane import (VerdictCache, derive_items,
                                               item_digest)
    counted = {**fns, "block_validate": kv7.block_validate_kernel}
    main = dict.fromkeys(counted, 0)
    kp = ("p256_verify_rows", "p256_verify")
    fb0 = provider.stats["fallbacks"]

    def run(fn, count: bool = True):
        """fn() with every count set to 0 just before and read just
        after -> (its result, {kernel: launches})."""
        for f in counted.values():
            f.launches = 0
        out = fn()
        launches = {n: f.launches for n, f in counted.items()}
        if count:
            for n in main:
                main[n] += launches[n]
        return out, launches

    def commit_one(committer, raw):
        block = wire.parse_block(raw)
        t0 = time.perf_counter()
        res = committer.store_block(block)
        return res, time.perf_counter() - t0, bytes(
            block.metadata.items[META_TXFLAGS])

    def stack(**kw):
        """-> (committer, its item-counting provider)."""
        prov = _Dispatches(provider)
        return commit_stack(prov, orgs, kw.pop("kv7", False), dev,
                            **kw)[0], prov

    # (a) the stream through the default peer's stack, held to phase 6
    cache = VerdictCache(CACHE_CAPACITY, owner="peer0")
    peer, prov = stack(classic=True, cache=cache)
    unique = []                  # each block's unique items
    for num, raw in enumerate(raws):
        h0, m0, i0 = (cache.stats["verify_cache_hits_total"],
                      cache.stats["verify_cache_misses_total"], prov.items)
        (res, secs, meta), launches = run(lambda: commit_one(peer, raw))
        codes = res.final_flags.codes()
        unique.append(res.validation.n_unique_items)
        mcodes, mmeta, mrows = mem_rows[num]
        check(codes == mcodes, f"classic block {num}: flags != phase 6's")
        check(codes == labels[num], f"classic block {num}: flags != labels")
        check((*ledger_rows(peer.ledger), peer.ledger.commit_hash) == mrows,
              f"classic block {num}: state, history or commit hash != "
              "phase 6's")
        check(meta == mmeta,
              f"classic block {num}: metadata flags != phase 6's")
        check_launches(f"classic block {num}", launches, kp[:1], kp[1:])
        phase("classic", block=num, txs=len(codes), valid=codes.count(0),
              kp3=launches["p256_verify_rows"], kp2=launches["p256_verify"],
              items_dispatched=prov.items - i0,
              cache_hits=cache.stats["verify_cache_hits_total"] - h0,
              cache_misses=cache.stats["verify_cache_misses_total"] - m0,
              validate_commit_s=round(secs, 4))
    check(provider.stats["fallbacks"] == fb0, "classic: fallbacks != 0")
    phase("classic", stream="equal to phase 6's host stack after every "
          "block (flags, metadata flags, state, history, commit hash) "
          "and to the labels", fallbacks=0, cache_size=len(cache))

    # (b) block 3 through the Python mirror of the C walker
    mirror, _ = stack(classic=True, cache=VerdictCache(CACHE_CAPACITY))
    at_height(mirror, raws, mem_rows, len(raws) - 1)
    mirror.validator.force_python_collect = True
    (res, secs, _), launches = run(lambda: commit_one(mirror, raws[-1]))
    check(res.final_flags.codes() == mem_rows[-1][0]
          and (*ledger_rows(mirror.ledger), mirror.ledger.commit_hash)
          == mem_rows[-1][2], "classic block 3 on collect_py != phase 6's")
    phase("classic", python_mirror=f"block {len(raws) - 1} equal",
          collect_ms=round(res.validation.collect_s * 1e3, 3),
          kp3=launches["p256_verify_rows"], kp2=launches["p256_verify"])

    # (c) verify-once: block 2 on a ledger at height 2 after a
    # speculative fill of its items, then a flipped entry and an epoch bump
    cache = VerdictCache(CACHE_CAPACITY, owner="peer0")
    spec, prov = stack(classic=True, cache=cache)
    at_height(spec, raws, mem_rows, 2)
    msps = spec.validator.msps
    filled, fill_launches = run(lambda: spec_fill(cache, provider, msps,
                                                  raws[2]), count=False)
    check(filled["dropped"] == 0, f"speculative fill of block 2: "
          f"{filled['dropped']} of {filled['endorsement_items']} "
          "endorsement items without a verdict (the queue dropped them)")
    h0, m0 = (cache.stats["verify_cache_hits_total"],
              cache.stats["verify_cache_misses_total"])
    (res, secs, _), launches = run(lambda: commit_one(spec, raws[2]))
    check(all(launches[k] == 0 for k in kp) and prov.items == 0
          and cache.stats["verify_cache_misses_total"] == m0,
          f"spec-filled block 2 dispatched: {launches}, {prov.items} items")
    check(res.final_flags.codes() == mem_rows[2][0]
          and spec.ledger.commit_hash == mem_rows[2][2][2],
          "spec-filled block 2: flags or commit hash != phase 6's")
    phase("classic", spec_fill=filled, fill_launches={
        k: fill_launches[k] for k in kp}, block=2,
        cache_hits=cache.stats["verify_cache_hits_total"] - h0,
        cache_misses=0, unique_items=res.validation.n_unique_items,
        items_dispatched=0, kp3=0, kp2=0,
        validate_commit_s=round(secs, 4))
    # block 3 filled too, one entry's verdict flipped: refused (mac),
    # that one item re-dispatched
    spec_fill(cache, provider, msps, raws[3])
    creators, _ = derive_items(Block.deserialize(raws[3]).data[1], "ch",
                               msps)
    d = item_digest(creators[0])
    mac, verdict, scope, epoch, trace = cache._data[d]
    cache._data[d] = (mac, not verdict, scope, epoch, trace)
    rej0 = dict(cache.stats["verify_cache_rejects_total"])
    (res, _, _), launches = run(lambda: commit_one(spec, raws[3]))
    rej = {k: v - rej0[k] for k, v in
           cache.stats["verify_cache_rejects_total"].items()}
    check(rej == {"mac": 1, "stale": 0} and prov.items == 1,
          f"flipped entry: rejects {rej}, {prov.items} items dispatched")
    check(res.final_flags.codes() == mem_rows[3][0],
          "flipped entry: block 3 flags != phase 6's")
    phase("classic", flipped_entry="refused (mac) and re-verified",
          items_dispatched=prov.items, kp3=launches["p256_verify_rows"],
          kp2=launches["p256_verify"])
    # the same cache, the channel's epoch bumped: block 3 on a fresh
    # ledger re-verifies every item
    bump, prov = stack(classic=True, cache=cache)
    at_height(bump, raws, mem_rows, 3)
    cache.set_epoch(1, scope="ch")
    rej0 = dict(cache.stats["verify_cache_rejects_total"])
    (res, _, _), launches = run(lambda: commit_one(bump, raws[3]))
    stale = cache.stats["verify_cache_rejects_total"]["stale"] - \
        rej0["stale"]
    n3 = res.validation.n_unique_items
    check(stale == n3 and prov.items == n3,
          f"epoch bump: {stale} stale of {n3}, {prov.items} dispatched")
    check(res.final_flags.codes() == mem_rows[3][0],
          "epoch bump: block 3 flags != phase 6's")
    phase("classic", epoch_bump=f"{stale} stale entries re-verified",
          items_dispatched=prov.items, kp3=launches["p256_verify_rows"],
          kp2=launches["p256_verify"])

    # (d) the SBE stream, the channel capability on and off
    sbe_raws, sbe_labels, sbe_counts = sbe
    o12 = orgs[:2]
    phase("classic", sbe_blocks=len(sbe_raws), txs=len(sbe_labels[0]),
          kinds=sbe_counts, cc_policy=SBE_CC_POLICY, key_policies=SBE_POLICIES)
    for caps in ((C.CAP_V2_0, C.CAP_KEY_LEVEL_ENDORSEMENT), (C.CAP_V2_0,)):
        src = C.BundleSource(C.Bundle(C.ChannelConfig(
            "ch", 0, tuple(org_config(C, o) for o in o12),
            C.default_policies([o.mspid for o in o12]), capabilities=caps)))
        sbe_c, _ = stack(classic=True, cache=VerdictCache(CACHE_CAPACITY),
                            bundle=src, policy=SBE_CC_POLICY)
        for num, raw in enumerate(sbe_raws):
            (res, secs, _), launches = run(lambda: commit_one(sbe_c, raw))
            codes = res.final_flags.codes()
            want = (sbe_labels[num] if len(caps) == 2
                    else [0] * len(sbe_labels[num]))
            check(codes == want, f"SBE block {num} (capabilities {caps}): "
                  f"flags != labels, first "
                  f"{[(i, c, w) for i, (c, w) in enumerate(zip(codes, want)) if c != w][:5]}")
            phase("classic", sbe_block=num, capabilities=list(caps),
                  valid=codes.count(0), policy_failures=codes.count(10),
                  flags_vs_labels="equal", kp3=launches["p256_verify_rows"],
                  kp2=launches["p256_verify"],
                  validate_commit_s=round(secs, 4))

    # (e) early abort on blocks 2 and 3, on the classic and the KV7 tail
    for tail in ("classic", "kv7"):
        kw = ({"classic": True, "cache": VerdictCache(CACHE_CAPACITY)}
              if tail == "classic" else {"kv7": True})
        ea, prov = stack(early_abort=True, **kw)
        at_height(ea, raws, mem_rows, 2)
        an = ea.validator.early_abort
        seen = []
        real = an.doomed

        def spy(block, overlay=None, real=real, seen=seen):
            got = real(block, overlay=overlay)
            seen.append(got)
            return got

        an.doomed = spy
        for num in (2, 3):
            i0 = prov.items
            (res, secs, _), launches = run(lambda: commit_one(ea, raws[num]))
            doomed = seen[-1]
            codes = res.final_flags.codes()
            base = mem_rows[num][0]
            for t, (c, b) in enumerate(zip(codes, base)):
                if t in doomed:
                    check(b != 0 and c in (11, 12), f"early abort {tail} "
                          f"block {num} tx {t}: doomed {c}, without {b}")
                else:
                    check(c == b, f"early abort {tail} block {num} tx {t}:"
                          f" {c} != {b} without early abort")
            rows = ledger_rows(ea.ledger)
            check(rows == mem_rows[num][2][:2], f"early abort {tail} block "
                  f"{num}: state or history != phase 6's")
            same = codes == base
            check((ea.ledger.commit_hash == mem_rows[num][2][2]) == same,
                  f"early abort {tail} block {num}: the commit hash differs "
                  "other than where a doomed tx's code does")
            phase("classic", early_abort=tail, block=num, doomed=len(doomed),
                  doomed_codes_differ=sum(c != b for c, b in
                                          zip(codes, base)),
                  items_dispatched=prov.items - i0,
                  items_without=unique[num],
                  kp3=launches["p256_verify_rows"],
                  kp2=launches["p256_verify"],
                  kv7=launches["block_validate"],
                  validate_commit_s=round(secs, 4))

    # (f) phase 9's idemix block, once through the classic tail
    configs, id_raw, id_labels = idemix
    id_msps = {orgs[0].mspid: CachedMSP(orgs[0].msp()),
               **{c.mspid: IdemixMSP(c) for c in configs}}
    idc, _ = stack(classic=True, cache=VerdictCache(CACHE_CAPACITY),
                      msps=id_msps, policy=IDEMIX_POLICY)
    (res, secs, _), launches = run(lambda: commit_one(idc, id_raw))
    check(res.final_flags.codes() == id_labels,
          "idemix block on the classic tail: flags != phase 9's")
    check_launches("classic idemix block", launches, ("bn254_pairing",),
                   kp)
    phase("classic", idemix_block=len(id_labels), flags="equal to phase 9's",
          kb8=launches["bn254_pairing"], kp3=launches["p256_verify_rows"],
          validate_commit_s=round(secs, 3))
    check(provider.stats["fallbacks"] == fb0, "classic: fallbacks != 0")

    # (g) block 2 warm on fresh ledgers at height 2, the stacks in turns
    stacks = {"classic+cache": {"classic": True},
              "deep host": {}, "deep kv7": {"kv7": True},
              "classic spec-filled": {"classic": True}}
    times = {k: [] for k in stacks}
    for _ in range(args.trials):
        for name, kw in stacks.items():
            cache = VerdictCache(CACHE_CAPACITY)
            c, _ = stack(cache=cache if kw.get("classic") else None, **kw)
            at_height(c, raws, mem_rows, 2)
            if name == "classic spec-filled":
                spec_fill(cache, provider, c.validator.msps, raws[2])
            res, secs, _ = commit_one(c, raws[2])
            vr = res.validation
            times[name].append({"total": secs, "collect": vr.collect_s,
                                "dispatch_wait": vr.dispatch_s,
                                "gate": vr.gate_s, "commit": res.commit_s,
                                **{k.removesuffix("_s"): v for k, v in
                                   c.validator.last_timings.items()}})
    for name, rows in times.items():
        med = {k: statistics.median(r[k] for r in rows) * 1e3
               for k in rows[0]}
        phase("classic", block=2, stack=name, warm=True, trials=args.trials,
              validate_commit_ms=round(med.pop("total"), 3),
              **{f"{k}_ms": round(v, 3) for k, v in med.items()},
              card=name_power)
    # one profiled run of the default peer's block 2 (the spec-filled
    # block launches nothing for the profiler to see)
    c, _ = stack(classic=True, cache=VerdictCache(CACHE_CAPACITY))
    at_height(c, raws, mem_rows, 2)
    busy_ms, wall_ms, top = device_busy(torch, {"classic": lambda: (
        commit_one(c, raws[2]), torch.cuda.synchronize())})["classic"]
    phase("classic", profiled="block 2, classic+cache", wall_ms=round(
        wall_ms, 3), device_busy_ms=round(busy_ms, 3),
        device_idle_share=round(1 - busy_ms / wall_ms, 4),
        top_device_ops=top)
    phase("classic", launches=main)
    return main


# ---------------------------------------------------------------------------
# the wavefront window and the pipelined committer (phase 13)
# ---------------------------------------------------------------------------

def pipeline_stream(committer, raws, rows: bool = False, counted=None):
    """The blocks through a PipelinedCommitter over `committer` (whose
    ledger has a commit window): every block submitted, then every
    future awaited -> ([(result, metadata flag bytes, (state rows,
    history rows, commit hash) after the block when `rows` else None,
    {kernel: launches during its submit} when `counted` else None)],
    wall seconds of the submits and waits).  The blocks are parsed
    before the clock starts; with `rows` a commit listener reads each
    block's rows on the retire thread right after its commit."""
    from fabric_tpu_torch.committer import PipelinedCommitter
    from fabric_tpu_torch.protocol import wire
    from fabric_tpu_torch.protocol.types import META_TXFLAGS
    after = {}
    if rows:
        def listener(block, final):
            lg = committer.ledger
            after[int(block.header.number)] = (*ledger_rows(lg),
                                               lg.commit_hash)
        committer.add_commit_listener(listener)
    blocks = [wire.parse_block(raw) for raw in raws]
    counted = counted or {}
    pipe = PipelinedCommitter(committer)
    futs, launches = [], []
    try:
        t0 = time.perf_counter()
        for block in blocks:
            before = {n: f.launches for n, f in counted.items()}
            futs.append(pipe.submit(block))
            launches.append({n: f.launches - before[n]
                             for n, f in counted.items()})
        results = [f.result(timeout=600) for f in futs]
        secs = time.perf_counter() - t0
    finally:
        pipe.close()
    return [(res, bytes(b.metadata.items[META_TXFLAGS]),
             after.get(int(b.header.number)), n if counted else None)
            for res, b, n in zip(results, blocks, launches)], secs


def serial_stream(committer, raws, counted=None, rows: bool = False):
    """The blocks through committer.store_block, parsed before the
    clock starts -> the shape of pipeline_stream's result."""
    from fabric_tpu_torch.protocol import wire
    from fabric_tpu_torch.protocol.types import META_TXFLAGS
    blocks = [wire.parse_block(raw) for raw in raws]
    counted = counted or {}
    out, secs = [], 0.0
    for block in blocks:
        before = {n: f.launches for n, f in counted.items()}
        t0 = time.perf_counter()
        res = committer.store_block(block)
        secs += time.perf_counter() - t0
        lg = committer.ledger
        out.append((res, bytes(block.metadata.items[META_TXFLAGS]),
                    (*ledger_rows(lg), lg.commit_hash) if rows else None,
                    {n: f.launches - before[n] for n, f in counted.items()}
                    if counted else None))
    return out, secs


def spy_doomed(committer) -> dict:
    """{block number: the early-abort analyzer's doom set}, filled as the
    validator asks it."""
    an, seen = committer.validator.early_abort, {}
    real = an.doomed

    def doomed(block, overlay=None):
        got = real(block, overlay=overlay)
        seen[int(block.header.number)] = got
        return got

    an.doomed = doomed
    return seen


def spy_admits(ledger) -> list:
    """[(block, early txs, deferred txs, admit ms)] of the window's
    admits, filled as they happen."""
    win, log = ledger._commit_window, []
    real = win.admit

    def admit(*a, **k):
        e = real(*a, **k)
        log.append((e.num, e.early_n, e.deferred_n,
                    round(e.validate_s * 1e3, 3)))
        return e

    win.admit = admit
    return log


def hold_to_phase6(run: str, out, mem_rows, doomed: dict) -> int:
    """Each block of a run against phase 6's KV7 stack (equal to its host
    stack and the labels): every flag equal but a doomed tx's, which is
    invalid there and MVCC or phantom here; state and history equal;
    metadata flags and the commit hash equal while every flag so far is
    -> the flags that differ."""
    differ, same = 0, True
    for num, (res, meta, rows, _n) in enumerate(out):
        codes = res.final_flags.codes()
        mcodes, mmeta, mrows = mem_rows[num]
        d = doomed.get(num, {})
        for t, (c, m) in enumerate(zip(codes, mcodes)):
            if t in d:
                check(m != 0 and c in (11, 12), f"{run} block {num} tx {t}:"
                      f" doomed {c}, phase 6 {m}")
            else:
                check(c == m, f"{run} block {num} tx {t}: {c} != phase 6's "
                      f"{m}")
        differ += sum(c != m for c, m in zip(codes, mcodes))
        same = same and codes == mcodes
        check(rows[0] == mrows[0], f"{run} block {num}: state rows")
        check(rows[1] == mrows[1], f"{run} block {num}: history rows")
        check((meta == mmeta) == (codes == mcodes),
              f"{run} block {num}: metadata flags")
        check((rows[2] == mrows[2]) == same, f"{run} block {num}: commit "
              "hash differs other than where a flag does")
    return differ


def tree_digest(root: str) -> dict:
    """{path relative to root: (bytes, sha256)} of every file under root."""
    out = {}
    for d, _s, fs in os.walk(root):
        for f in fs:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                data = fh.read()
            out[os.path.relpath(path, root)] = (
                len(data), hashlib.sha256(data).hexdigest())
    return out


def window_phase(torch, args, provider, orgs, signers, raws, labels,
                 mem_rows, durable_out, profiled, fns, name_power,
                 dev) -> dict:
    """Phase 13.  The cross-block window on the card: the stream's wall
    time serial and windowed, in turns; the commit stream through
    PipelinedCommitter on windowed ledgers, held to phase 6; the durable
    window's directory against the serial one's, a retire failure and
    its redelivery; snapshot export and install; the ACL gate.
    durable_out: phase 11's numbers (its post-crash blocks, their flags,
    the final commit hash); profiled: phase 7's session's run of the
    windowed stream.  -> {kernel: launches} of its main-path runs."""
    import shutil
    import threading
    from fabric_tpu_torch import config as C
    from fabric_tpu_torch.bccsp.sw import SoftwareProvider
    from fabric_tpu_torch.committer import PipelinedCommitter
    from fabric_tpu_torch.ledger import BlockStoreError, ConfigHistory
    from fabric_tpu_torch.ledger import snapshot
    from fabric_tpu_torch.msp import CachedMSP
    from fabric_tpu_torch.ops import block_validate as kv7
    from fabric_tpu_torch.policy import ACLError, ACLProvider, SignedData
    from fabric_tpu_torch.protocol import block_header_hash, build, wire
    counted = {**fns, "block_validate": kv7.block_validate_kernel}
    kp = ("p256_verify_rows", "p256_verify")
    main = dict.fromkeys(counted, 0)
    fb0 = provider.stats["fallbacks"]
    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, "build", "window")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    msps = {o.mspid: CachedMSP(o.msp()) for o in orgs}
    phase("window", windows=list(WINDOWS), commit_workers=WINDOW_WORKERS,
          host_cpus=os.cpu_count(), card=name_power)

    def run(fn):
        """fn() with every count set to 0 just before and read just after,
        added to the phase's main-path launches."""
        for f in counted.values():
            f.launches = 0
        out = fn()
        for n, f in counted.items():
            main[n] += f.launches
        return out

    # (c) the stream's wall time, serial and windowed, on memory and on
    # the durable ledger, fresh ledgers, in turns (the KV7 stack, no early
    # abort); the window's admits and overlap.  Trial 0's durable ledgers
    # stay for (b) and (d), its serial in-memory run gives the KV7 tail's
    # KP3/KP2 launches each block for (a)
    cells = [(ledger, W) for ledger in ("memory", "durable")
             for W in (0, *WINDOWS)]
    times = {cell: [] for cell in cells}
    stages = {cell: [] for cell in cells}
    admits, overlap, kept, serial_kp = {}, {}, {}, {}
    for trial in range(max(3, args.trials)):
        for ledger, W in cells:
            kw = {"commit_window": W} if W else {}
            root = os.path.join(base, f"t{trial}_{W}")
            if ledger == "memory":
                c, _ = commit_stack(provider, orgs, True, dev, **kw)
            else:
                c, _ = durable_stack(provider, dev, root, msps=msps, **kw)
            if W:
                log = spy_admits(c.ledger)
                out, secs = run(lambda: pipeline_stream(c, raws))
                admits[ledger, W] = log
                overlap.setdefault((ledger, W), []).append(
                    c.ledger._commit_window.overlap_frac())
            else:
                out, secs = run(lambda: serial_stream(c, raws, counted))
            check([r.final_flags.codes() for r, *_x in out]
                  == [m[0] for m in mem_rows]
                  and c.ledger.commit_hash == mem_rows[-1][2][2],
                  f"{ledger} W={W}: flags or commit hash != phase 6's")
            times[ledger, W].append(secs * 1e3)
            # the stream's stages summed over its blocks: pass 1, the
            # dispatch wait, the gate (the submitting thread's), and the
            # ledger's commit (the retire thread's when windowed)
            vrs = [(r.validation, r.commit_s) for r, *_x in out]
            stages[ledger, W].append({
                "collect": sum(v.collect_s for v, _c in vrs),
                "dispatch_wait": sum(v.dispatch_s for v, _c in vrs),
                "gate": sum(v.gate_s for v, _c in vrs),
                "commit": sum(c_ for _v, c_ in vrs)})
            if trial == 0 and ledger == "durable":
                kept[W] = (root, c)
            elif ledger == "durable":
                shutil.rmtree(root)
            if trial == 0 and (ledger, W) == ("memory", 0):
                serial_kp[True] = [{k: n[k] for k in kp} for *_x, n in out]
    print(name_power, flush=True)
    for (ledger, W), ms in times.items():
        row = {"stream": ledger, "window": W or "serial",
               "trials": len(ms), "median_ms": round(statistics.median(ms),
                                                     3),
               "min_ms": round(min(ms), 3), "max_ms": round(max(ms), 3),
               "runs_ms": [round(v, 3) for v in ms],
               **{f"{k}_ms": round(statistics.median(
                   r[k] for r in stages[ledger, W]) * 1e3, 3)
                  for k in stages[ledger, W][0]}}
        if W:
            row.update(overlap_frac=[round(v, 4) for v in overlap[ledger, W]],
                       last_admits=admits[ledger, W])
        phase("window", **row, card=name_power)
    for label, (b_ms, w_ms, tp) in profiled.items():
        phase("window", profiled=label, wall_ms=round(w_ms, 3),
              device_busy_ms=round(b_ms, 3),
              device_idle_share=round(1 - b_ms / w_ms, 4),
              top_device_ops=tp)

    # (a) the stream through the pipeline, early abort on the window's
    # overlay, held to phase 6 after every block and to the serial runs'
    # KP3/KP2 launches each block: W 2 and 4, the parallel commit off and
    # on, the deep host and the KV7 tail, each value of each met twice
    # (every pair of W and tail once).  First the serial host stack with
    # the wavefront scheduler and early abort, held to phase 6
    c, _ = commit_stack(provider, orgs, False, dev, early_abort=True,
                        parallel_commit=True, commit_workers=WINDOW_WORKERS)
    doomed = spy_doomed(c)
    out, secs = run(lambda: serial_stream(c, raws, counted, rows=True))
    serial_kp[False] = [{k: n[k] for k in kp} for *_x, n in out]
    differ = hold_to_phase6("serial, parallel_commit", out, mem_rows, doomed)
    phase("window", run="serial, parallel_commit, early abort",
          vs_phase6="equal (flags but doomed, metadata, state, history, "
          "commit hash)", doomed=[len(doomed.get(i, {}))
                                  for i in range(len(raws))],
          doomed_codes_differ=differ, stream_s=round(secs, 4),
          **c.ledger._commit_scheduler.stats())
    for W, parallel, kv7_on in WINDOW_RUNS:
        name = (f"W={W} {'parallel' if parallel else 'serial MVCC'}"
                f" {'kv7' if kv7_on else 'host'}")
        c, dv = commit_stack(
            provider, orgs, kv7_on, dev, early_abort=True, commit_window=W,
            parallel_commit=parallel, commit_workers=WINDOW_WORKERS)
        doomed = spy_doomed(c)
        log = spy_admits(c.ledger)
        out, secs = run(lambda: pipeline_stream(c, raws, True, counted))
        differ = hold_to_phase6(name, out, mem_rows, doomed)
        for num, (res, _m, _r, n) in enumerate(out):
            check({k: n[k] for k in kp} == serial_kp[kv7_on][num],
                  f"{name} block {num}: KP3/KP2 launches {n} != the serial "
                  f"run's {serial_kp[kv7_on][num]}")
        row = {"run": name, "blocks": len(out),
               "doomed": [len(doomed.get(i, {})) for i in range(len(raws))],
               "doomed_codes_differ": differ, "admits": log,
               "stream_s": round(secs, 4),
               "launches": [{k: v for k, v in n.items() if v}
                            for *_x, n in out]}
        if dv is not None:
            dem = {k: v for k, v in dv.stats[
                "validator_device_demotions_total"].items() if v}
            check(set(dem) <= set(WINDOW_DEMOTIONS),
                  f"{name}: KV7 demotions {dem}")
            row.update(kv7_blocks=dv.stats["validator_device_blocks_total"],
                       demotions=dem)
        if parallel:
            row["scheduler"] = c.ledger._commit_scheduler.stats()
        st = c.ledger._commit_window.stats()
        row["window"] = {k: st[k] for k in (
            "admitted", "retired", "early_txs", "deferred_txs",
            "overlap_frac")}
        phase("window", vs_phase6="equal (flags but doomed, metadata, "
              "state, history, commit hash)", **row)
    check(provider.stats["fallbacks"] == fb0, "window: fallbacks != 0")

    # (b) the durable window: (c)'s first durable W=4 directory against
    # its serial one, byte for byte; then a retire failure in block 2 and
    # the redelivery
    serial_tree = tree_digest(kept[0][0])
    window_tree = tree_digest(kept[4][0])
    differ = sorted(k for k in set(serial_tree) | set(window_tree)
                    if serial_tree.get(k) != window_tree.get(k))
    check(not differ, f"durable W=4 directory != the serial one's: {differ}")
    phase("window", durable="W=4", vs_phase6="equal (flags, commit hash)",
          directory="equal to the serial durable stack's, byte for byte "
          f"({len(serial_tree)} files, "
          f"{sum(v[0] for v in serial_tree.values())} bytes)")
    cf, _ = durable_stack(provider, dev, os.path.join(base, "fail"),
                          msps=msps, commit_window=4)
    lg = cf.ledger
    go, finished = threading.Event(), []
    real_finish = lg._commit_window.finish

    def failing_finish(db, entry):
        if entry.num == 2 and 2 not in finished:
            go.wait(600)
            finished.append(2)
            raise RuntimeError("injected retire failure")
        finished.append(entry.num)
        return real_finish(db, entry)

    lg._commit_window.finish = failing_finish
    pipe = PipelinedCommitter(cf)
    futs = [pipe.submit(wire.parse_block(raw)) for raw in raws]
    go.set()
    outcome = []
    for f in futs:
        try:
            f.result(timeout=600)
            outcome.append("ok")
        except RuntimeError as exc:
            outcome.append(str(exc).split(":")[0])
    pipe.close()
    check(outcome == ["ok", "ok", "injected retire failure",
                      "pipeline broken at block 2"],
          f"retire failure: futures {outcome}")
    check(lg.blockstore.height == 2 and lg.height == 2
          and lg._commit_window.depth() == 0,
          f"retire failure: block store at height {lg.blockstore.height}")
    pipe = PipelinedCommitter(cf)
    try:
        again = [pipe.submit(wire.parse_block(raw)) for raw in raws[1:]]
        res = [f.result(timeout=600) for f in again]
    finally:
        pipe.close()
    check(res[0].commit_stats is None, "redelivered block 1 recommitted")
    check(finished == [0, 1, 2, 2, 3], f"finishes {finished}")
    check((*ledger_rows(lg), lg.commit_hash) == mem_rows[-1][2],
          "after the redelivery: state, history or commit hash != phase 6")
    check(tree_digest(os.path.join(base, "fail")) == serial_tree,
          "after the redelivery: directory != the serial one's")
    phase("window", retire_failure="block 2: its future and block 3's "
          "failed, the block store stayed at blocks 0-1; redelivered: "
          "block 1 acknowledged, blocks 2 and 3 finished once each",
          futures=outcome, finishes=finished,
          vs_serial="equal (commit hash, state, history, directory)")

    # (d) snapshot: export (c)'s first durable W=4 ledger, every file
    # through serve_chunk, install into a fresh root, open; then phase
    # 11's post-crash blocks on the KV7 stack over the installed ledger
    src_lg = kept[4][1].ledger
    installed = os.path.join(base, "installed")
    t0 = time.perf_counter()
    meta = snapshot.export_meta(src_lg)
    export_s = time.perf_counter() - t0
    payloads, chunks, nbytes = {"state": [], "history": []}, 0, 0
    t0 = time.perf_counter()
    for ent in meta["files"]:
        buf = bytearray()
        while True:
            resp = snapshot.serve_chunk(src_lg, ent["db"], ent["gen"],
                                        ent["file"], len(buf))
            buf += resp["data"]
            chunks += 1
            if resp["eof"]:
                break
        check(hashlib.sha256(bytes(buf)).hexdigest() == ent["sha256"],
              f"snapshot file {ent['file']}: sha256")
        payloads[ent["db"]].append(bytes(buf))
        nbytes += len(buf)
    serve_s = time.perf_counter() - t0
    check(snapshot.needs_bootstrap(installed, "ch"),
          "snapshot: a fresh root needs no bootstrap")
    t0 = time.perf_counter()
    snapshot.install(installed, "ch", meta, payloads)
    install_s = time.perf_counter() - t0
    h = int(meta["height"])
    bsrc = C.BundleSource(C.Bundle(C.ChannelConfig(
        "ch", 0, tuple(org_config(C, o) for o in orgs),
        C.default_policies([o.mspid for o in orgs]))))
    t0 = time.perf_counter()
    ci, dvi = durable_stack(provider, dev, installed, bundle=bsrc,
                            history=ConfigHistory(os.path.join(
                                installed, "ch", "confighistory")))
    open_s = time.perf_counter() - t0
    ilg = ci.ledger
    check(ilg.height == h and ilg.commit_hash == meta["commit_hash"]
          and ilg.commit_hash == mem_rows[h - 1][2][2],
          "installed snapshot: height or commit hash")
    check(ledger_rows(ilg) == mem_rows[h - 1][2][:2],
          "installed snapshot: state or history != phase 6 at its height")
    try:
        ilg.blockstore.get_by_number(0)
        pruned = False
    except BlockStoreError as exc:
        pruned = "pruned" in str(exc)
    check(pruned, "installed snapshot: block 0 does not read as pruned")
    phase("window", snapshot_height=h, files=len(meta["files"]),
          chunks=chunks, bytes=nbytes, export_ms=round(export_s * 1e3, 3),
          serve_ms=round(serve_s * 1e3, 3),
          install_ms=round(install_s * 1e3, 3),
          open_ms=round(open_s * 1e3, 3), below_base="pruned",
          vs_phase6="equal (state, history, commit hash)", card=name_power)
    tail = [(f"block{n}", raws[n]) for n in range(h, len(raws))]
    tail += durable_out["tail"]
    want = {**{f"block{n}": mem_rows[n][0] for n in range(len(raws))},
            **durable_out["tail_codes"]}

    def post_crash():
        for what, raw in tail:
            got = ci.store_block(wire.parse_block(raw)).final_flags.codes()
            check(got == want[what], f"installed: {what} flags")

    run(post_crash)
    check(ilg.commit_hash == durable_out["final_hash"],
          "installed: commit hash after phase 11's post-crash blocks != "
          "the ledger that took no snapshot")
    phase("window", installed=f"{len(tail)} blocks committed on the KV7 "
          "stack over the installed ledger", kv7_blocks=dvi.stats[
              "validator_device_blocks_total"],
          commit_hash="equal to phase 11's", sequence=bsrc.current().sequence)

    # (e) the ACL gate on the CUDA provider, each decision against the
    # software provider's, a config block retargeting peer/Propose
    acl_src = C.BundleSource(C.Bundle(C.ChannelConfig(
        "ch", 0, tuple(org_config(C, o) for o in orgs),
        C.default_policies([o.mspid for o in orgs]))))
    acl = ACLProvider(acl_src, provider)
    sw_acl = ACLProvider(acl_src, SoftwareProvider())
    member, admin = orgs[0].new_identity("acl-member"), orgs[0].admin
    acl_launches = dict.fromkeys(kp, 0)

    def sd(ident, flip=False):
        sig = bytearray(ident.sign(b"proposal"))
        if flip:
            sig[-1] ^= 1
        return SignedData(b"proposal", ident.serialize(), bytes(sig))

    def decide(resource, data, want):
        out = []
        for a in (acl, sw_acl):
            for f in counted.values():
                f.launches = 0
            try:
                a.check_acl(resource, data)
                out.append("allow")
            except ACLError:
                out.append("deny")
            if a is acl:
                for k in kp:
                    acl_launches[k] += counted[k].launches
                    main[k] += counted[k].launches
        check(out == [want, want], f"ACL {resource}: {out}, want {want}")
        return out[0]

    cases = [("peer/Propose member", decide("peer/Propose", sd(member),
                                            "allow")),
             ("peer/Propose flipped", decide("peer/Propose",
                                             sd(member, True), "deny")),
             ("cscc/JoinChain member", decide("cscc/JoinChain", sd(member),
                                              "deny"))]
    # Admins is a majority of the orgs' admins: one admin's signature
    # satisfies it on a channel of Org1 alone, as in the reference's test
    three = (acl, sw_acl)
    one = C.BundleSource(C.Bundle(C.ChannelConfig(
        "ch1", 0, (org_config(C, orgs[0]),),
        C.default_policies([orgs[0].mspid]))))
    acl, sw_acl = ACLProvider(one, provider), ACLProvider(
        one, SoftwareProvider())
    cases += [("cscc/JoinChain member, Org1 alone", decide(
                  "cscc/JoinChain", sd(member), "deny")),
              ("cscc/JoinChain admin, Org1 alone", decide(
                  "cscc/JoinChain", sd(admin), "allow")),
              ("cscc/JoinChain admin, Org1-Org3", "deny")]
    acl, sw_acl = three
    decide("cscc/JoinChain", sd(admin), "deny")
    cc, _ = commit_stack(provider, orgs, False, dev, bundle=acl_src,
                         commit_window=2)
    cfg = C.ChannelConfig("ch", 1, tuple(org_config(C, o) for o in orgs),
                          C.default_policies([o.mspid for o in orgs]),
                          acls={"peer/Propose": "Admins"})
    env = C.build_config_envelope(cfg, [signers[0], *[o.admin
                                                      for o in orgs]])
    cfg_block = build.new_block(1, block_header_hash(
        wire.parse_block(raws[0]).header), [env]).serialize()
    pipe = PipelinedCommitter(cc)
    try:
        f0 = run(lambda: pipe.submit(wire.parse_block(raws[0])))
        before = decide("peer/Propose", sd(member), "allow")
        f1 = run(lambda: pipe.submit(wire.parse_block(cfg_block)))
        check(f0.done() and f1.result(timeout=600).final_flags.codes()
              == [0], "ACL config block: not committed valid")
    finally:
        pipe.close()
    cases += [("peer/Propose member, before the config block", before),
              ("peer/Propose member, after", decide(
                  "peer/Propose", sd(member), "deny")),
              ("peer/Propose one admin, after (Admins: a majority of "
               "Org1-Org3's)", decide("peer/Propose", sd(admin), "deny"))]
    check(acl_src.current().sequence == 1 and acl.policy_name(
        "peer/Propose") == "Admins", "ACL config block not applied")
    check(acl_launches["p256_verify_rows"] + acl_launches["p256_verify"]
          > 0, f"ACL checks launched no KP3/KP2: {acl_launches}")
    phase("window", acl=dict(cases), vs_sw="equal", launches=acl_launches,
          config_block="retargets peer/Propose to Admins at its boundary")
    check(provider.stats["fallbacks"] == fb0 == 0, "window: fallbacks")
    shutil.rmtree(base, ignore_errors=True)
    phase("window", launches=main, fallbacks=0)
    return main


# ---------------------------------------------------------------------------
# the idemix lane
# ---------------------------------------------------------------------------

def idemix_world():
    """Two issuers by the port's idemixgen, IDEMIX_SIGNERS members each,
    and a forged signer of the first issuer (a random A: every host check
    of its presentations passes, only the pairing equation fails) ->
    (MSP configs, signers, forged signer)."""
    import os
    import tempfile
    from fabric_tpu_torch.idemix import bn254 as hb
    from fabric_tpu_torch.idemix import gen
    from fabric_tpu_torch.idemix.msp import IdemixSigningIdentity
    configs, signers = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(2):
            d = os.path.join(tmp, f"IdemixOrg{k + 1}")
            out = gen.generate(d, f"IdemixOrg{k + 1}", [
                f"user{j}:engineering:member" for j in range(IDEMIX_SIGNERS)])
            configs.append(out["config"])
            signers += [gen.load_signer(path, os.path.join(
                d, "msp_config.bin")) for path in out["signers"].values()]
    s = signers[0]
    c = s._cred
    forged = IdemixSigningIdentity(
        s.mspid, s._config,
        type(c)(hb.g1_mul(12345, hb.G1_GEN), c.e, c.s, list(c.attrs)),
        s.ou, s.role, handle_sig=s._handle_sig)
    return configs, signers, forged


def build_idemix_block(signers, forged, endorser, pool):
    """IDEMIX_TXS endorser txs whose creators are the idemix signers in
    turn, endorsed by Org1's peer, each writing one key; the txs of
    IDEMIX_BAD carry a presentation over another payload, the forged
    credential's or garbage -> (block bytes, labels: 0 valid, 4 bad
    creator signature)."""
    rng = random.Random(SEED + 12)
    creators = [endorser] + [_IdemixCreator(s) for s in signers]
    bad = {"nonce": len(creators), "forged": len(creators) + 1,
           "garbage": len(creators) + 2}
    creators += [_IdemixCreator(signers[0], "nonce"),
                 _IdemixCreator(forged), _IdemixCreator(signers[0],
                                                        "garbage")]
    specs, labels = [], []
    for t in range(IDEMIX_TXS):
        kind = IDEMIX_BAD.get(t)
        who = bad[kind] if kind else 1 + t % len(signers)
        specs.append((who, [0], rng.randbytes(24), [],
                      [(f"idemix{t:03d}", b"v%d" % t, False)], [], None))
        labels.append(4 if kind else 0)
    jobs = [(creators, specs[lo:lo + 4]) for lo in range(0, len(specs), 4)]
    envs = [e for part in pool.map(_envelope_job, jobs) for e in part]
    return chain_blocks([envs])[0], labels


def seeded_checks(n: int, seed: int) -> dict:
    """n pairing checks e(A'_i, w_j) * e(-Abar_i, g2) == 1 under two
    issuers (w_j = x_j g2, slots 1 and 2), with no presentations: A'_i
    chained by additions of G1, Abar_i = x_j A'_i chained by additions of
    x_j G1.  CORRUPT_FRAC of them in PAIR_KINDS: Abar made with x_j + 1,
    the other issuer's slot, P1 and P2 swapped."""
    import numpy as np
    from fabric_tpu_torch.idemix import bn254 as hb
    from fabric_tpu_torch.ops import bn254 as kb8
    rng = random.Random(seed)
    xs = [rng.randrange(2, hb.R) for _ in range(2)]
    flags, lines = kb8.stack_lines(
        [kb8.pack_steps(hb.ate_precompute(q)) for q in
         [hb.G2_GEN] + [hb.g2_mul(x, hb.G2_GEN) for x in xs]])
    kinds = [None] * n
    for j, i in enumerate(rng.sample(range(n), max(len(PAIR_KINDS),
                                                    int(n * CORRUPT_FRAC)))):
        kinds[i] = PAIR_KINDS[j % len(PAIR_KINDS)]
    a = hb.g1_mul(rng.randrange(1, hb.R), hb.G1_GEN)
    steps = [hb.g1_mul(x, hb.G1_GEN) for x in xs]
    abar = [hb.g1_mul(x, a) for x in xs]
    cols, slot = [[], [], [], []], []
    for i in range(n):
        j = rng.randrange(2)
        p1, p2, s = a, hb.g1_neg(abar[j]), j + 1
        if kinds[i] == "x_plus_1":
            p2 = hb.g1_neg(hb.g1_add(abar[j], a))
        elif kinds[i] == "other_slot":
            s = 2 - j
        elif kinds[i] == "swapped":
            p1, p2 = p2, p1
        for c, v in zip(cols, (*p1, *p2)):
            c.append(v)
        slot.append(s)
        a = hb.g1_add(a, hb.G1_GEN)
        abar = [hb.g1_add(b, st) for b, st in zip(abar, steps)]
    return {"flags": flags, "lines": lines,
            "slot": np.asarray(slot, np.int32), "cols": cols,
            "kinds": kinds, "labels": [k is None for k in kinds]}


def item_checks(parts) -> dict:
    """KB8's inputs for the items whose host checks passed (`parts`, the
    results of `collect_item_parts`), laid out as the provider lays them
    out: slot 0 g2's lines, then one slot per issuer's w in order of
    first sight; P1 = A', P2 = -Abar.  `keep`: the items checked."""
    import numpy as np
    from fabric_tpu_torch.idemix import bn254 as hb
    from fabric_tpu_torch.idemix.msp import deserialize_ipk
    from fabric_tpu_torch.ops import bn254 as kb8
    issuers, keep, slot, cols = {}, [], [], [[], [], [], []]
    for i, (ok, ipk_bytes, pair) in enumerate(parts):
        if not ok:
            continue
        keep.append(i)
        slot.append(issuers.setdefault(ipk_bytes, len(issuers) + 1))
        (x1, y1), (x2, y2) = pair
        for c, v in zip(cols, (x1, y1, x2, (hb.P - y2) % hb.P)):
            c.append(v)
    flags, lines = kb8.stack_lines([kb8.g2_packed()] + [
        kb8.pack_steps(hb.ate_precompute(deserialize_ipk(k).w))
        for k in issuers])
    return {"flags": flags, "lines": lines, "keep": keep,
            "slot": np.asarray(slot, np.int32), "cols": cols}


def kb8_args(torch, dev, checks: dict) -> tuple:
    """(flags, lines, slot, x1, y1, x2, y2) of `checks` for KB8's
    wrapper: the slot on the host, the rest on `dev`."""
    from fabric_tpu_torch.ops import bn254 as kb8
    return (torch.from_numpy(checks["flags"]).to(dev),
            torch.from_numpy(checks["lines"]).to(dev),
            torch.from_numpy(checks["slot"]),
            *[torch.from_numpy(kb8.ints_to_words(c)).to(dev)
              for c in checks["cols"]])


def idemix_phase(torch, args, provider, org1, configs, raw, labels, fns,
                 imad_rate: float, clock_hz: float):
    """Phase 9: the config-4 probe, KB8 against its plain version and the
    labels on a seeded load, the block of idemix creators through two
    port stacks (the factory's CUDA provider and the SW provider, KV7 on
    in both) and the creators' items through batch_verify.  -> (KB8's
    row of the kernels line, the main-path launches of KB8 and KV7)."""
    import numpy as np
    from fabric_tpu_torch.bccsp import VerifyItem
    from fabric_tpu_torch.bccsp.sw import SoftwareProvider
    from fabric_tpu_torch.idemix.msp import IdemixMSP, collect_item_parts
    from fabric_tpu_torch.msp import CachedMSP
    from fabric_tpu_torch.ops import block_validate as kv7
    from fabric_tpu_torch.ops import bn254 as kb8
    from fabric_tpu_torch.protocol import Block, Envelope
    dev = torch.device("cuda")
    counted = {**fns, "block_validate": kv7.block_validate_kernel}
    main = {"bn254_pairing": 0, "block_validate": 0}

    def main_run(run: str, fn, on: tuple, maybe: tuple = ()):
        """A main-path run: every count to 0 just before, read after."""
        for f in counted.values():
            f.launches = 0
        out = fn()
        launches = {name: f.launches for name, f in counted.items()}
        check_launches(f"idemix {run}", launches, on, maybe)
        for name in main:
            main[name] += launches[name]
        return out, launches

    # part 1: BASELINE config 4's probe through the factory's provider
    def probe():
        fn, green, red = provider.idemix_pair_probe(IDEMIX_PROBE)
        return fn(*green).cpu(), fn(*red).cpu()

    (green, red), launches = main_run("probe", probe, ("bn254_pairing",))
    check(bool(green.all()) and not bool(red.any()),
          "config-4 probe: green must be all True, red all False")
    phase("idemix", probe=IDEMIX_PROBE, green="all True", red="all False",
          launches=launches["bn254_pairing"])

    # part 2: a seeded load, KB8 against its plain version and the labels
    t0 = time.perf_counter()
    load = seeded_checks(IDEMIX_CHECKS, SEED + 11)
    load_s = time.perf_counter() - t0
    args9 = kb8_args(torch, dev, load)
    kern = kb8.bn254_pairing_check(*args9)
    plain, plain_ms = timed_once(torch, lambda: kb8.pairing_check_batch(
        *args9))
    check(torch.equal(kern, plain), "KB8 != pairing_check_batch on the "
          "seeded load")
    wrong = [i for i, (g, w) in enumerate(zip(kern.cpu().tolist(),
                                              load["labels"])) if g != w]
    check(not wrong, f"KB8 != labels, first {[(i, load['kinds'][i]) for i in wrong[:5]]}")
    err = int((kern.to(torch.int8) - plain.to(torch.int8)).abs().max())
    kb8_ms = event_ms(torch, lambda: kb8.bn254_pairing_check(*args9),
                      args.trials)
    n = IDEMIX_CHECKS
    ops = kb8.fp_ops_per_check(load["flags"])

    def bound(args) -> tuple:
        """(ms, by) of KB8's bound on these inputs: the least multiply-
        adds over the card's rate, or the bytes over its memory rate."""
        b = args[-1].shape[1]
        ops_s = (b * kb8.imads_per_check(args[0].cpu().tolist())
                 + kb8.imads_per_launch()) / imad_rate
        bytes_s = (b * (4 * 32 + 4 + 1) + args[1].nbytes + args[0].nbytes
                   ) / HBM_BYTES_PER_S
        return (max(ops_s, bytes_s) * 1e3,
                "operations" if ops_s >= bytes_s else "bytes")

    bound_ms, bound_by = bound(args9)
    issued = kb8.fp_ops_issued(load["flags"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def cycles(ms: float, b: int) -> tuple:
        """(SM-cycles a multiply over every check's multiplies, on the
        SMs the launch fills; one thread's chain cycles a multiply)."""
        used = min(sms, -(-b // kb8.THREADS))
        return (round(ms * 1e-3 * clock_hz * used / (b * issued), 3),
                round(ms * 1e-3 * clock_hz / issued, 1))

    phase("idemix", checks=n, issuers=2, lines=tuple(args9[1].shape),
          corrupted={k: load["kinds"].count(k) for k in PAIR_KINDS},
          build_s=round(load_s, 2), kb8_vs_plain="equal",
          verdicts_vs_labels="equal", valid=sum(load["labels"]))
    phase("idemix", kb8_ms=round(kb8_ms, 4), kb8_plain_ms=round(plain_ms, 2),
          kb8_bound_ms=round(bound_ms, 4), kb8_bound_by=bound_by,
          fp_mults_per_check=sum(ops.values()),
          fp_mults_issued=issued,
          imads_per_check=kb8.imads_per_check(load["flags"]),
          us_per_check=round(kb8_ms * 1e3 / n, 3),
          sm_cycles_per_mul=cycles(kb8_ms, n)[0],
          chain_cycles_per_mul=cycles(kb8_ms, n)[1])

    # part 3: the block of idemix creators through two port stacks
    msps = {org1.mspid: CachedMSP(org1.msp()),
            **{c.mspid: IdemixMSP(c) for c in configs}}

    def stack(prov):
        return commit_stack(prov, [org1], True, dev, msps=msps,
                            policy=IDEMIX_POLICY)

    sw = SoftwareProvider()
    outs, secs = {}, {}
    before = dict(provider.stats)
    for name, prov in (("cuda", provider), ("sw", sw)):
        committer, _ = stack(prov)
        (res, _meta, secs[name], rows), launches = main_run(
            f"block {name}", lambda: commit_stream(committer, [raw],
                                                   rows=True)[0],
            ("bn254_pairing", "block_validate") if name == "cuda"
            else ("block_validate",),
            # Org1's endorsements: KP3 when its key holds a bank slot
            maybe=("p256_verify_rows", "p256_verify"))
        outs[name] = (res.final_flags.codes(), rows)
        phase("idemix", block_stack=name, launches=launches,
              validate_commit_s=round(secs[name], 3))
    delta = {k: v - before[k] for k, v in provider.stats.items()}
    codes, rows = outs["cuda"]
    check(codes == outs["sw"][0], "idemix block: CUDA flags != SW flags")
    check(rows == outs["sw"][1],
          "idemix block: state, history or commit hash differ")
    check(codes == labels, f"idemix block: flags {codes} != labels {labels}")
    check(delta["fallbacks"] == 0, "idemix block: fallbacks != 0")

    # the creators' items: their host checks give KB8's inputs at the
    # block's own shape, held against the plain version and the labels
    items = []
    for data in Block.deserialize(raw).data:
        env = Envelope.deserialize(data)
        ident = msps_ident(msps, env.header().signature_header.creator)
        items.append(ident.verify_item(env.payload, env.signature))
    t0 = time.perf_counter()
    parts = [collect_item_parts(it) for it in items]
    collect_ms = (time.perf_counter() - t0) * 1e3 / len(items)
    blk_checks = item_checks(parts)
    blk = kb8_args(torch, dev, blk_checks)
    kern = kb8.bn254_pairing_check(*blk)
    plain, block_plain_ms = timed_once(torch, lambda: (
        kb8.pairing_check_batch(*blk)))
    check(torch.equal(kern, plain), "KB8 != pairing_check_batch on the "
          "block's checks")
    check(kern.cpu().tolist() == [labels[i] == 0
                                  for i in blk_checks["keep"]],
          "KB8 != labels on the block's checks")
    block_kb8_ms = event_ms(torch, lambda: kb8.bn254_pairing_check(*blk),
                            args.trials)
    block_bound_ms, block_bound_by = bound(blk)
    phase("idemix", block_txs=len(codes), valid=codes.count(0),
          bad_creator=codes.count(4), kb8_checks=len(blk_checks["keep"]),
          flags_vs_labels="equal", cuda_vs_sw="equal (flags, state, "
          "history, commit hash)", commit_hash=rows[2].hex()[:16],
          fallbacks=0, cut=f"{IDEMIX_TXS} txs: the host checks of each "
          "presentation (collect_item_parts) run serially in pure Python "
          "inside the provider's enqueue, as in the reference")

    # the creators' items and two cross-issuer swaps through batch_verify
    a, b = items[0], items[2]            # one creator of each issuer
    check(a.pubkey != b.pubkey, "swap: the creators share an issuer")
    items += [VerifyItem(b.scheme, b.pubkey, a.signature, b.payload),
              VerifyItem(a.scheme, a.pubkey, b.signature, a.payload)]
    want = np.asarray([c == 0 for c in labels] + [False, False])

    def verify():
        t = time.perf_counter()
        resolve = provider.batch_verify_async(items)
        enq = time.perf_counter() - t
        return resolve(), enq, time.perf_counter() - t

    (got, enqueue_s, total_s), launches = main_run(
        "batch_verify", verify, ("bn254_pairing",))
    sw_got = sw.batch_verify(items)
    check((got == sw_got).all(), "idemix items: CUDA verdicts != SW")
    check((got == want).all(), "idemix items: verdicts != labels")
    phase("idemix", items=len(items), swaps=2, verdicts_vs_sw="equal",
          verdicts_vs_labels="equal", launches=launches["bn254_pairing"],
          collect_ms_per_item=round(collect_ms, 2),
          enqueue_ms=round(enqueue_s * 1e3, 2),
          batch_verify_ms=round(total_s * 1e3, 2),
          block_kb8_ms=round(block_kb8_ms, 4),
          block_kb8_plain_ms=round(block_plain_ms, 2),
          block_kb8_bound_ms=round(block_bound_ms, 6),
          block_kb8_bound_by=block_bound_by,
          block_chain_cycles_per_mul=cycles(block_kb8_ms,
                                            len(blk_checks["keep"]))[1])

    # one profiled block on a fresh CUDA stack
    committer, _ = stack(provider)
    busy_ms, wall_ms, top = device_busy(torch, {
        "idemix block": lambda: commit_stream(committer, [raw])})[
            "idemix block"]
    phase("idemix", profiled="idemix block", wall_ms=round(wall_ms, 3),
          device_busy_ms=round(busy_ms, 3),
          device_idle_share=round(1 - busy_ms / wall_ms, 4),
          top_device_ops=top)
    phase("idemix", library="none: no PyTorch call computes a pairing")
    return {"name": "bn254_pairing", "route": "cuda",
            "source": "fabric_tpu_torch/ops/csrc/bn254_pairing.cu",
            "replaces": "fabric_tpu/ops/bn254_batch.py:304",
            "launches": main["bn254_pairing"], "max_abs_err": err,
            "ms": kb8_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "on_main_path": True}, main


def tower_words(dev, n: int, seed: int, cyclotomic: bool = False):
    """n seeded Fp12 values as the tower probe's (6, 2, 8, n) words; with
    cyclotomic, each taken through the easy part of the final
    exponentiation (plain, on the card)."""
    from fabric_tpu_torch.idemix import bn254 as hb
    from fabric_tpu_torch.ops import bn254 as kb8
    rng = random.Random(seed)
    vals = [tuple((rng.randrange(hb.P), rng.randrange(hb.P))
                  for _ in range(6)) for _ in range(n)]
    f = kb8.f12_from_ints(vals, dev)
    return kb8.f12_to_words(kb8.final_exp_easy(f) if cyclotomic else f)


def tower_probe_phase(torch, trials: int, imad_rate: float,
                      clock_hz: float) -> dict:
    """Phase 9's tower probe: each of KB8's tower routines on
    IDEMIX_CHECKS seeded inputs (cyc_sqr and pow_u on cyclotomic ones)
    bit for bit against its plain version, then timed by CUDA events at
    IDEMIX_CHECKS and at 30 inputs (the idemix block's batch).  -> the
    probe's row of the kernels line (its sums over the ops at
    IDEMIX_CHECKS)."""
    from fabric_tpu_torch.ops import bn254 as kb8
    from fabric_tpu_torch.ops.field import IMADS
    dev = torch.device("cuda")
    n = IDEMIX_CHECKS
    per_mul = IMADS[("bn254", "mul")]
    a_any = tower_words(dev, n, SEED + 20)
    a_cyc = tower_words(dev, n, SEED + 21, cyclotomic=True)
    b_any = tower_words(dev, n, SEED + 22)
    sums = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "by_ops": 0.0}
    err = 0
    for op in kb8.PROBE_OPS:
        a = a_cyc if op in ("cyc_sqr", "pow_u") else a_any
        b = b_any if op in kb8.BINARY_OPS else None
        got = kb8.bn254_tower_probe(op, a, b)
        plain, plain_ms = timed_once(
            torch, lambda: kb8.tower_probe_plain(op, a, b))
        check(torch.equal(got, plain),
              f"tower probe {op} != tower_probe_plain")
        err = max(err, int((got.to(torch.int64) - plain.to(torch.int64))
                           .abs().max()))
        least, issued = kb8.PROBE_FP_OPS[op]
        out = {}
        for m in (n, 30):
            am = a[..., :m].contiguous()
            bm = None if b is None else b[..., :m].contiguous()
            ms = event_ms(torch, lambda: kb8.bn254_tower_probe(op, am, bm),
                          trials)
            ops_s = (m * least * per_mul + (kb8.imads_per_launch()
                                            if op == "final_exp" else 0)
                     ) / imad_rate
            bytes_s = m * 384 * (3 if b is not None else 2) / HBM_BYTES_PER_S
            out[m] = (ms, max(ops_s, bytes_s) * 1e3,
                      "operations" if ops_s >= bytes_s else "bytes")
        phase("idemix", probe_op=op, vs_plain="equal", inputs=n,
              fp_mults_least=least, fp_mults_issued=issued,
              ms=round(out[n][0], 4), ms_30=round(out[30][0], 4),
              bound_ms=round(out[n][1], 6), bound_by=out[n][2],
              plain_ms=round(plain_ms, 2),
              chain_cycles_per_mul=round(out[30][0] * 1e-3 * clock_hz
                                         / issued, 1))
        sums["ms"] += out[n][0]
        sums["plain_ms"] += plain_ms
        sums["bound_ms"] += out[n][1]
        sums["by_ops"] += out[n][1] if out[n][2] == "operations" else 0
    return {"name": "bn254_tower_probe", "route": "cuda",
            "source": "fabric_tpu_torch/ops/csrc/bn254_pairing.cu",
            "replaces": "fabric_tpu/ops/bn254_batch.py:93",
            "launches": 0, "max_abs_err": err, "ms": sums["ms"],
            "plain_ms": sums["plain_ms"], "bound_ms": sums["bound_ms"],
            "bound_by": "operations" if 2 * sums["by_ops"] >= sums[
                "bound_ms"] else "bytes",
            "library_ms": None, "on_main_path": False,
            "ops": list(kb8.PROBE_OPS)}


def msps_ident(msps, creator: bytes):
    from fabric_tpu_torch.msp import deserialize_from_msps
    ident = deserialize_from_msps(msps, creator)
    check(ident is not None, "idemix block: a creator does not deserialize")
    return ident


# ---------------------------------------------------------------------------
# the mesh (phase 10): parallel/mesh.py, placement's providers, the entry,
# warmup and trace capture
# ---------------------------------------------------------------------------

# warmup in a process of its own, with build directories of its own under
# build/ (so that it builds every library), then one block with the
# compilers barred
WARMUP_PROBE = r"""
import json, shutil, sys
from pathlib import Path
from fabric_tpu_torch import native
from fabric_tpu_torch.ops import _build
root = Path(sys.argv[1])
_build.BUILD_DIR = root / "kernels"
native.BUILD_DIR = root / "native"
from fabric_tpu_torch.node import warmup as W
man = W.warmup([64], verbose=False)
from fabric_tpu_torch.bccsp import get_default

def barred(*a, **k):
    raise AssertionError("a build after warmup")

_build._start = barred
native._compile = barred
items = W.gen_p256_sigs(512, 8, seed=3) + W.gen_ed25519_sigs(64, 64, seed=4)
ok = bool(get_default().batch_verify(items).all())
shutil.rmtree(root)
print(json.dumps({"manifest": man, "block_ok": ok, "block_items": len(items)}))
"""


class _Timed:
    """A kernel wrapper's module attribute in its place: sums the seconds
    spent inside it for a LaneTimer.  Its `launches` is the wrapper's own,
    which the wrapper increments through its module's global name."""

    def __init__(self, timer, orig):
        self.timer, self.orig = timer, orig

    @property
    def launches(self):
        return self.orig.launches

    @launches.setter
    def launches(self, n):
        self.orig.launches = n

    def __call__(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return self.orig(*a, **k)
        finally:
            self.timer.lane_s += time.perf_counter() - t0


class LaneTimer:
    """Wraps the four signature wrappers (module attributes, which the
    provider and the mesh look up at each call) to sum the seconds spent
    inside them."""

    NAMES = (("p256_fixed", "p256_verify_rows"), ("p256", "p256_verify"),
             ("ed25519", "ed25519_verify_rows"), ("ed25519", "ed25519_verify"))

    def __init__(self):
        self.lane_s, self.saved = 0.0, []

    def __enter__(self):
        import importlib
        for mod_name, fn_name in self.NAMES:
            mod = importlib.import_module(f"fabric_tpu_torch.ops.{mod_name}")
            orig = getattr(mod, fn_name)
            self.saved.append((mod, fn_name, orig))
            setattr(mod, fn_name, _Timed(self, orig))
        return self

    def __exit__(self, *exc):
        for mod, fn_name, orig in self.saved:
            setattr(mod, fn_name, orig)


# a mesh lane's kernel, by its key in `fns`
LANE_KERNEL = {"p256": "p256_verify", "p256-rows": "p256_verify_rows",
               "ed25519": "ed25519_verify",
               "ed25519-rows": "ed25519_verify_rows",
               "idemix-pair": "bn254_pairing"}


def recorded_sharded(provider):
    """Wrap a mesh provider's sharded lanes to keep each call's (verdicts,
    valid count) -> (that list, the lanes to put back)."""
    calls, saved = [], dict(provider._sharded)
    for lane, fn in saved.items():
        def rec(*a, _fn=fn):
            out = _fn(*a)
            calls.append(out)
            return out
        provider._sharded[lane] = rec
    return calls, saved


def timed_sharded(provider):
    """Wrap a mesh provider's sharded lanes to sum the seconds spent in
    them -> a one-element list holding that sum."""
    spent = [0.0]
    for lane, fn in list(provider._sharded.items()):
        def timed(*a, _fn=fn):
            t0 = time.perf_counter()
            out = _fn(*a)
            spent[0] += time.perf_counter() - t0
            return out
        provider._sharded[lane] = timed
    return spent


def mesh_phase(torch, args, cells, spill, builds, host_tables, fns,
               name_power) -> dict:
    """Phase 10.  cells: {name: (items, labels, kinds, kernels that must
    launch, kernels that may)} of the warm block, config 2 and config 3;
    spill: the spill drill's (items, labels, kinds); builds: the table
    builds a provider makes over the cells, (P-256, Ed25519);
    host_tables: {public key: table} built in phases 4-5, which the
    fresh providers here take in place of building them again (their
    banks still count a build and an upload a key).  Its launches are its
    own: they stay out of the main path's counts.  -> the phase's
    numbers."""
    import numpy as np
    from fabric_tpu_torch import entry as entrymod
    from fabric_tpu_torch.bccsp.cuda import CudaProvider
    from fabric_tpu_torch.ops import bn254 as kb8
    from fabric_tpu_torch.ops import ed25519_tables, p256_tables
    from fabric_tpu_torch.ops_plane import profiling
    from fabric_tpu_torch.parallel import mesh as meshmod
    out, launches_by = {}, {}
    parts_s, t_part = {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts_s[name] = round(now - t_part[0], 2)
        t_part[0] = now

    # warmup, in a fresh process: seconds per library and per lane, then a
    # block that pays no nvcc or cc build
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", WARMUP_PROBE,
                          "build/warmup_probe"], capture_output=True,
                         text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(res.returncode == 0, f"warmup probe failed:\n{res.stdout}\n"
          f"{res.stderr[-4000:]}")
    probe = json.loads(res.stdout.strip().splitlines()[-1])
    man = probe["manifest"]
    check(probe["block_ok"], "the block after warmup rejected a valid item")
    check(all(man["builds_s"][lib] > 0 for lib in man["builds_s"]),
          "warmup: a library was not built in its own build directory")
    phase("mesh", warmup_builds_s={k: round(v, 2) for k, v in
                                   man["builds_s"].items()},
          build_wall_s=round(man["build_wall_s"], 2),
          lanes_s={k: round(v, 4) for k, v in man["lanes_s"].items()},
          block_after_warmup=f"{probe['block_items']} items, all True, "
          "no nvcc or cc build", process_s=round(time.perf_counter() - t0, 2))
    out["warmup"] = man
    part("warmup")

    # the entry and the dry runs
    fn, eargs = entrymod.entry()
    v = fn(*eargs)
    check(v.shape == (128,) and bool(v.all()), "entry(): 128 items all True")
    phase("mesh", entry="128 items, all True")
    for n in (2, 4):
        rec = entrymod.dryrun_multichip(n)
        check(rec["shards"] == n, "dryrun shard count")
        phase("mesh", dryrun_multichip=n, checks="all held", record=rec)
    part("entry_dryruns")

    # three providers on the warm cells, their tables built once a key
    tables = dict(host_tables)

    def cached(build):
        def fn(pk):
            if pk not in tables:
                tables[pk] = build(pk)
            return tables[pk]
        return fn

    meshes = {"plain": None, "mesh-1": meshmod.make_mesh(["cuda:0"]),
              "mesh-2": meshmod.make_mesh(["cuda:0"] * 2)}
    provs = {}
    for label, mesh in meshes.items():
        prov = CudaProvider(mesh=mesh)
        prov.key_tables.build_fn = cached(p256_tables.table_for_pubkey)
        prov.ed_key_tables.build_fn = cached(ed25519_tables.table_for_pubkey)
        provs[label] = prov
    verdicts = {}
    for label, prov in provs.items():
        if prov.mesh is not None:
            lane_calls, saved = recorded_sharded(prov)
        for cell, (items, labels, kinds, on, maybe) in cells.items():
            for fn_ in fns.values():
                fn_.launches = 0
            if prov.mesh is not None:
                for lane_fn in saved.values():
                    lane_fn.shard_launches[:] = [0] * len(prov.mesh)
            got = prov.batch_verify(items)
            launches = {k: f.launches for k, f in fns.items()}
            launches_by[label, cell] = {k: n for k, n in launches.items()
                                        if n}
            check_verdicts(f"mesh {label} {cell}", got, np.asarray(labels),
                           kinds)
            verdicts[label, cell] = got
            if label != "plain":
                check(np.array_equal(got, verdicts["plain", cell]),
                      f"mesh {label} {cell}: verdicts != the plain provider's")
            check(prov.stats["fallbacks"] == 0, f"mesh {label}: fallbacks")
            if prov.mesh is not None:
                check(lane_calls and all(int(c) == int(v.sum())
                                         for v, c in lane_calls),
                      f"mesh {label} {cell}: a valid count != its verdicts")
                lane_calls.clear()
            check_launches(f"mesh {label} {cell}", launches, on, maybe)
            # per shard: what each wrapper's own count gained across the
            # shard's calls (mesh.py); the plain provider is one shard
            shards = ({LANE_KERNEL[lane]: list(f.shard_launches)
                       for lane, f in saved.items() if any(f.shard_launches)}
                      if prov.mesh is not None else
                      {k: [n] for k, n in launches_by[label, cell].items()})
            check({k: sum(v) for k, v in shards.items()}
                  == launches_by[label, cell],
                  f"mesh {label} {cell}: launches a shard {shards} do not "
                  f"add up to the run's {launches_by[label, cell]}")
            phase("mesh", provider=label, cell=cell,
                  launches=launches_by[label, cell],
                  launches_per_shard=shards, verdicts_vs_labels="equal")
        if prov.mesh is not None:
            prov._sharded.update(saved)
        check((prov.key_tables.stats["builds"],
               prov.ed_key_tables.stats["builds"]) == builds,
              f"mesh {label}: table builds != one a key {builds}")
    for label, prov in provs.items():
        for bank in ("key_tables", "ed_key_tables"):
            st, st0 = getattr(prov, bank).stats, getattr(provs["plain"],
                                                         bank).stats
            check(st == st0, f"mesh {label}: {bank} stats {st} != {st0}")
            check(len(getattr(prov, bank).replicas()) == 1,
                  f"mesh {label}: {bank} holds more than one replica")
        check(prov.stats == provs["plain"].stats,
              f"mesh {label}: stats != the plain provider's")
    plain_p = provs["plain"]
    phase("mesh", table_builds=builds,
          table_h2d_bytes=(plain_p.key_tables.stats["h2d_bytes"],
                           plain_p.ed_key_tables.stats["h2d_bytes"]),
          replicas=1, stats_vs_plain="equal",
          valid_counts_vs_verdicts="equal")
    part("providers")

    # times: medians of args.trials warm runs a provider, in two turns
    # (plain, mesh-1, mesh-2, mesh-2, mesh-1, plain), and the mesh code's
    # own host time (the sharded calls less the wrappers inside them)
    spent = {label: timed_sharded(p) for label, p in provs.items()
             if p.mesh is not None}
    order = ("plain", "mesh-1", "mesh-2", "mesh-2", "mesh-1", "plain")
    per_turn = -(-args.trials // 2)
    times = {(label, cell): [] for label in provs for cell in cells}
    own = {(label, cell): [] for label in spent for cell in cells}
    for label in order:
        prov = provs[label]
        for cell, (items, *_rest) in cells.items():
            for _ in range(per_turn):
                with LaneTimer() as sc:
                    if label in spent:
                        spent[label][0] = 0.0
                    t0 = time.perf_counter()
                    prov.batch_verify(items)
                    times[label, cell].append((time.perf_counter() - t0)
                                              * 1e3)
                if label in spent:
                    own[label, cell].append((spent[label][0] - sc.lane_s)
                                            * 1e3)
    print(name_power, flush=True)
    for cell in cells:
        row = {}
        for label in provs:
            t = times[label, cell]
            row[label] = {"median_ms": statistics.median(t),
                          "turns_ms": [statistics.median(t[:per_turn]),
                                       statistics.median(t[per_turn:])]}
            if label in spent:
                row[label]["mesh_host_ms"] = statistics.median(
                    own[label, cell])
        phase("mesh", times=cell, warm_runs=2 * per_turn, **row)
        out[cell] = row
    part("times")

    # the spill drill through the 2-shard mesh
    s_items, s_labels, s_kinds = spill
    drill = CudaProvider(max_cached_keys=2, mesh=meshmod.make_mesh(
        ["cuda:0"] * 2))
    plain_drill = CudaProvider(max_cached_keys=2)
    got, want_ = drill.batch_verify(s_items), plain_drill.batch_verify(
        s_items)
    check(np.array_equal(got, want_), "mesh spill drill != the plain drill")
    check_verdicts("mesh spill drill", got, np.asarray(s_labels), s_kinds)
    check(drill.key_tables.stats == plain_drill.key_tables.stats
          and drill.key_tables.stats["pinned_spills"] > 0,
          f"mesh spill drill: bank stats {drill.key_tables.stats}")
    phase("mesh", spill_items=len(s_items), bank_stats=drill.key_tables.stats,
          verdicts_vs_plain_and_labels="equal")
    part("spill")

    # KB8 over two shards on phase 9's seeded checks
    load = seeded_checks(IDEMIX_CHECKS, SEED + 11)
    args9 = kb8_args(torch, torch.device("cuda"), load)
    plain = kb8.bn254_pairing_check(*args9)
    sharded_kb8 = meshmod.sharded_idemix_pair_verify(
        meshmod.make_mesh(["cuda:0"] * 2))
    got, count = sharded_kb8(*args9)
    check(sharded_kb8.shard_launches == [1, 1],
          f"sharded KB8: launches a shard {sharded_kb8.shard_launches}")
    check(torch.equal(got, plain), "sharded KB8 != KB8")
    check(got.cpu().tolist() == load["labels"], "sharded KB8 != labels")
    check(int(count) == sum(load["labels"]), "sharded KB8 count")
    phase("mesh", kb8_shards=2, checks=len(load["labels"]),
          vs_unsharded_and_labels="equal", valid=int(count),
          launches_per_shard={"bn254_pairing": sharded_kb8.shard_launches})
    part("kb8")

    # a device trace around two warm blocks
    prov = provs["plain"]
    items = cells["block"][0]
    trace = profiling.capture_device_trace(
        0.05, "chiprun_out/mesh_trace",
        work=lambda: [prov.batch_verify(items) for _ in range(2)])
    check("error" not in trace, f"trace: {trace}")
    names = trace["kernels"]
    for k in ("p256_verify_rows_kernel", "p256_verify_kernel",
              "ed25519_verify_kernel"):
        check(any(k in nm for nm in names), f"trace: no {k} event")
    phase("mesh", trace=trace["trace"], device_events=trace["device_events"],
          kernels=[nm[:40] for nm in names][:12])
    part("trace")
    phase("mesh", seconds=parts_s)
    out["seconds"] = parts_s
    out["unverified"] = ("cudaStreamWaitEvent across devices and a "
                         "library's static cudart on a device other than 0: "
                         "one card here")
    return out


# ---------------------------------------------------------------------------
# KP2's field probe (phase 3) and KP2's work (phase 7)
# ---------------------------------------------------------------------------

def field_probe_phase(torch, dev, trials: int, imad_rate: float) -> dict:
    """Phase 3's field probe: each routine of field_ptx.cuh (KP2's mul_p,
    sqr_p, mont_mul_ptx mod n and KE5's and KE6's mul_25519, through
    `p256_field_probe`) on PROBE_LANES inputs,
    the edge values of `field_probe_edges` first and seeded ones after,
    bit for bit against the plain field (`field_probe_plain`) and Python
    ints, then timed by CUDA events.  -> the probe's row of the kernels
    line (its sums over the ops)."""
    from fabric_tpu_torch.ops import p256
    from fabric_tpu_torch.ops.field import (IMADS, ints_to_words_le,
                                            words_le_to_ints)
    rng = random.Random(SEED + 30)
    R = 1 << 256
    sums = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "by_ops": 0.0}
    err = 0
    for op in p256.FIELD_PROBE_OPS:
        m = p256.field_probe_modulus(op)
        ea, eb = p256.field_probe_edges(op)
        k = PROBE_LANES - len(ea)
        va = ea + [rng.randrange(m if op == "sqr_p" else R) for _ in range(k)]
        vb = va if op == "sqr_p" else eb + [rng.randrange(m)
                                           for _ in range(k)]
        a = ints_to_words_le(va, dev)
        b = None if op == "sqr_p" else ints_to_words_le(vb, dev)
        got = p256.p256_field_probe(op, a, b)
        plain, plain_ms = timed_once(
            torch, lambda: p256.field_probe_plain(op, a, b))
        check(torch.equal(got, plain), f"field probe {op} != "
              "field_probe_plain")
        rinv = pow(R, -1, m)
        check(words_le_to_ints(got) == [x * y * rinv % m
                                        for x, y in zip(va, vb)],
              f"field probe {op} != python ints")
        err = max(err, int((got.to(torch.int64) - plain.to(torch.int64))
                           .abs().max()))
        ms = event_ms(torch, lambda: p256.p256_field_probe(op, a, b), trials)
        key = {"mul_n": ("n", "mul"), "sqr_p": ("p", "sqr"),
               "mul_25519": ("p25519", "mul")}.get(op, ("p", "mul"))
        ops_s = PROBE_LANES * IMADS[key] / imad_rate
        bytes_s = PROBE_LANES * 32 * (2 if b is None else 3) / HBM_BYTES_PER_S
        bound = max(ops_s, bytes_s) * 1e3
        phase("field", probe_op=op, inputs=PROBE_LANES, edges=len(ea),
              vs_plain="equal", vs_ints="equal", ms=round(ms, 4),
              ns_per_op=round(ms * 1e6 / PROBE_LANES, 4),
              plain_ms=round(plain_ms, 2), bound_ms=round(bound, 6),
              bound_by="operations" if ops_s >= bytes_s else "bytes")
        sums["ms"] += ms
        sums["plain_ms"] += plain_ms
        sums["bound_ms"] += bound
        sums["by_ops"] += bound if ops_s >= bytes_s else 0
    return {"name": "p256_field_probe", "route": "cuda",
            "source": "fabric_tpu_torch/ops/csrc/p256_verify.cu",
            "replaces": "fabric_tpu/ops/flatfield.py:231",
            "launches": 0, "max_abs_err": err, "ms": sums["ms"],
            "plain_ms": sums["plain_ms"], "bound_ms": sums["bound_ms"],
            "bound_by": "operations" if 2 * sums["by_ops"] >= sums[
                "bound_ms"] else "bytes",
            "library_ms": None, "on_main_path": False,
            "ops": list(p256.FIELD_PROBE_OPS)}


def kp2_work(arrays) -> tuple:
    """KP2's work on a batch of (8, B) word arrays (qx, qy, r, s, e) ->
    (least multiplies, least multiply-adds, issued multiplies): the least
    counts s^-1 as batched (one chain a launch), the issued the kernel's
    own per-thread Fermat chain."""
    import numpy as np
    import torch
    from fabric_tpu_torch.ops import field, p256
    n = p256.N
    rs = [field.limbs_to_ints(field.words_be_to_limbs(
        torch.from_numpy(np.ascontiguousarray(a)))) for a in arrays[2:]]
    muls = sum(p256.INV_N_CHAIN.values())
    imads = p256.imads_per_launch()
    issued = 0
    for r_, s_, e_ in zip(*rs):
        w = pow(s_ % n, n - 2, n)
        u1, u2 = e_ * w % n, r_ * w % n
        muls += sum(p256.field_ops_per_verify(u1, u2).values())
        imads += p256.imads_per_verify(u1, u2)
        issued += p256.field_ops_issued(u1, u2)
    return muls, imads, issued


# ---------------------------------------------------------------------------
# the experiments' counterparts (phase 3b)
# ---------------------------------------------------------------------------

def _fmt(v):
    return round(v, 4) if isinstance(v, float) else v


def experiments_phase(torch, dev, trials: int, sms: int) -> dict:
    """Each experiments module's run() at the reference's B and at a
    card-filling B; every check raises inside run().  -> {(module, B):
    result}."""
    from fabric_tpu_torch import experiments as X
    from fabric_tpu_torch.experiments import (proto_ilp, proto_pallas,
                                              proto_pallas2, proto_pallas3,
                                              proto_pallas4, proto_planes)
    out = {}
    for B in (X.REF_B, sms * FILL_THREADS_PER_SM):
        for mod in (proto_pallas, proto_pallas2, proto_pallas4, proto_planes,
                    proto_ilp, proto_pallas3):
            t0 = time.perf_counter()
            res = mod.run(device=dev, trials=trials, B=B)
            name = mod.__name__.rsplit(".", 1)[1]
            out[name, B] = res
            for row in res.get("configs", res.get("probes", [])):
                phase("experiments", script=name, **{
                    k: _fmt(v) for k, v in row.items() if k != "replaces"})
            phase("experiments", script=name, B=B,
                  seconds=round(time.perf_counter() - t0, 2))
    return out


def experiment_rows(results: dict, total: dict, kp1_err: int) -> list:
    """The kernels line's rows of KP1 (at the reference's shape), KF2's
    five presets and KI3's two sites, from the B = 16,384 runs: each
    preset's row is its 128-thread configuration (ilp: K = 4).  run()
    raised on any difference, so the errors are 0; KP1's is phase 3's
    largest, over every modulus and both R."""
    from fabric_tpu_torch import experiments as X
    from fabric_tpu_torch.ops import field_variants as FV

    def row(name, source, replaces, launches, r, err=0):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None, "on_main_path": False}

    def config(script, preset, k=None):
        for r in results[script, X.REF_B]["configs"]:
            if (r["preset"] == preset and r["threads"] == 128
                    and (k is None or r["k"] == k)):
                return r
        raise KeyError((script, preset, k))

    rows = [row("field_mul_chain", "fabric_tpu_torch/ops/csrc/field_chain.cu",
                "experiments/proto_pallas.py:94", total["field_mul_chain"],
                config("proto_pallas", "kp1"), kp1_err)]
    kf2 = "fabric_tpu_torch/ops/csrc/field_chain_variants.cu"
    for script, preset, k in (("proto_pallas2", "relaxed", None),
                              ("proto_pallas2", "stacked", None),
                              ("proto_pallas4", "min", None),
                              ("proto_planes", "planes", None),
                              ("proto_ilp", "ilp", 4)):
        rows.append(row(f"field_chain_variant:{preset}", kf2,
                        FV.PRESETS[preset][0], total["field_chain_variant"],
                        config(script, preset, k)))
    probes = results["proto_pallas3", X.REF_B]["probes"]
    for site, group in (("int32", [r for r in probes if r["probe"] != "f32"]),
                        ("f32", [r for r in probes if r["probe"] == "f32"])):
        bound = sum(r["bound_ms"] for r in group)
        by_ops = sum(r["bound_ms"] for r in group
                     if r["bound_by"] == "operations")
        rows.append({
            "name": f"isa_probe:{site}", "route": "cuda",
            "source": "fabric_tpu_torch/ops/csrc/isa_probe.cu",
            "replaces": group[0]["replaces"], "launches": total["isa_probe"],
            "max_abs_err": 0, "ms": sum(r["ms"] for r in group),
            "plain_ms": sum(r["plain_ms"] for r in group),
            "bound_ms": bound,
            "bound_by": "operations" if 2 * by_ops >= bound else "bytes",
            "library_ms": None, "on_main_path": False,
            "probes": [r["probe"] for r in group]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--txs", type=int, default=10_000,
                    help="transactions in the block (4 signatures each)")
    ap.add_argument("--ed", type=int, default=10_000,
                    help="Ed25519 signatures of BASELINE config 2")
    ap.add_argument("--gen", type=int, default=4096,
                    help="Ed25519 items of the generic load")
    ap.add_argument("--trials", type=int, default=3,
                    help="timed repetitions per measurement")
    ap.add_argument("--commit-txs", type=int, default=10_000,
                    help="transactions in blocks 0-2 of the commit stream")
    ap.add_argument("--commit-last", type=int, default=1_000,
                    help="transactions in block 3 of the commit stream")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import numpy as np
    import torch

    # --- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from fabric_tpu_torch import native
    from fabric_tpu_torch.bccsp import FactoryOpts, init_factories
    from fabric_tpu_torch.bccsp import cuda as cudaprov
    from fabric_tpu_torch.ops import (_build, bn254, ed25519,
                                      ed25519_tables, field, field_variants,
                                      isa_probe, p256, p256_fixed,
                                      p256_tables)

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    name_power = smi("name,power.limit")
    max_clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    imad_rate = IMAD_PER_SM_PER_CLOCK * sms * max_clock_mhz * 1e6
    phase("device", name=repr(name), count=torch.cuda.device_count(),
          sms=sms, max_sm_mhz=max_clock_mhz, torch=torch.__version__,
          cuda=torch.version.cuda)
    print(name_power, flush=True)

    # --- 2. build ----------------------------------------------------------
    built = _build.build_all(force=True)
    for lib, info in built.items():
        phase("build", lib=lib, seconds=round(info["seconds"], 2))
        for line in info["log"].splitlines():
            if line.strip():
                print("   ", line.strip(), flush=True)
    t0 = time.perf_counter()
    log = native.build("der")
    phase("build", lib="der (cc)", seconds=round(time.perf_counter() - t0, 2),
          log=log.strip() or "clean")
    for ext in native.EXTENSIONS:
        t0 = time.perf_counter()
        log = native.build_extension(ext)
        phase("build", lib=f"_{ext} (cc, CPython extension)",
              seconds=round(time.perf_counter() - t0, 2),
              log=log.strip() or "clean")
        native.extension(ext)

    # --- 3. field ----------------------------------------------------------
    rng = random.Random(SEED + 1)
    R = 1 << 256
    field_err = 0
    for mod, f in field.MODS.items():
        m = f.m
        edge = [0, 1, 2, m - 2, m - 1, m, m + 1, R - 1, (1 << 252) - 1,
                (1 << 252), 0xFFF, int("FFF" * 21, 16), field.P, field.N]
        vals_a = edge + [rng.randrange(R) for _ in range(FIELD_LANES
                                                          - len(edge))]
        vals_b = list(reversed(edge)) + [rng.randrange(R) for _ in range(
            FIELD_LANES - len(edge))]
        a = field.ints_to_words_le(vals_a, dev)
        b = field.ints_to_words_le(vals_b, dev)
        for r_log2 in field.R_LOG2S:
            rinv = pow(1 << r_log2, -1, m)
            for k in (0, 1, 8):
                got = field.field_mul_chain(a, b, k, mod, r_log2)
                plain = field.mul_chain_plain(a, b, k, mod, r_log2)
                torch.cuda.synchronize()
                got_i = field.words_le_to_ints(got)
                want = [x * pow(y * rinv, k, m) % m
                        for x, y in zip(vals_a, vals_b)]
                what = f"KP1 mod {mod} k={k} r_log2={r_log2}"
                check(got_i == want, f"{what} != python ints")
                check(torch.equal(got, plain), f"{what} != mul_chain_plain")
                field_err = max(field_err, max(
                    abs(g - p) for g, p in zip(
                        got_i, field.words_le_to_ints(plain))))
        phase("field", modulus=mod, lanes=FIELD_LANES, k="0,1,8",
              r_log2=field.R_LOG2S, vs_ints="equal", vs_plain="equal")
    field_probe_row = field_probe_phase(torch, dev, args.trials, imad_rate)

    # --- 3b. experiments ----------------------------------------------------
    t0 = time.perf_counter()
    exp_results = experiments_phase(torch, dev, args.trials, sms)
    phase("experiments", seconds=round(time.perf_counter() - t0, 2))

    # --- 4. block ----------------------------------------------------------
    t0 = time.perf_counter()
    id_configs, id_signers, id_forged = idemix_world()
    idemix_gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, multiprocessing.cpu_count())) as pool:
        items, labels, kinds = build_block(args.txs, pool)
        block_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        c2_items, c2_labels, c2_kinds = build_ed25519(
            args.ed, ED_KEYS, ED_CFG2_KINDS, SEED + 3, pool)
        g_items, g_labels, g_kinds = build_ed25519(
            args.gen, 0, ED_GEN_KINDS, SEED + 4, pool)
        ed_build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        orgs, signers, endorsers, clients = commit_identities()
        env_blocks, commit_labels, commit_kinds = build_stream(
            args.commit_txs, args.commit_last, signers, endorsers, clients,
            pool)
        commit_raws = chain_blocks(env_blocks)
        del env_blocks
        stream_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        idemix_raw, idemix_labels = build_idemix_block(
            id_signers, id_forged, signers[0], pool)
        idemix_sign_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sbe = build_sbe_stream(signers, endorsers, clients, pool)
        sbe_s = time.perf_counter() - t0
    n_p256 = 4 * args.txs
    fast_idx, well_formed, hot_keys = fast_lane_items(
        items, kinds, n_p256, p256_tables.on_curve)
    phase("block", items=len(items), p256=n_p256, ed25519=N_ED25519,
          corrupted=sum(k is not None for k in kinds),
          well_formed=well_formed, hot_keys=hot_keys,
          fast_lane_items=len(fast_idx), build_s=round(block_s, 2))
    want = np.asarray(labels)
    fns = {"p256_verify_rows": p256_fixed.p256_verify_rows,
           "p256_verify": p256.p256_verify,
           "ed25519_verify_rows": ed25519.ed25519_verify_rows,
           "ed25519_verify": ed25519.ed25519_verify,
           "bn254_pairing": bn254.bn254_pairing_check,
           "bn254_tower_probe": bn254.bn254_tower_probe,
           "p256_field_probe": p256.p256_field_probe,
           "field_mul_chain": field.field_mul_chain,
           "field_chain_variant": field_variants.field_chain_variant,
           "isa_probe": isa_probe.isa_probe}
    total = {}

    # the main path: the factory builds the provider, then the block goes
    # through it cold (the bank builds every hot key's table) and warm
    t0 = time.perf_counter()
    provider = init_factories(FactoryOpts(default="CUDA"))
    init_s = time.perf_counter() - t0
    check(provider.name == "cuda", "factory did not give the CUDA provider")
    bank = provider.key_tables
    build_fn = bank.build_fn
    build_s = []
    host_tables = {}            # the tables built here, for phase 10

    def timed_build(pk):
        t = time.perf_counter()
        tab = build_fn(pk)
        build_s.append(time.perf_counter() - t)
        host_tables[pk] = tab
        return tab

    bank.build_fn = timed_build
    for run in ("cold", "warm"):
        builds0 = bank.stats["builds"]
        verdicts, secs, launches, delta = drive(provider, items, fns, total)
        phase("block", run=run,
              main_path_s=round(secs + (init_s if run == "cold" else 0), 4),
              launches=launches, stats=delta,
              table_builds=bank.stats["builds"] - builds0,
              table_build_s=round(sum(build_s), 3),
              bank_bytes=bank.array().nbytes,
              table_h2d_bytes=bank.stats["h2d_bytes"])
        check_verdicts(f"block {run}", verdicts, want, kinds)
        check(delta["device_sigs"] == well_formed + N_ED25519,
              f"{run}: device_sigs {delta['device_sigs']} != "
              f"{well_formed + N_ED25519}")
        check(delta["fast_key_sigs"] == len(fast_idx),
              f"{run}: fast_key_sigs {delta['fast_key_sigs']} != "
              f"{len(fast_idx)}")
        check(delta["fallbacks"] == 0, f"{run}: fallbacks != 0")
        check(bank.stats["builds"] - builds0
              == (hot_keys if run == "cold" else 0),
              f"{run}: {bank.stats['builds'] - builds0} table builds")
        check_launches(f"block {run}", launches,
                       ("p256_verify_rows", "p256_verify", "ed25519_verify"))
        phase("block", run=run, verdicts_vs_labels="equal",
              valid=int(want.sum()), device_sigs=well_formed + N_ED25519,
              fast_key_sigs=len(fast_idx), fallbacks=0)
    bank.build_fn = build_fn
    table_build_s = sum(build_s)
    phase("block", sw_subset=sw_subset("block", items, verdicts, kinds,
                                       SEED + 2), vs_sw="equal")

    # KP3 against its plain version on a slice of the block's own KP3
    # batch that holds every corrupted kind reaching it
    table = p256_tables.g_table(dev)
    batch = provider.pass_p256(items, range(n_p256))
    bank.unpin(batch.pinned)
    f_keep, f_arrays, f_slot = batch.fast
    check(batch.generic is not None, "host pass: no KP2 batch")
    kp2_keep, kp2_arrays = batch.generic
    check(sorted(f_keep.tolist()) == fast_idx, "host pass: KP3 batch")
    f_bad = [j for j, i in enumerate(f_keep) if kinds[i] is not None]
    f_fill = [j for j, i in enumerate(f_keep) if kinds[i] is None]
    f_sl = np.asarray(sorted(f_bad + f_fill[:max(0, SLICE - len(f_bad))]))
    check({kinds[f_keep[j]] for j in f_bad}
          == {"wrong_digest", "high_s", "s_eq_n"},
          "KP3 batch: corrupted kinds")
    bank_t = bank.array()
    sl_words = [torch.from_numpy(np.ascontiguousarray(a[:, f_sl])).to(dev)
                for a in f_arrays]
    sl_slot = torch.from_numpy(f_slot[f_sl])
    kern = p256_fixed.p256_verify_rows(*sl_words, sl_slot, bank_t, table)
    plain = p256_fixed.verify_words_rows_plain(*sl_words, sl_slot, bank_t,
                                               table)
    torch.cuda.synchronize()
    check(torch.equal(kern, plain), "KP3 != verify_words_rows_plain")
    check((kern.cpu().numpy() == want[f_keep[f_sl]]).all(),
          "KP3 slice != labels")
    kp3_err = int((kern.to(torch.int8) - plain.to(torch.int8)).abs().max())
    phase("block", kp3_slice=len(f_sl), corrupted_in_slice=len(f_bad),
          kp3_vs_plain="equal")

    bad_dev = [i for i in range(n_p256)
               if kinds[i] is not None and kinds[i] not in ("bad_der",
                                                            "short_point")]
    fill = [i for i in range(n_p256) if kinds[i] is None]
    slice_idx = sorted(bad_dev + fill[:max(0, SLICE - len(bad_dev))])
    words = [torch.from_numpy(w).to(dev)
             for w in item_words(items, slice_idx)]
    kern = p256.p256_verify(*words, table)
    plain = p256.verify_words_plain(*words, table)
    torch.cuda.synchronize()
    check(torch.equal(kern, plain), "KP2 != verify_words_plain")
    check((kern.cpu().numpy() == want[slice_idx]).all(),
          "KP2 slice != labels")
    kp2_err = int((kern.to(torch.int8) - plain.to(torch.int8)).abs().max())
    phase("block", slice=len(slice_idx), corrupted_in_slice=len(bad_dev),
          kp2_vs_plain="equal")

    # spill drill: two slots for the three org keys of a smaller block of
    # the same form; the third key's signatures spill to KP2
    n_spill = 4 * min(SPILL_TXS, args.txs)
    drill = cudaprov.CudaProvider(max_cached_keys=2)
    got = drill.batch_verify(items[:n_spill])
    st = drill.key_tables.stats
    check((got == want[:n_spill]).all(), "spill drill: verdicts != labels")
    check(st["pinned_spills"] > 0, "spill drill: no pinned spill")
    check(drill.stats["fallbacks"] == 0, "spill drill: fallbacks != 0")
    phase("block", spill_items=n_spill, bank_stats=st,
          fast_key_sigs=drill.stats["fast_key_sigs"],
          device_sigs=drill.stats["device_sigs"], verdicts_vs_labels="equal")
    del drill

    # --- 5. ed25519 ----------------------------------------------------------
    # BASELINE config 2, cold then warm, through the block's provider
    ebank = provider.ed_key_tables
    c2_want = np.asarray(c2_labels)
    c2_rejected = sum(k == "ed_bad_length" for k in c2_kinds)
    c2_sigs = args.ed - c2_rejected
    phase("ed25519", config2_items=args.ed, keys=ED_KEYS,
          corrupted=sum(k is not None for k in c2_kinds),
          host_rejected=c2_rejected, generic_load_items=args.gen,
          generic_corrupted=sum(k is not None for k in g_kinds),
          sign_s=round(ed_build_s, 2))
    eb_fn = ebank.build_fn
    ed_build_s = []

    def timed_ed_build(pk):
        t = time.perf_counter()
        tab = eb_fn(pk)
        ed_build_s.append(time.perf_counter() - t)
        host_tables[pk] = tab
        return tab

    ebank.build_fn = timed_ed_build
    c2_ms = {}
    for run in ("cold", "warm"):
        builds0 = ebank.stats["builds"]
        verdicts, secs, launches, delta = drive(provider, c2_items, fns,
                                                total)
        c2_ms[run] = secs * 1e3
        phase("ed25519", config2=run, main_path_s=round(secs, 4),
              launches=launches, stats=delta,
              table_builds=ebank.stats["builds"] - builds0,
              table_build_s=round(sum(ed_build_s), 4),
              table_h2d_bytes=ebank.stats["h2d_bytes"])
        check_verdicts(f"config 2 {run}", verdicts, c2_want, c2_kinds)
        check(delta["device_sigs"] == c2_sigs == delta["fast_key_sigs"],
              f"config 2 {run}: device/fast sigs {delta}")
        check(delta["host_rejects"] == c2_rejected,
              f"config 2 {run}: host_rejects {delta['host_rejects']}")
        check(delta["fallbacks"] == 0, f"config 2 {run}: fallbacks != 0")
        check(ebank.stats["builds"] - builds0
              == (ED_KEYS if run == "cold" else 0),
              f"config 2 {run}: {ebank.stats['builds'] - builds0} builds")
        check_launches(f"config 2 {run}", launches, ("ed25519_verify_rows",))
        phase("ed25519", config2=run, verdicts_vs_labels="equal",
              valid=int(c2_want.sum()), fallbacks=0)
    ebank.build_fn = eb_fn
    ed_table_build_s = sum(ed_build_s)
    phase("ed25519", config2_sw_subset=sw_subset(
        "config 2", c2_items, verdicts, c2_kinds, SEED + 5), vs_sw="equal")

    # BASELINE config 3: the first 2 x txs endorsements and config 2's
    # items as one batch, through the warm provider
    endorse = [i for i in range(n_p256) if i % 4 != N_ORGS][:2 * args.txs]
    c3_items = [items[i] for i in endorse] + c2_items
    c3_kinds = [kinds[i] for i in endorse] + c2_kinds
    c3_want = np.concatenate([want[endorse], c2_want])
    verdicts, secs, launches, delta = drive(provider, c3_items, fns, total)
    phase("ed25519", config3_items=len(c3_items), main_path_s=round(secs, 4),
          launches=launches, stats=delta)
    check_verdicts("config 3", verdicts, c3_want, c3_kinds)
    check(delta["fallbacks"] == 0, "config 3: fallbacks != 0")
    check_launches("config 3", launches,
                   ("p256_verify_rows", "ed25519_verify_rows"),
                   maybe=("p256_verify",))
    phase("ed25519", config3_verdicts_vs_labels="equal",
          sw_subset=sw_subset("config 3", c3_items, verdicts, c3_kinds,
                              SEED + 6))

    # the generic load: keys of their own, one KE5 launch
    g_want = np.asarray(g_labels)
    verdicts, secs, launches, delta = drive(provider, g_items, fns, total)
    phase("ed25519", generic_items=len(g_items), main_path_s=round(secs, 4),
          launches=launches, stats=delta)
    check_verdicts("generic load", verdicts, g_want, g_kinds)
    check(delta["device_sigs"] == len(g_items) - delta["fast_key_sigs"]
          and delta["fast_key_sigs"] == 0, f"generic load: {delta}")
    check(delta["fallbacks"] == 0, "generic load: fallbacks != 0")
    check_launches("generic load", launches, ("ed25519_verify",))
    phase("ed25519", generic_verdicts_vs_labels="equal",
          sw_subset=sw_subset("generic load", g_items, verdicts, g_kinds,
                              SEED + 7))

    # KE6 and KE5 against their plain versions on their whole batches:
    # config 2's KE6 batch and the generic load's KE5 batch, which hold
    # every corrupted kind that reaches each kernel
    btab = ed25519_tables.b_table(dev)
    ebank_t = ebank.array()
    c2_pass = provider.pass_ed25519(c2_items, range(args.ed))
    ebank.unpin(c2_pass.pinned)
    e6_keep, e6_arrays, e6_slot = c2_pass.fast
    e6_words = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in e6_arrays]
    e6_slot_t = torch.from_numpy(e6_slot)
    kern = ed25519.ed25519_verify_rows(*e6_words, e6_slot_t, ebank_t, btab)
    plain, ke6_plain_ms = timed_once(torch, lambda: (
        ed25519.verify_words_rows_plain(*e6_words, e6_slot_t, ebank_t,
                                        btab)))
    check(torch.equal(kern, plain), "KE6 != verify_words_rows_plain")
    check((kern.cpu().numpy() == c2_want[e6_keep]).all(), "KE6 != labels")
    ke6_err = int((kern.to(torch.int8) - plain.to(torch.int8)).abs().max())
    phase("ed25519", ke6_batch=len(e6_keep), corrupted=len(
        [i for i in e6_keep if c2_kinds[i] is not None]),
        ke6_vs_plain="equal")
    # config 3's KE6 batch: its Ed25519 items in the provider's order
    n3 = len(c3_items) - len(c2_items)
    c3_pass = provider.pass_ed25519(c3_items, range(n3, len(c3_items)))
    ebank.unpin(c3_pass.pinned)
    e3_keep, e3_arrays, e3_slot = c3_pass.fast
    e3_words = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in e3_arrays]
    e3_slot_t = torch.from_numpy(e3_slot)
    kern = ed25519.ed25519_verify_rows(*e3_words, e3_slot_t, ebank_t, btab)
    check(torch.equal(kern, ed25519.verify_words_rows_plain(
        *e3_words, e3_slot_t, ebank_t, btab)),
        "KE6 != verify_words_rows_plain on config 3's batch")
    check((kern.cpu().numpy() == c3_want[e3_keep]).all(),
          "KE6 on config 3's batch != labels")
    phase("ed25519", ke6_config3_batch=len(e3_keep),
          ke6_vs_plain_and_labels="equal")

    g_pass = provider.pass_ed25519(g_items, range(args.gen))
    provider.ed_key_tables.unpin(g_pass.pinned)
    check(g_pass.fast is None, "generic load: a key got a table")
    e5_keep, e5_arrays = g_pass.generic
    e5_words = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in e5_arrays]
    kern = ed25519.ed25519_verify(*e5_words, btab)
    plain, ke5_plain_ms = timed_once(torch, lambda: (
        ed25519.verify_words_plain(*e5_words, btab)))
    check(torch.equal(kern, plain), "KE5 != verify_words_plain")
    check((kern.cpu().numpy() == g_want[e5_keep]).all(), "KE5 != labels")
    ke5_err = int((kern.to(torch.int8) - plain.to(torch.int8)).abs().max())
    phase("ed25519", ke5_batch=len(e5_keep), corrupted=len(
        [i for i in e5_keep if g_kinds[i] is not None]),
        ke5_vs_plain="equal")

    # --- 6. commit ---------------------------------------------------------
    phase("commit", blocks=len(commit_raws),
          txs=[len(lab) for lab in commit_labels], kinds=commit_kinds,
          block_bytes=[len(r) for r in commit_raws],
          build_s=round(stream_s, 2), policy=COMMIT_POLICY,
          window=COMMIT_WINDOW)
    kv7_row, commit_launches, mem_rows = commit_phase(
        torch, args, provider, orgs, commit_raws, commit_labels, fns,
        max_clock_mhz * 1e6)
    for kname, n in commit_launches.items():
        total[kname] = total.get(kname, 0) + n

    # --- 7. times ----------------------------------------------------------
    t = args.trials
    e2e_ms = median_ms(lambda: provider.batch_verify(items), t)
    p256_items = items[:n_p256]
    p256_ms = median_ms(lambda: provider.batch_verify(p256_items), t)

    def host_pass():
        bank.unpin(provider.pass_p256(p256_items, range(n_p256)).pinned)

    host_ms = median_ms(host_pass, t)
    c2_e2e_ms = median_ms(lambda: provider.batch_verify(c2_items), t)
    c3_e2e_ms = median_ms(lambda: provider.batch_verify(c3_items), t)
    g_e2e_ms = median_ms(lambda: provider.batch_verify(g_items), t)

    def ed_host_pass():
        ebank.unpin(provider.pass_ed25519(c2_items, range(args.ed)).pinned)

    ed_host_ms = median_ms(ed_host_pass, t)

    # KP3 on the block's own KP3 batch
    f_words = [torch.from_numpy(a).to(dev) for a in f_arrays]
    f_slot_t = torch.from_numpy(f_slot)
    kp3_ms = event_ms(torch, lambda: p256_fixed.p256_verify_rows(
        *f_words, f_slot_t, bank_t, table), t)
    kern = p256_fixed.p256_verify_rows(*f_words, f_slot_t, bank_t, table)
    plain, kp3_plain_ms = timed_once(torch, lambda: (
        p256_fixed.verify_words_rows_plain(*f_words, f_slot_t, bank_t,
                                           table)))
    check(torch.equal(kern, plain),
          "KP3 != verify_words_rows_plain on the block's KP3 batch")
    kp3_err = max(kp3_err, int((kern.to(torch.int8)
                                - plain.to(torch.int8)).abs().max()))

    # KP2 on the whole block's device-bound words (every well-formed
    # P-256 item, whichever lane the provider gives it), as in slice 1
    recs, _ = cudaprov.parse_p256(p256_items, range(n_p256))
    keep, arrays = cudaprov.pack_p256_recs(recs)
    block_words = [torch.from_numpy(a).to(dev) for a in arrays]
    kp2_ms = event_ms(torch, lambda: p256.p256_verify(*block_words, table), t)
    kern = p256.p256_verify(*block_words, table)
    plain, plain_ms = timed_once(torch, lambda: (
        p256.verify_words_plain(*block_words, table)))
    check(torch.equal(kern, plain), "KP2 != verify_words_plain on the block")
    check((kern.cpu().numpy() == want[np.asarray(keep)]).all(),
          "KP2 on the block != labels")
    kp2_err = max(kp2_err, int((kern.to(torch.int8)
                                - plain.to(torch.int8)).abs().max()))

    # KP2 on the path's own KP2 batch: the lanes the provider sent to KP2
    # in the block runs (one block of threads, latency-bound)
    path_words = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in kp2_arrays]
    kp2_path_ms = event_ms(torch, lambda: p256.p256_verify(*path_words,
                                                           table), t)
    kern = p256.p256_verify(*path_words, table)
    plain, kp2_path_plain_ms = timed_once(torch, lambda: (
        p256.verify_words_plain(*path_words, table)))
    check(torch.equal(kern, plain),
          "KP2 != verify_words_plain on the path's KP2 batch")
    check((kern.cpu().numpy() == want[kp2_keep]).all(),
          "KP2 on the path's KP2 batch != labels")
    kp2_err = max(kp2_err, int((kern.to(torch.int8)
                                - plain.to(torch.int8)).abs().max()))

    lanes = len(keep)
    ca = field.ints_to_words_le([rng.randrange(R) for _ in range(lanes)], dev)
    cb = field.ints_to_words_le([rng.randrange(R) for _ in range(lanes)], dev)
    kp1_ms = event_ms(torch, lambda: field.field_mul_chain(ca, cb, CHAIN_K), t)
    _, kp1_plain_ms = timed_once(torch, lambda: field.mul_chain_plain(
        ca, cb, CHAIN_K))

    # KE6 on config 2's batch, KE5 on the generic load's and on the
    # block's 64 Ed25519 items
    ke6_ms = event_ms(torch, lambda: ed25519.ed25519_verify_rows(
        *e6_words, e6_slot_t, ebank_t, btab), t)
    ke5_ms = event_ms(torch, lambda: ed25519.ed25519_verify(*e5_words, btab),
                      t)
    b_pass = provider.pass_ed25519(items, range(n_p256, len(items)))
    b_words = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for a in b_pass.generic[1]]
    ke5_block_ms = event_ms(torch, lambda: ed25519.ed25519_verify(
        *b_words, btab), t)
    kern = ed25519.ed25519_verify(*b_words, btab)
    check(torch.equal(kern, ed25519.verify_words_plain(*b_words, btab)),
          "KE5 != verify_words_plain on the block's Ed25519 items")
    check((kern.cpu().numpy() == want[b_pass.generic[0]]).all(),
          "KE5 on the block's Ed25519 items != labels")
    # KE6 on config 2's first SMALL_BATCH signatures: one chain a
    # signature, the card nearly empty (the lone chain's cycles a
    # multiply), launched without the wrapper's copy of the slots
    e6_small = [w[..., :SMALL_BATCH].contiguous() for w in e6_words]
    ke6_small = kernel_launcher(
        torch, "ed25519_verify_rows", [*e6_small, e6_slot_t[:SMALL_BATCH]
                                       .to(dev), ebank_t, btab], SMALL_BATCH)
    ke6_small_ms = event_ms(torch, ke6_small, t)
    check(torch.equal(ke6_small(), ed25519.ed25519_verify_rows(
        *e6_words, e6_slot_t, ebank_t, btab)[:SMALL_BATCH]),
        "KE6 on its small batch != KE6 on the whole (== plain)")

    # one table's upload into a bank slot (K4: a host-to-device copy from
    # pageable memory, as the bank does), and the link's peak rate from
    # one large copy from pinned memory
    tab = torch.from_numpy(p256_tables.g_comb_table().copy())
    scratch = torch.empty_like(tab, device=dev)
    upload_ms = event_ms(torch, lambda: scratch.copy_(tab), t)
    etab = torch.from_numpy(ed25519_tables.basepoint_table().copy())
    escratch = torch.empty_like(etab, device=dev)
    ed_upload_ms = event_ms(torch, lambda: escratch.copy_(etab), t)
    big = torch.empty(H2D_BYTES, dtype=torch.uint8).pin_memory()
    big_d = torch.empty(H2D_BYTES, dtype=torch.uint8, device=dev)
    h2d_ms = event_ms(torch, lambda: big_d.copy_(big, non_blocking=True), t)
    h2d_rate = H2D_BYTES / (h2d_ms * 1e-3)
    del big, big_d

    # bounds: the larger of bytes over HBM rate and the multiply-adds the
    # field work needs (field.IMADS) over the INT32 rate, for this run's
    # inputs; s^-1 and Z^-1 count as batched, one chain per launch
    n = p256.N
    chain_muls = sum(p256.INV_N_CHAIN.values())

    def ints(a):
        return field.limbs_to_ints(field.words_be_to_limbs(
            torch.from_numpy(np.ascontiguousarray(a))))

    muls, imads, kp2_issued = kp2_work(arrays)
    kp2_ops_s = imads / imad_rate
    kp2_bytes_s = (lanes * (5 * 32 + 1) + table.nbytes) / HBM_BYTES_PER_S
    kp2_bound_ms = max(kp2_ops_s, kp2_bytes_s) * 1e3
    path_lanes = len(kp2_keep)
    _, path_imads, path_issued = kp2_work(kp2_arrays)
    kp2_path_bound_ms = max(
        path_imads / imad_rate,
        (path_lanes * (5 * 32 + 1) + table.nbytes) / HBM_BYTES_PER_S) * 1e3
    clock_hz = max_clock_mhz * 1e6
    kp2_res = _build.kernel_resources(built["p256_verify"]["log"],
                                      "p256_verify_kernel")
    kp3_res = _build.kernel_resources(built["p256_verify_rows"]["log"],
                                      "p256_verify_rows_kernel")
    ke5_res = _build.kernel_resources(built["ed25519_verify"]["log"],
                                      "ed25519_verify_kernel")
    ke6_res = _build.kernel_resources(built["ed25519_verify_rows"]["log"],
                                      "ed25519_verify_rows_kernel")
    # the lone chains: KE5 on the block's 64 items and KE6 on SMALL_BATCH
    # signatures run one chain a quad on a nearly empty card, so their
    # time over the chain's multiplies is one chain's cycles a multiply
    # (KE6's also carries its block's Euclid, which is no multiply); the
    # chain floor of a launch is the chain at that rate
    chain5 = ed25519.chain_muls("ed25519_verify")
    chain6 = ed25519.chain_muls("ed25519_verify_rows")
    ke5_lone = ke5_block_ms * 1e-3 * clock_hz / chain5
    ke6_lone = ke6_small_ms * 1e-3 * clock_hz / chain6
    ke5_chain = {"chain_muls": chain5,
                 "lone_chain_cycles_per_mul": round(ke5_lone, 1),
                 "chain_floor_ms": chain5 * ke5_lone / clock_hz * 1e3}
    ke6_chain = {"chain_muls": chain6,
                 "lone_chain_cycles_per_mul": round(ke6_lone, 1),
                 "chain_floor_ms": chain6 * ke6_lone / clock_hz * 1e3}
    kp3_lanes = len(f_keep)
    muls3, imads3 = chain_muls, p256.imads_per_launch()
    for r_, s_, e_ in zip(*[ints(a) for a in f_arrays]):
        w = pow(s_ % n, n - 2, n)
        u1, u2 = e_ * w % n, r_ * w % n
        muls3 += sum(p256_fixed.field_ops_per_verify_rows(u1, u2).values())
        imads3 += p256_fixed.imads_per_verify_rows(u1, u2)
    kp3_ops_s = imads3 / imad_rate
    kp3_tables = len(np.unique(f_slot))
    kp3_bytes_s = (kp3_lanes * (3 * 32 + 4 + 1)
                   + (kp3_tables + 1) * table.nbytes) / HBM_BYTES_PER_S
    kp3_bound_ms = max(kp3_ops_s, kp3_bytes_s) * 1e3
    # the timed chain is mod p (the wrapper's default)
    kp1_ops_s = lanes * CHAIN_K * field.IMADS["p", "mul"] / imad_rate
    kp1_bytes_s = lanes * 3 * 32 / HBM_BYTES_PER_S
    kp1_bound_ms = max(kp1_ops_s, kp1_bytes_s) * 1e3
    # KE6: a lane with S >= L is decided by the compare alone
    L = ed25519.L
    e6_ops = sum(ed25519.INV_CHAIN.values())
    e6_imads = ed25519.imads_per_launch()
    for s_, k_ in zip(ints(e6_arrays[2]), ints(e6_arrays[3])):
        if s_ < L:
            e6_ops += sum(ed25519.field_ops_per_verify_rows(s_, k_).values())
            e6_imads += ed25519.imads_per_verify_rows(s_, k_)
    ke6_lanes = len(e6_keep)
    ke6_ops_s = e6_imads / imad_rate
    ke6_bytes_s = (ke6_lanes * (3 * 32 + 4 + 4 + 1)
                   + (len(np.unique(e6_slot)) + 1) * etab.nbytes
                   ) / HBM_BYTES_PER_S
    ke6_bound_ms = max(ke6_ops_s, ke6_bytes_s) * 1e3
    # KE5: a lane whose A does not decompress needs only the
    # decompression, one with S >= L nothing
    e5_ops = sum(ed25519.INV_CHAIN.values())
    e5_imads = ed25519.imads_per_launch()
    ay_i, s_i, k_i = ints(e5_arrays[0]), ints(e5_arrays[4]), ints(e5_arrays[5])
    for j, i in enumerate(e5_keep):
        if s_i[j] >= L:
            continue
        neg = root_neg(ay_i[j]) if ay_i[j] < P25519 else False
        if ed25519_tables.decompress_int(g_items[i].pubkey) is None:
            c = ed25519.decompress_ops(neg)
        else:
            c = ed25519.field_ops_per_verify(s_i[j], k_i[j], neg)
        e5_ops += sum(c.values())
        e5_imads += sum(field.IMADS[key] * v for key, v in c.items())
    ke5_lanes = len(e5_keep)
    ke5_ops_s = e5_imads / imad_rate
    ke5_bytes_s = (ke5_lanes * (4 * 32 + 2 * 4 + 1) + etab.nbytes
                   ) / HBM_BYTES_PER_S
    ke5_bound_ms = max(ke5_ops_s, ke5_bytes_s) * 1e3

    # phase 13's stream through the window (W=4), on a fresh KV7 stack,
    # in the same profiled session
    stream_w4, _ = commit_stack(provider, orgs, True, dev, commit_window=4)
    profiled = device_busy(torch, {
        "block": lambda: provider.batch_verify(items),
        "config2": lambda: provider.batch_verify(c2_items),
        "stream W=4": lambda: pipeline_stream(stream_w4, commit_raws)})
    profiled_stream = {"stream W=4": profiled.pop("stream W=4")}
    del stream_w4

    print(name_power, flush=True)
    phase("times", block_items=len(items), warm=True,
          provider_e2e_ms=round(e2e_ms, 3),
          provider_sigs_per_s=round(len(items) / e2e_ms * 1e3, 1),
          p256_only_ms=round(p256_ms, 3),
          p256_only_sigs_per_s=round(n_p256 / p256_ms * 1e3, 1),
          host_pass_ms=round(host_ms, 3), ke5_on_64_ms=round(ke5_block_ms, 4))
    phase("times", config2_items=args.ed, warm=True,
          config2_e2e_ms=round(c2_e2e_ms, 3),
          config2_sigs_per_s=round(args.ed / c2_e2e_ms * 1e3, 1),
          config2_cold_ms=round(c2_ms["cold"], 3),
          ed25519_host_pass_ms=round(ed_host_ms, 3),
          config3_items=len(c3_items), config3_e2e_ms=round(c3_e2e_ms, 3),
          config3_sigs_per_s=round(len(c3_items) / c3_e2e_ms * 1e3, 1),
          generic_items=args.gen, generic_e2e_ms=round(g_e2e_ms, 3))
    phase("times", kp3_ms=round(kp3_ms, 4), kp3_sigs=kp3_lanes,
          kp3_tables=kp3_tables, kp3_plain_ms=round(kp3_plain_ms, 2),
          kp3_vs_plain_on_block="equal",
          mont_muls_per_verify=round(muls3 / kp3_lanes, 1),
          imads_per_verify=round(imads3 / kp3_lanes, 1),
          kp3_bound_ms=round(kp3_bound_ms, 4),
          kp3_bound_by="operations" if kp3_ops_s >= kp3_bytes_s else "bytes",
          **kp3_res)
    phase("times", kp2_ms=round(kp2_ms, 4), kp2_sigs=lanes,
          plain_ms=round(plain_ms, 2), kp2_vs_plain_and_labels="equal",
          mont_muls_per_verify=round(muls / lanes, 1),
          imads_per_verify=round(imads / lanes, 1),
          issued_muls_per_verify=round(kp2_issued / lanes, 1),
          sm_cycles_per_mul=round(kp2_ms * 1e-3 * clock_hz * sms
                                  / kp2_issued, 2),
          kp2_bound_ms=round(kp2_bound_ms, 4), **kp2_res)
    phase("times", kp2_path_ms=round(kp2_path_ms, 4), kp2_path_sigs=path_lanes,
          kp2_path_plain_ms=round(kp2_path_plain_ms, 2),
          kp2_path_vs_plain_and_labels="equal",
          issued_muls_per_verify=round(path_issued / path_lanes, 1),
          chain_cycles_per_mul=round(kp2_path_ms * 1e-3 * clock_hz
                                     * path_lanes / path_issued, 1),
          kp2_path_bound_ms=round(kp2_path_bound_ms, 6))
    phase("times", ke6_ms=round(ke6_ms, 4), ke6_sigs=ke6_lanes,
          ke6_plain_ms=round(ke6_plain_ms, 2),
          mont_muls_per_verify=round(e6_ops / ke6_lanes, 1),
          imads_per_verify=round(e6_imads / ke6_lanes, 1),
          ke6_bound_ms=round(ke6_bound_ms, 4),
          ke6_small_ms=round(ke6_small_ms, 4), ke6_small_sigs=SMALL_BATCH,
          **{k: round(v, 4) for k, v in ke6_chain.items()}, **ke6_res)
    phase("times", ke5_ms=round(ke5_ms, 4), ke5_sigs=ke5_lanes,
          ke5_plain_ms=round(ke5_plain_ms, 2),
          mont_muls_per_verify=round(e5_ops / ke5_lanes, 1),
          imads_per_verify=round(e5_imads / ke5_lanes, 1),
          ke5_bound_ms=round(ke5_bound_ms, 4),
          ke5_block_ms=round(ke5_block_ms, 4),
          ke5_block_sigs=len(b_words[1]),
          **{k: round(v, 4) for k, v in ke5_chain.items()}, **ke5_res)
    phase("times", kp1_ms=round(kp1_ms, 4), kp1_lanes=lanes, kp1_k=CHAIN_K,
          kp1_ns_per_mul=round(kp1_ms * 1e6 / (lanes * CHAIN_K), 4),
          kp1_plain_ms=round(kp1_plain_ms, 2),
          kp1_bound_ms=round(kp1_bound_ms, 4))
    phase("times", table_upload_ms=round(upload_ms, 4),
          table_bytes=tab.nbytes, uploads_cold=hot_keys, uploads_warm=0,
          table_build_s=round(table_build_s, 3),
          table_build_ms_each=round(table_build_s / max(hot_keys, 1) * 1e3,
                                    1))
    phase("times", ed_table_upload_ms=round(ed_upload_ms, 4),
          ed_table_bytes=etab.nbytes, ed_uploads_cold=ED_KEYS,
          ed_table_build_ms_each=round(ed_table_build_s / ED_KEYS * 1e3, 1),
          h2d_peak_bytes=H2D_BYTES, h2d_peak_ms=round(h2d_ms, 4),
          h2d_peak_gb_per_s=round(h2d_rate / 1e9, 3),
          upload_bound_ms=round(tab.nbytes / h2d_rate * 1e3, 4),
          ed_upload_bound_ms=round(etab.nbytes / h2d_rate * 1e3, 4))
    for run, (b_ms, w_ms, tp) in profiled.items():
        phase("times", profiled=run, wall_ms=round(w_ms, 3),
              device_busy_ms=round(b_ms, 3),
              device_idle_share=round(1 - b_ms / w_ms, 4),
              top_device_ops=tp)
    phase("times", library="none: no PyTorch call computes ECDSA or "
          "Ed25519 verify (any lane) or a Montgomery multiply chain")

    # --- 9. idemix (before the kernels line, which it feeds) ---------------
    phase("idemix", issuers=len(id_configs), signers=len(id_signers),
          gen_s=round(idemix_gen_s, 2), block_txs=len(idemix_labels),
          corrupted=IDEMIX_BAD, sign_s=round(idemix_sign_s, 2),
          policy=IDEMIX_POLICY)
    kb8_row, idemix_launches = idemix_phase(
        torch, args, provider, orgs[0], id_configs, idemix_raw,
        idemix_labels, fns, imad_rate, max_clock_mhz * 1e6)
    for kname, n in idemix_launches.items():
        total[kname] = total.get(kname, 0) + n
    kv7_row["launches"] += idemix_launches["block_validate"]
    probe_row = tower_probe_phase(torch, args.trials, imad_rate,
                                  max_clock_mhz * 1e6)
    probe_row["launches"] = total.get("bn254_tower_probe", 0)
    field_probe_row["launches"] = total.get("p256_field_probe", 0)

    # --- 10. mesh ------------------------------------------------------------
    cells = {"block": (items, labels, kinds, ("p256_verify_rows",
                                              "p256_verify",
                                              "ed25519_verify"), ()),
             "config2": (c2_items, c2_labels, c2_kinds,
                         ("ed25519_verify_rows",), ()),
             "config3": (c3_items, list(c3_want), c3_kinds,
                         ("p256_verify_rows", "ed25519_verify_rows"),
                         ("p256_verify",))}
    mesh_phase(torch, args, cells, (items[:n_spill], labels[:n_spill],
                                    kinds[:n_spill]), (hot_keys, ED_KEYS),
               host_tables, fns, name_power)

    # --- 11. durable ---------------------------------------------------------
    durable_out = durable_phase(torch, args, provider, orgs, signers,
                                clients, commit_raws, mem_rows, fns,
                                name_power, dev)

    # --- 12. classic ---------------------------------------------------------
    phase("classic", cache_capacity=CACHE_CAPACITY, sbe_sign_s=round(
        sbe_s, 2), stack="classic tail, sbe_lookup=statedb_lookup, "
        "VerdictCache, no DeviceValidator", card=name_power)
    classic_launches = classic_phase(
        torch, args, provider, orgs, commit_raws, commit_labels, mem_rows,
        sbe, (id_configs, idemix_raw, idemix_labels), fns, name_power, dev)

    # --- 13. window ----------------------------------------------------------
    window_launches = window_phase(
        torch, args, provider, orgs, signers, commit_raws, commit_labels,
        mem_rows, durable_out, profiled_stream, fns, name_power, dev)
    del mem_rows

    # --- 8. kernels ----------------------------------------------------------
    def by(ops_s, bytes_s):
        return "operations" if ops_s >= bytes_s else "bytes"

    phase("kernels", main_path_launches=total,
          runs="block cold+warm, config 2 cold+warm, config 3, generic load,"
          " commit stream, idemix probe, idemix block (CUDA and SW stacks),"
          " idemix batch_verify")
    kernels = [
        kb8_row,
        probe_row,
        kv7_row,
        {"name": "p256_verify_rows", "route": "cuda",
         "source": "fabric_tpu_torch/ops/csrc/p256_verify_rows.cu",
         "replaces": "fabric_tpu/ops/p256_fixed.py:94",
         "launches": total["p256_verify_rows"], "max_abs_err": kp3_err,
         "ms": kp3_ms, "plain_ms": kp3_plain_ms, "bound_ms": kp3_bound_ms,
         "bound_by": by(kp3_ops_s, kp3_bytes_s),
         "library_ms": None, "on_main_path": True, **kp3_res},
        {"name": "p256_verify", "route": "cuda",
         "source": "fabric_tpu_torch/ops/csrc/p256_verify.cu",
         "replaces": "fabric_tpu/ops/ecp256.py:447",
         "launches": total["p256_verify"], "max_abs_err": kp2_err,
         "ms": kp2_ms, "plain_ms": plain_ms, "bound_ms": kp2_bound_ms,
         "bound_by": by(kp2_ops_s, kp2_bytes_s),
         "library_ms": None, "on_main_path": True,
         "path_lanes": path_lanes, "ms_path": kp2_path_ms,
         "bound_ms_path": kp2_path_bound_ms, **kp2_res},
        field_probe_row,
        {"name": "ed25519_verify_rows", "route": "cuda",
         "source": "fabric_tpu_torch/ops/csrc/ed25519_verify_rows.cu",
         "replaces": "fabric_tpu/ops/ed25519.py:75",
         "launches": total["ed25519_verify_rows"], "max_abs_err": ke6_err,
         "ms": ke6_ms, "plain_ms": ke6_plain_ms, "bound_ms": ke6_bound_ms,
         "bound_by": by(ke6_ops_s, ke6_bytes_s),
         "library_ms": None, "on_main_path": True,
         "ms_small": ke6_small_ms, **ke6_chain, **ke6_res},
        {"name": "ed25519_verify", "route": "cuda",
         "source": "fabric_tpu_torch/ops/csrc/ed25519_verify.cu",
         "replaces": "fabric_tpu/ops/ed25519.py:47",
         "launches": total["ed25519_verify"], "max_abs_err": ke5_err,
         "ms": ke5_ms, "plain_ms": ke5_plain_ms, "bound_ms": ke5_bound_ms,
         "bound_by": by(ke5_ops_s, ke5_bytes_s),
         "library_ms": None, "on_main_path": True,
         "ms_block": ke5_block_ms, **ke5_chain, **ke5_res},
        *experiment_rows(exp_results, total, field_err),
    ]
    for row in kernels:
        # phases 12's and 13's main-path launches, each in its own count
        row["classic_launches"] = classic_launches.get(row["name"], 0)
        row["window_launches"] = window_launches.get(row["name"], 0)
    phase("done", seconds=round(time.perf_counter() - t_start, 1),
          by_phase={k: round(v, 1) for k, v in _PHASE_S.items()})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
