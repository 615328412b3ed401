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
             probes (proto_pallas3.py); at the reference's B = 16,384
             (a card-filling B is left out for the time limit), each held
             against its plain version and Python ints (64 lanes),
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
             stage, with one profiled run, and in turns with it the KV7
             stack's block 2 with the tracer on and off, which first
             alternating by trial, each after a full garbage collection
             (`ops_plane_cost_ms`: the median traced minus untraced,
             with each's min and max);
             the ops plane read back (`ops_phase6`): one more warm block
             2 on a fresh KV7 stack, the tracer on, an OperationsServer
             on port 0 with the trace and resource routes, /metrics,
             /traces and /resources fetched over HTTP: the block's trace
             holds every span of OPS_SPANS under its parent,
             provider_device_sigs_total grew by the items the provider
             took, each lane's provider_lane_slots_total on cuda:0 by its
             launch's grid slots, the dispatch queue is back to 0,
             validator_device_dispatches_total grew by KV7's launches,
             ledger_height is 3, cuda_allocated_bytes is positive,
             provenance() says "gpu" and the card's name
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
             labels, timed; a block of IDEMIX_TXS (16) txs whose creators
             are idemix signers of two issuers (the port's idemixgen; a
             presentation over another payload, a forged credential and
             garbage among them), endorsed by Org1 under
             OR('Org1.member'), committed by two port stacks (the
             factory's CUDA provider and the SW
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
             wave widths, workers and fallbacks, and its ops-plane series
             (commit_graph_waves_total, the wave widths, the edges by
             kind, commit_serial_fallbacks_total,
             commit_workers_effective) equal to its own counts; the first
             W=4 run traced, each submit under a root span: one
             mvcc.window.admit span a block with the block's early and
             deferred txs, commit_window_admitted_total,
             commit_window_txs_total and the cross-block edges equal to
             the run's own window; (b) (c)'s first stream on
             phase 11's durable configuration at W=4, its directory byte
             for byte the serial durable stack's; a retire failure injected
             in block 2 fails block 2's and block 3's futures, leaves the
             block store at blocks 0-1, and the redelivery finishes
             blocks 2 and 3 once each to the serial hash and directory;
             (c) the stream's wall time serial, W=2 and W=4, on memory
             and on the durable ledger, fresh ledgers, in turns, medians
             of WINDOW_MEMORY_TRIALS (2) on memory and of
             WINDOW_DURABLE_TRIALS (1) durable, with the spread, each
             block's early and deferred txs, overlap_frac, the stages
             summed; the device
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
14. intake — (run after 13, before the kernels line) the peer's block
             intake: an orderer stand-in (the port's RpcServer serving
             `deliver` through its DeliverHandler over a one-channel
             registrar) holds phase 6's stream at full width, each block
             written and signed by the port's BlockWriter with the
             identity of an orderer org added to the MSPs; peer 1 (its
             own RpcServer, SecureGossipTransport under a ChannelMux,
             GossipNode with RemoteDeliver, privdata Coordinator and the
             default peer's committer: classic tail, SBE lookup,
             VerdictCache(65536), KVLedger in memory with 8 shards) pulls
             it one block a pull through the authenticated RPC plane (the
             lite AEAD and X25519 where `cryptography` is missing) and
             checks each block's orderer signature through its MCS on the
             factory's provider (the CUDA provider, fail-stop); peer 2 is
             the same but gets the blocks only by gossip, each re-checked
             by its MCS.  After every block both peers' flags, metadata
             flags, state, history and commit hash equal phase 6's host
             stack; the block bytes on the wire, the AEAD's MB/s, per
             block from its trace (the tracer's spans) the connect,
             deliver (serve + receive + decrypt + parse),
             orderer-signature verify, gossip hand-off and commit ms and
             peer 2's MCS and commit ms, the wall ms from the first pull
             to the last commit on each peer; one cold run (the two
             peers' commits at once), then a warm run with peer 2's
             commit held until peer 1's is done; KP3 and KP2 launches
             by cause in the cold run (handshakes, gossip alive
             messages, orderer signatures, gossiped blocks' MCS checks,
             each peer's commits), the card's idle share over peer 1's
             block 2; drills: block 3 first served with a corrupted
             orderer signature is dropped and the good one then commits,
             a tampered copy gossiped to peer 2 is refused by its MCS, a
             rogue-org client is refused at peer 1's handshake;
             `fallbacks` 0.  Its main-path launches are counted apart
             (the kernels line's `intake_launches`)
15. endorse — (run after 14, before the kernels line) the endorsement
             side on the factory's CUDA provider (fail-stop), the tracer
             on: two endorsing peers (Org1 P-256, Org2 Ed25519), each
             with its own in-memory ledger, the default peer's committer
             on a LifecyclePolicyProvider under the privdata
             coordinator (collection cc/secrets, Org1 only), an
             ACLProvider over the channel's BundleSource and an Endorser
             behind its own RpcServer (`endorse`); the same two on the
             port's SoftwareProvider (the plain path); an orderer
             stand-in (the port's BlockWriter) signs every block.
             `_lifecycle`: both orgs approve cc (AND of the orgs), Org1
             commits it, every peer's policy_for("cc") the same bytes; a
             seed block of 20 txs creating 10,000 accounts; the load, one
             block of 500 proposals (the channel's default
             MaxMessageCount): 450 transfers (pairs sharing an account
             conflict), 25 private writes, 10 transfers beyond the
             balance, 5 bad signatures, 5 creators of an org outside the
             channel, 5 queries, each through both endorsers in turn over
             the RPC plane, profiled; every response's status, message,
             payload and endorser equal the plain path's, each
             endorsement verified on SW; the 200-status ones in one block
             committed by both peers (peer 1 takes the private writes'
             cleartext from its transient store, peer 2 hashes only),
             flags, metadata flags, state, history, pvt store and commit
             hash equal the plain peers' and the flags the mix's labels;
             qscc (chain info, every block, every committed tx by id),
             cscc and discovery through the ACL provider, decisions equal
             SW's, discovery's layout {Org1: 1, Org2: 1}; each peer's
             gossip state given a ByzantineMonitor and a ProofGossip, a
             sibling of the last block signed by the orderer stand-in and
             gossiped to peer 1 convicts the orderer, peer 2 re-verifies
             the proof on the card and quarantines it too;
             process_proposal p50/p99 per endorser and client org from
             the tracer's spans (rpc.endorse, endorser.validate,
             simulate, sign), proposals/s, each block's commit ms, qscc
             ms, check_block ms, launches by kernel and cause, the
             device's idle share over the load; `fallbacks` 0.  Its
             launches are counted apart (the kernels line's
             `endorse_launches`)
16. node   — (run after 15, before the kernels line) the peer as a
             process behind the port's Raft orderers: the reference's
             dev network made by the port's provision_network (three
             orderers and a spare consenter identity, Org1 and Org2 with
             one peer each, the channel's default BatchSize 500 / 10 MiB
             and BatchTimeout 2 s, asset_demo under AND of the orgs); the
             three orderers `python -m fabric_tpu_torch.node.orderer
             <node.json>`, a process each, on the factory's CUDA provider
             (each loads its kernels before its Raft clock starts); peer
             1 a PeerNode in this process from its provisioned config
             with no `bccsp` key (the factory's CUDA provider,
             fail-stop); peer 2 `python -m fabric_tpu_torch.node.peer
             <node.json>` in a child process, also on the card; a third
             Org1 node on SW in a child process of its own (the identity
             check).  The seed: 10,000 `create` txs stamped by peer 1's
             gateway plane and broadcast with their verdict
             attestations, 500 a call: 20 blocks through Raft; then 32
             clients (16 an org, Org1 P-256, Org2 Ed25519, half through
             each peer's gateway; a thread each in 4 client processes of
             their own) endorse 16 transfers each, then all submit at
             once without waiting (512 in flight: one block cut at the
             count of 500, the rest at the timeout), then wait for each
             commit status; the first txs of six client pairs transfer
             one asset (MVCC conflicts); one envelope with a broken
             creator signature is refused by the leader's SigFilter.
             Held: each block's flags and commit hash, the state and
             history equal on the three peers; no tx ordered twice, and
             each commit status equal to its tx's committed flag;
             `fallbacks` 0; launches by cause (proposal, acl,
             speculative, commit, deliver_sig, handshake, gossip_mcs,
             alive) sum to the wrappers' counts and every proposal's
             creator check at peer 1 launched on the card; /healthz (the
             provider's name, backend, degraded), /verify_plane,
             /gateway, /byzantine, /state, /traces and /slo answer with
             the same keys on peers 1 and 2, and each orderer's /healthz
             the CUDA backend; after phase 17, POST /drain, peer 1
             reopened on its data_dir at the same height and commit hash,
             and the orderers' block stores equal header for header.
             Printed: gateway endorse, submit and submit-to-status
             p50/p99, committed tx/s, the blocks cut at the count and
             each load block's cut after the first submit, each block's
             validate + commit ms on both CUDA peers, each orderer's
             broadcast span, SigFilter device verifies, attested skips,
             Raft entry verifies and provider dispatches by lane (its
             /metrics and /spans/stats), launches by cause,
             verdict-cache hits by source, the device's idle share over
             the load in this process.  Its launches in this process are
             counted apart (the kernels line's `node_launches`)
17. orderer — (on phase 16's network, before its drains) the ordering
             service's drills: the Raft leader SIGKILLed while 128
             transfers are in flight (kill -> new leader -> first block
             -> committed on both peers, each tx exactly once with the
             code its client got, a tx lost with the leader resubmitted
             by its client); the killed orderer restarted from its WAL
             and caught up to the leader's tip; a second channel joined
             at runtime on the three orderers (`participation.join`) and
             the two peers (the admin CLI), one tx on it; onboarding
             (`_replicate_once`) of both channels on the card by a port
             OrdererNode on the spare identity; a spliced Raft entry
             rejected as `bad_entry_sig` by a follower's CUDA provider;
             that node as `testing.adversary.EquivocatingOrderer`
             convicted of a fork by peer 1's monitor.  Its launches in
             this process are counted apart (`orderer_launches`)
18. workload — (after 17 and phase 16's drains, before the kernels line)
             the workload plane on the card: (a) the catalog's
             membership-churn (`run_scenario(..., strict=True)` on the
             default provider, in this process: three orderers and a
             spare, a peer in each of two orgs, 10 tx/s open loop for 14
             s; the spare added by an add-consenter config entry,
             started, handed leadership, then orderer1 removed and
             killed): the SLO's 5 checks pass, every node on the CUDA
             provider with no fallback, KP3 and KP2 launched (KP3 only
             by the orderers' start-up warm-up: no key brings 64
             signatures to one batch at 10 tx/s), KP2 also by the load,
             every remaining orderer's Raft entry verifies moved; offered, accepted and committed
             per phase, sojourn p50/p99, the drill's timeline; (b) the
             CLI's burst load shape (`python -m fabric_tpu_torch.workload
             --scenario burst --rate 30 --duration 8`) in a child on the
             card: exit 0, load offered and committed, the gateway's
             admission snapshot; (c) run inside phase 16 before its
             drains: the port's `top` (`collect_node`, `render`, and
             `python -m fabric_tpu_torch.node.top --once` as a child) on
             every orderer's and peer's ops address: every row up, each
             peer's height its ledger's, peer 1's slots on cuda:0.  (a)'s
             launches are counted apart (`workload_launches`)
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
    python3 chip_smoke.py --ops-only   # phase 6's ops-plane check alone
    python3 chip_smoke.py --intake-only   # phase 14 alone
    python3 chip_smoke.py --endorse-only  # phase 15 alone
    python3 chip_smoke.py --node-only     # phase 16 alone
    python3 chip_smoke.py --orderer-only  # phases 16 and 17 alone
    python3 chip_smoke.py --workload-only # phase 18's (a) and (b) alone

Any failed check raises, so the script exits non-zero and prints no
result line.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import multiprocessing
import os
import random
import re
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
IDEMIX_TXS = 16               # was 32, then 24: cut for the time limit
#                                (PERF.md §4)
IDEMIX_SIGNERS = 2             # per issuer, two issuers
IDEMIX_BAD = {5: "nonce", 9: "forged", 13: "garbage"}
IDEMIX_POLICY = "OR('Org1.member')"
# the default peer's tail (phase 12): the verify-once cache's capacity
# (the reference peer's default), the SBE stream's blocks and txs, its
# chaincode policy (either org), its key policies by name, and the share
# of its txs that set or delete a key policy
CACHE_CAPACITY = 65536
CLASSIC_TIMED_TRIALS = 2       # (g)'s turns of the four stacks: was
#                                --trials (3), cut for the time limit
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
WINDOW_MEMORY_TRIALS = 2       # timed memory streams (was 3) and durable
WINDOW_DURABLE_TRIALS = 1      # ones (was 2): cut for the script's time
#                                limit when phase 17 came (PERF.md §4)
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


def device_busy(torch, runs: dict, threaded: bool = False) -> dict:
    """One profiled session over labelled runs, {label: fn} (each fn
    synchronises): -> {label: (device busy ms, wall ms, the three ops
    with the most device time)}.  `threaded`: the one run launches its
    device work from other threads (an RPC server's handlers), which the
    profiler does not tie to the caller's range, so its busy time is
    every device event of the session after the marker's.  Each run is a
    range of its own
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
    check(not threaded or len(runs) == 1,
          "device_busy: a threaded run is profiled alone")
    if threaded:
        return {label: _threaded_busy(prof, walls[label])
                for label in runs}
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = {e.name[5:]: e.time_range for e in device
             if e.name.startswith("busy:")}
    check(MARKER in spans, "device_busy: the marker was not recorded: the "
          "profiler was not yet recording")
    out = {}
    for label in runs:
        check(label in spans, f"device_busy: {label}: the profiler "
              "recorded no device time")
        span = spans[label]
        per_op = {}
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


def _threaded_busy(prof, wall_ms: float) -> tuple:
    """A threaded run's (busy ms, wall ms, top three ops): every device
    event after the marker's range, read from the profiler's raw kineto
    events (building `prof.events()`, the whole session's CPU event tree,
    cost ~7 s for a 10-s load of 77,000 events)."""
    from torch.autograd import DeviceType
    from fabric_tpu_torch.ops_plane.profiling import MARKER
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    marks = [e.end_ns() for e in device if e.name() == "busy:" + MARKER]
    check(bool(marks), "device_busy: the marker was not recorded: the "
          "profiler was not yet recording")
    per_op = {}
    for e in device:
        if not e.name().startswith("busy:") and e.start_ns() >= marks[0]:
            per_op[e.name()] = per_op.get(e.name(), 0) + e.duration_ns()
    busy_ms = sum(per_op.values()) / 1e6
    check(busy_ms > 0, "device_busy: a threaded run: the profiler recorded "
          "no device time")
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:3]
    return (busy_ms, wall_ms,
            [f"{k[:40]}:{ns / 1e6:.3f}ms" for k, ns in top])


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


# ---------------------------------------------------------------------------
# the ops plane: what phase 6 and phase 13 read back from it
# ---------------------------------------------------------------------------

# one block's trace on phase 6's KV7 stack, each span under its parent:
# the reference's tree (tests/test_torch_ops_wiring.py holds the port's
# to it on the CPU).  The validator's stages, the provider's batch and
# the ledger's phases are all children of the block's root span: the
# stages are recorded after the fact and the batch's span runs from the
# enqueue in pass 1 to the resolve in the dispatch wait
OPS_ROOT = "committer.store_block"
OPS_SPANS = {OPS_ROOT: None,
             **dict.fromkeys(("validator.collect", "bccsp.batch_verify",
                              "validator.dispatch_wait", "validator.gate",
                              "ledger.mvcc", "ledger.block_commit",
                              "ledger.state_commit", "ledger.history_commit",
                              "committer.notify"), OPS_ROOT)}
_SAMPLE = re.compile(r"^([A-Za-z_:][\w:]*)(?:\{(.*)\})? (\S+)$")
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def get_url(url: str) -> str:
    import urllib.request
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def scrape(url: str) -> dict:
    """A /metrics page -> {name: {((label, value), ...): value}}."""
    return parse_metrics(get_url(url))


def parse_metrics(text: str) -> dict:
    """Prometheus exposition text -> {name: {((label, value), ...):
    value}}."""
    out = {}
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if m is None:
            continue
        labels = tuple(sorted(_LABEL.findall(m.group(2) or "")))
        out.setdefault(m.group(1), {})[labels] = float(m.group(3))
    return out


def moved_by(m0: dict, m1: dict, name: str, **labels) -> float:
    """What one series gained between two scrapes."""
    key = tuple(sorted(labels.items()))
    return m1.get(name, {}).get(key, 0.0) - m0.get(name, {}).get(key, 0.0)


class Traced:
    """Inside: the port's tracer on at a sample rate of 1.0 with an empty
    flight recorder; after: as it was, the recorder emptied again."""

    def __enter__(self):
        from fabric_tpu_torch.ops_plane import tracing
        self.t = tracing.tracer
        self.was = (self.t.enabled, self.t.sample_rate)
        self.t.reset()
        self.t.configure({"enabled": True, "sample_rate": 1.0})
        return self.t

    def __exit__(self, *exc):
        self.t.enabled, self.t.sample_rate = self.was
        self.t.reset()
        return False


def trace_spans(url: str, root: str) -> list:
    """The traces the ops server's /traces lists under `root` -> [{span
    name: (parent's name, args)}], each fetched from /traces/<id>."""
    out = []
    for rec in json.loads(get_url(url + "/traces"))["recent"]:
        if rec["root"] != root:
            continue
        doc = json.loads(get_url(f"{url}/traces/{rec['trace_id']}?follow=0"))
        evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        names = {e["args"]["span_id"]: e["name"] for e in evs}
        out.append({e["name"]: (names.get(e["args"]["parent_id"]), e["args"])
                    for e in evs})
    return out


def ops_phase6(torch, provider, orgs, raws, dev) -> dict:
    """Phase 6's ops check: one more warm block 2 on a fresh KV7 stack
    holding blocks 0 and 1, the tracer on, an OperationsServer on port 0
    with the trace and resource routes and a ResourceCollector; /metrics
    before and after the block, /traces and /resources after, over HTTP.
    Fails unless the block's trace holds every span of OPS_SPANS under
    its parent, provider_device_sigs_total grew by the items the provider
    took (launched and refused on the host), each lane's
    provider_lane_slots_total on cuda:0 by its launches' grid slots (at
    least its items), the dispatch queue is back to 0,
    validator_device_dispatches_total grew by KV7's launches, the ledger
    height is 3, cuda_allocated_bytes is positive and provenance() names
    the card.  -> the numbers read."""
    from fabric_tpu_torch.bccsp.cuda import grid_slots
    from fabric_tpu_torch.device import with_index
    from fabric_tpu_torch.ops import block_validate as kv7
    from fabric_tpu_torch.ops_plane import (OperationsServer,
                                            ResourceCollector, provenance,
                                            register_resource_routes,
                                            register_trace_routes)
    c, _dv = commit_stack(provider, orgs, True, dev)
    commit_stream(c, raws[:2])
    srv = OperationsServer(port=0)
    col = ResourceCollector({"interval_s": 60.0})
    register_trace_routes(srv)
    register_resource_routes(srv, col)
    srv.start()
    url = "http://%s:%d" % srv.addr
    try:
        m0 = scrape(url + "/metrics")
        st0, k0 = dict(provider.stats), kv7.block_validate_kernel.launches
        with Traced():
            (res, _meta, secs, _rows), = commit_stream(c, raws[2:3])
            traces = trace_spans(url, OPS_ROOT)
        m1 = scrape(url + "/metrics")
        resources = json.loads(get_url(url + "/resources"))
    finally:
        srv.stop()
    kv7_launches = kv7.block_validate_kernel.launches - k0
    launched = provider.stats["device_sigs"] - st0["device_sigs"]
    refused = provider.stats["host_rejects"] - st0["host_rejects"]
    check(len(traces) == 1, f"ops: {len(traces)} block traces, expected 1")
    spans = traces[0]
    missing = {n: p for n, p in OPS_SPANS.items()
               if n not in spans or spans[n][0] != p}
    check(not missing, f"ops: spans missing or under another parent: "
          f"{missing} (got {({n: v[0] for n, v in spans.items()})})")
    check(spans[OPS_ROOT][1]["block"] == 2, "ops: the trace is not block 2's")
    sigs = moved_by(m0, m1, "provider_device_sigs_total")
    n_items = res.validation.n_unique_items
    check(sigs == launched + refused == n_items,
          f"ops: provider_device_sigs_total grew {sigs}, the provider "
          f"launched {launched} and refused {refused} of {n_items} items")
    card = str(with_index(dev))
    lanes = {}
    for kind, lane in (("p256-rows", "rows"), ("p256", "generic")):
        slots = moved_by(m0, m1, "provider_lane_slots_total", device=card,
                         lane=lane)
        pads = moved_by(m0, m1, "provider_pad_slots_total", device=card,
                        lane=lane)
        real = slots - pads
        check(slots >= real >= 0 and slots == grid_slots(kind, int(real),
                                                         dev),
              f"ops: lane {lane} on {card}: {slots} slots for {real} items")
        lanes[lane] = (int(real), int(slots))
    check(sum(r for r, _ in lanes.values()) == launched and lanes["rows"][0],
          f"ops: lane items {lanes} != the {launched} launched")
    depth = m1.get("provider_dispatch_queue_depth", {}).get(())
    check(depth == 0.0, f"ops: provider_dispatch_queue_depth {depth} != 0")
    dispatches = moved_by(m0, m1, "validator_device_dispatches_total",
                          channel="ch")
    check(dispatches == kv7_launches == 1,
          f"ops: validator_device_dispatches_total grew {dispatches}, KV7 "
          f"launched {kv7_launches} times")
    height = m1.get("ledger_height", {}).get((("channel", "ch"),))
    check(height == 3, f"ops: ledger_height {height} != 3")
    check(resources.get("cuda_allocated_bytes", 0) > 0,
          f"ops: cuda_allocated_bytes {resources.get('cuda_allocated_bytes')}")
    prov = provenance()
    check(prov["platform"] == "gpu"
          and prov["device_kind"] == torch.cuda.get_device_name(0),
          f"ops: provenance {prov}")
    return {"spans": sorted(spans), "device_sigs": int(sigs),
            "launched": launched, "refused": refused, "lanes": lanes,
            "queue_depth": depth, "kv7_dispatches": int(dispatches),
            "ledger_height": int(height),
            "cuda_allocated_bytes": int(resources["cuda_allocated_bytes"]),
            "provenance": {k: prov[k] for k in ("platform", "device_kind",
                                                "n_devices")},
            "block_s": round(secs, 4)}


def ops_only(torch, args) -> int:
    """`--ops-only`: the commit stream, the factory's CUDA provider and
    `ops_phase6` alone (the kernels build on first use)."""
    from fabric_tpu_torch.bccsp import FactoryOpts, init_factories
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, multiprocessing.cpu_count())) as pool:
        orgs, signers, endorsers, clients = commit_identities()
        env_blocks, _labels, _kinds = build_stream(
            args.commit_txs, args.commit_last, signers, endorsers, clients,
            pool)
    raws = chain_blocks(env_blocks)
    provider = init_factories(FactoryOpts(default="CUDA"))
    phase("commit", ops_plane="checked", **ops_phase6(
        torch, provider, orgs, raws, torch.device("cuda")))
    return 0


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
    # commit, its stages, and one profiled run; and in turns with them
    # the ops plane's cost: the KV7 stack's block 2 with the tracer on
    # and off (its registry writes are always on, its spans only when
    # traced), which side goes first alternating by trial, each after a
    # full garbage collection
    stages = {True: [], False: []}
    cost = {True: [], False: []}
    for trial in range(args.trials):
        for traced in ((True, False) if trial % 2 == 0 else (False, True)):
            c, _ = commit_stack(provider, orgs, True, dev)
            commit_stream(c, raws[:2])
            gc.collect()
            with Traced() if traced else contextlib.nullcontext():
                (_res, _meta, secs, _rows), = commit_stream(c, raws[2:3])
            cost[traced].append(secs * 1e3)
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
    traced_ms, untraced_ms = cost[True], cost[False]
    phase("commit", block=2, kv7="on", ops_plane_cost_ms=round(
        statistics.median(traced_ms) - statistics.median(untraced_ms), 3),
          traced_ms=round(statistics.median(traced_ms), 3),
          traced_min_max=[round(min(traced_ms), 3), round(max(traced_ms), 3)],
          untraced_ms=round(statistics.median(untraced_ms), 3),
          untraced_min_max=[round(min(untraced_ms), 3),
                            round(max(untraced_ms), 3)],
          trials=args.trials)
    phase("commit", ops_plane="checked", **ops_phase6(torch, provider, orgs,
                                                      raws, dev))
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
    from fabric_tpu_torch.verify_plane.cache import _m
    counted = {**fns, "block_validate": kv7.block_validate_kernel}

    def cached():
        """The verify-once plane's counters in the ops plane's registry
        (process-wide: read as deltas around one cache's work)."""
        m = _m()
        return {"hits": m["hits"].total(), "misses": m["misses"].total(),
                "mac": m["rejects"].value(reason="mac"),
                "stale": m["rejects"].value(reason="stale")}
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
        c0, i0 = cached(), prov.items
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
              cache_hits=cached()["hits"] - c0["hits"],
              cache_misses=cached()["misses"] - c0["misses"],
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
    c0 = cached()
    (res, secs, _), launches = run(lambda: commit_one(spec, raws[2]))
    check(all(launches[k] == 0 for k in kp) and prov.items == 0
          and cached()["misses"] == c0["misses"],
          f"spec-filled block 2 dispatched: {launches}, {prov.items} items")
    check(res.final_flags.codes() == mem_rows[2][0]
          and spec.ledger.commit_hash == mem_rows[2][2][2],
          "spec-filled block 2: flags or commit hash != phase 6's")
    phase("classic", spec_fill=filled, fill_launches={
        k: fill_launches[k] for k in kp}, block=2,
        cache_hits=cached()["hits"] - c0["hits"],
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
    c0 = cached()
    (res, _, _), launches = run(lambda: commit_one(spec, raws[3]))
    rej = {k: cached()[k] - c0[k] for k in ("mac", "stale")}
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
    c0 = cached()
    (res, _, _), launches = run(lambda: commit_one(bump, raws[3]))
    stale = cached()["stale"] - c0["stale"]
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
    for _ in range(CLASSIC_TIMED_TRIALS):
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
        phase("classic", block=2, stack=name, warm=True,
              trials=CLASSIC_TIMED_TRIALS,
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

def pipeline_stream(committer, raws, rows: bool = False, counted=None,
                    root: str = None):
    """The blocks through a PipelinedCommitter over `committer` (whose
    ledger has a commit window): every block submitted, then every
    future awaited -> ([(result, metadata flag bytes, (state rows,
    history rows, commit hash) after the block when `rows` else None,
    {kernel: launches during its submit} when `counted` else None)],
    wall seconds of the submits and waits).  The blocks are parsed
    before the clock starts; with `rows` a commit listener reads each
    block's rows on the retire thread right after its commit; with
    `root` each submit runs under a root span of that name (as a
    deliver loop opens one), so the admit's spans are recorded."""
    import contextlib
    from fabric_tpu_torch.committer import PipelinedCommitter
    from fabric_tpu_torch.ops_plane import tracing
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
            with (tracing.tracer.start_span(root) if root
                  else contextlib.nullcontext()):
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


def sched_row(sched) -> dict:
    """The wavefront scheduler's own counts: fallbacks, the pool it
    provisioned, the last block's graph and the rolling widths."""
    return {"serial_fallbacks": sched.serial_fallbacks,
            "max_workers": sched.max_workers, "workers": sched._pool_size,
            "last_waves": sched.last_waves, "last_edges": sched.last_edges,
            "last_max_width": sched.last_max_width,
            "widths": list(sched._widths)}


def spy_graphs(sched) -> list:
    """[(waves, edges)] of each block the scheduler validates on its
    wave path, filled as it goes."""
    real, log = sched.validate_and_prepare_batch, []

    def validate(db, num, envelopes, flags):
        fb = sched.serial_fallbacks
        out = real(db, num, envelopes, flags)
        if sched.serial_fallbacks == fb:
            log.append((sched.last_waves, sched.last_edges))
        return out

    sched.validate_and_prepare_batch = validate
    return log


def ops_scheduler(m0: dict, m1: dict, sched, graphs: list) -> dict:
    """Phase 13's read of the wavefront scheduler's series, held to the
    scheduler's own counts: commit_graph_waves_total, the wave-width
    observations and the in-block edges by kind sum to its blocks'
    waves and edges; commit_serial_fallbacks_total to its fallbacks;
    commit_workers_effective is its pool."""
    from fabric_tpu_torch.committer.parallel_commit.graph import EDGE_KINDS
    waves = sum(w for w, _e in graphs)
    edges = sum(e for _w, e in graphs)
    got_waves = moved_by(m0, m1, "commit_graph_waves_total", channel="ch")
    got_widths = moved_by(m0, m1, "commit_graph_wave_width_count",
                          channel="ch")
    got_edges = {k: moved_by(m0, m1, "commit_graph_edges_total", kind=k,
                             channel="ch") for k in EDGE_KINDS}
    fallbacks = sum(v - m0.get("commit_serial_fallbacks_total", {}).get(
        k, 0.0) for k, v in m1.get("commit_serial_fallbacks_total",
                                   {}).items() if ("channel", "ch") in k)
    workers = m1.get("commit_workers_effective", {}).get(
        (("channel", "ch"),), 0.0)
    check(got_waves == got_widths == waves,
          f"window ops: commit_graph_waves_total {got_waves}, wave widths "
          f"{got_widths}, the scheduler's waves {waves}")
    check(sum(got_edges.values()) == edges,
          f"window ops: commit_graph_edges_total {got_edges} != the "
          f"scheduler's {edges} edges")
    check(fallbacks == sched.serial_fallbacks,
          f"window ops: commit_serial_fallbacks_total {fallbacks} != "
          f"{sched.serial_fallbacks}")
    check(workers == sched._pool_size,
          f"window ops: commit_workers_effective {workers} != the pool's "
          f"{sched._pool_size}")
    return {"waves": int(waves), "edges": {k: int(v) for k, v in
                                           got_edges.items() if v},
            "serial_fallbacks": int(fallbacks), "workers": int(workers)}


def spy_xblock(ledger) -> list:
    """[each admitted block's cross-block edge counts by kind], filled as
    the window admits."""
    win, log = ledger._commit_window, []
    real = win.admit

    def admit(*a, **k):
        e = real(*a, **k)
        log.append(dict(e.graph.xblock_counts))
        return e

    win.admit = admit
    return log


def ops_window(m0: dict, m1: dict, window, admits: list, spans: list,
               xblock: list, W: int) -> dict:
    """Phase 13's read of a windowed run's series and admit spans, held
    to the run's own CommitWindow: one mvcc.window.admit span a block
    with the block's early and deferred txs (the admit log's),
    commit_window_admitted_total and commit_window_txs_total by timing
    equal the window's counts, the cross-block edges by kind the admits'
    graphs', the depth gauge within 1..W, the overlap fraction in
    [0, 1]."""
    from fabric_tpu_torch.committer.parallel_commit.graph import XBLOCK_KINDS
    st = window.stats()
    got = sorted((a["block"], a["early"], a["deferred"]) for a in spans)
    want = sorted((num, e, d) for num, e, d, _ms in admits)
    check(got == want and len(got) == st["admitted"],
          f"window ops: admit spans {got} != the admits {want}")
    admitted = moved_by(m0, m1, "commit_window_admitted_total",
                        channel="ch")
    early = moved_by(m0, m1, "commit_window_txs_total", timing="early",
                     channel="ch")
    deferred = moved_by(m0, m1, "commit_window_txs_total",
                        timing="deferred", channel="ch")
    check((admitted, early, deferred) == (st["admitted"], st["early_txs"],
                                          st["deferred_txs"]),
          f"window ops: admitted/early/deferred {admitted}/{early}/"
          f"{deferred} != the window's {st}")
    xb = {k: moved_by(m0, m1, "commit_graph_edges_total", kind=k,
                      channel="ch") for k in XBLOCK_KINDS}
    want_xb = {k: sum(x[k] for x in xblock) for k in XBLOCK_KINDS}
    check(xb == want_xb, f"window ops: cross-block edges {xb} != the "
          f"admits' {want_xb}")
    depth = m1.get("commit_window_depth", {}).get((("channel", "ch"),))
    frac = m1.get("commit_window_overlap_frac", {}).get(
        (("channel", "ch"),))
    check(depth is not None and 1 <= depth <= W and 0 <= frac <= 1,
          f"window ops: commit_window_depth {depth}, overlap_frac {frac}")
    return {"admit_spans": len(spans), "admitted": int(admitted),
            "early": int(early), "deferred": int(deferred),
            "xblock_edges": {k: int(v) for k, v in xb.items() if v},
            "depth": int(depth), "overlap_frac": round(frac, 4)}


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
    from fabric_tpu_torch.ops_plane import registry
    times = {cell: [] for cell in cells}
    stages = {cell: [] for cell in cells}
    admits, overlap, kept, serial_kp = {}, {}, {}, {}
    m0 = parse_metrics(registry.expose_text())
    for trial in range(WINDOW_MEMORY_TRIALS):
        for ledger, W in cells:
            if ledger == "durable" and trial >= WINDOW_DURABLE_TRIALS:
                continue
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
    m1 = parse_metrics(registry.expose_text())
    # the KV7 stacks' demotions over (c)'s runs, read from the ops plane:
    # `savepoint` (a predecessor still in flight) depends on the runs'
    # timing, so (c)'s KV7 launches do too
    phase("window", timed_runs_kv7_demotions={
        dict(k)["reason"]: int(v - m0.get(
            "validator_device_demotions_total", {}).get(k, 0.0))
        for k, v in m1.get("validator_device_demotions_total", {}).items()
        if ("channel", "ch") in k and v > m0.get(
            "validator_device_demotions_total", {}).get(k, 0.0)})
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
    sched = c.ledger._commit_scheduler
    graphs = spy_graphs(sched)
    m0 = parse_metrics(registry.expose_text())
    out, secs = run(lambda: serial_stream(c, raws, counted, rows=True))
    serial_kp[False] = [{k: n[k] for k in kp} for *_x, n in out]
    differ = hold_to_phase6("serial, parallel_commit", out, mem_rows, doomed)
    phase("window", run="serial, parallel_commit, early abort",
          vs_phase6="equal (flags but doomed, metadata, state, history, "
          "commit hash)", doomed=[len(doomed.get(i, {}))
                                  for i in range(len(raws))],
          doomed_codes_differ=differ, stream_s=round(secs, 4),
          **sched_row(sched), ops=ops_scheduler(
              m0, parse_metrics(registry.expose_text()), sched, graphs))
    ops_read = False
    for W, parallel, kv7_on in WINDOW_RUNS:
        name = (f"W={W} {'parallel' if parallel else 'serial MVCC'}"
                f" {'kv7' if kv7_on else 'host'}")
        c, dv = commit_stack(
            provider, orgs, kv7_on, dev, early_abort=True, commit_window=W,
            parallel_commit=parallel, commit_workers=WINDOW_WORKERS)
        doomed = spy_doomed(c)
        log = spy_admits(c.ledger)
        ops = None
        if W == 4 and not ops_read:
            # the ops plane's read of the first W=4 run: its series and
            # admit spans against its own window
            ops_read = True
            xblock = spy_xblock(c.ledger)
            m0 = parse_metrics(registry.expose_text())
            with Traced() as tracer:
                out, secs = run(lambda: pipeline_stream(
                    c, raws, True, counted, root="pipeline.submit"))
                spans = [s["attributes"] for r in
                         tracer.recorder.list()["recent"]
                         for s in tracer.recorder.get(r["trace_id"])["spans"]
                         if s["name"] == "mvcc.window.admit"]
            ops = ops_window(m0, parse_metrics(registry.expose_text()),
                             c.ledger._commit_window, log, spans, xblock, W)
        else:
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
            row["scheduler"] = sched_row(c.ledger._commit_scheduler)
        if ops is not None:
            row["ops"] = ops
        st = c.ledger._commit_window.stats()
        row["window"] = {k: st[k] for k in (
            "admitted", "retired", "early_txs", "deferred_txs",
            "overlap_frac")}
        phase("window", vs_phase6="equal (flags but doomed, metadata, "
              "state, history, commit hash)", **row)
    check(ops_read, "window: no W=4 run read the ops plane")
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


def experiments_phase(torch, dev, trials: int) -> dict:
    """Each experiments module's run() at the reference's B (a
    card-filling B = SMs x 2,048 is left out for the time limit, PERF.md
    §4); every check raises inside run().  -> {(module, B): result}."""
    from fabric_tpu_torch import experiments as X
    from fabric_tpu_torch.experiments import (proto_ilp, proto_pallas,
                                              proto_pallas2, proto_pallas3,
                                              proto_pallas4, proto_planes)
    out = {}
    for B in (X.REF_B,):
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


# ---------------------------------------------------------------------------
# the peer's block intake (phase 14): the orderer's deliver stream over the
# authenticated RPC plane, the orderer signatures, gossip and the privdata
# coordinator in front of the committer
# ---------------------------------------------------------------------------

INTAKE_TAMPERED = 3            # served once with a corrupted signature
INTAKE_WAIT_S = 300.0          # bound on one wait for peer 2's gossip
INTAKE_WARM = 1                # warm runs of phase 14, held (the
#                                script's time limit)
AEAD_PROBE_BYTES = 8 << 20     # the AEAD rate's buffer


class _OneChannel:
    """The orderer stand-in's registrar: one channel over the block
    writer's store, as `orderer.deliver.DeliverHandler` reads it (`get`,
    `authorize_read`, `ledger`, `wait_for_height`; no Readers policy).
    `tamper`: a block number served once with a corrupted orderer
    signature."""

    def __init__(self, store):
        self.ledger = self
        self.store = store
        self.tamper = None

    @property
    def height(self) -> int:
        return self.store.height

    def get(self, channel_id):
        return self if channel_id == "ch" else None

    def authorize_read(self, signed) -> None:
        pass

    def wait_for_height(self, height: int, timeout_s=None) -> bool:
        return self.store.height >= height

    def get_by_number(self, num: int):
        block = self.store.get_by_number(num)
        if num == self.tamper:
            self.tamper = None
            return tampered_block(block)
        return block


def tampered_block(block):
    """A copy of `block` whose orderer signature has its last byte
    flipped."""
    from fabric_tpu_torch.protocol.types import (META_SIGNATURES, Block,
                                                 BlockMetadata)
    entry = dict(block.metadata.items[META_SIGNATURES][0])
    sig = bytearray(entry["signature"])
    sig[-1] ^= 0x01
    entry["signature"] = bytes(sig)
    items = dict(block.metadata.items)
    items[META_SIGNATURES] = [entry]
    return Block(block.header, list(block.data), BlockMetadata(items))


def intake_orderer(raws, signer, msps):
    """The orderer stand-in: the port's BlockWriter writes and signs the
    stream's blocks into a block store (their headers are the stream's),
    and the port's RpcServer serves `deliver` through the port's
    DeliverHandler over a one-channel registrar, as the reference
    orderer's `_rpc_deliver` does (no attestations) -> (server,
    registrar, store)."""
    from fabric_tpu_torch.comm.rpc import RpcServer
    from fabric_tpu_torch.ledger.blkstorage import BlockStore
    from fabric_tpu_torch.orderer import BlockWriter, DeliverHandler, SeekInfo
    from fabric_tpu_torch.protocol import wire
    store = BlockStore()
    writer = BlockWriter("ch", store, signer=signer)
    for raw in raws:
        block = wire.parse_block(raw)
        written = writer.write_block(writer.create_next_block(block.data))
        check(written.header == wire.parse_block(raw).header,
              "intake: the orderer's header != the stream's")
    registrar = _OneChannel(store)
    handler = DeliverHandler(registrar)

    def rpc_deliver(body, peer_identity):
        seek = SeekInfo(start=body.get("start", 0), stop=body.get("stop"),
                        behavior=body.get("behavior", "block_until_ready"))
        for block in handler.deliver(body["channel"], seek, None,
                                     timeout_s=body.get("timeout_s", 30)):
            yield {"block": block.serialize()}

    srv = RpcServer("127.0.0.1", 0, signer, msps)
    srv.serve_stream("deliver", rpc_deliver)
    return srv.start(), registrar, store


class _ByCause:
    """A provider in front of `inner` for one cause: each batch's KP3,
    KP2, KE6 and KE5 launches (the kernels' own counts, read before and
    after its enqueue, where the CUDA provider launches) are added to
    `tally["<cause>.kp3"]`, `".kp2"`, `".ke6"` and `".ke5"`.  Every
    facade of a run shares one lock over its enqueue, so launches of
    concurrent peers are told apart.
    `cause` None (the factory's default, which identities verify
    through) names each batch by its caller on the stack: `comm/secure.py`
    `_verify_peer` ("handshake"), `gossip/mcs.py` `verify_peer_msg`
    ("alive"), `endorser/endorser.py` `_validate` (a proposal's creator,
    "proposal"), `byzantine/monitor.py` `verify_fraud_proof_strict` and
    `verify_pardon_strict` (a received proof's or pardon's signatures,
    "fraud_proof"), else "other"; a caller entry whose name is None
    matches any function of its file (phase 16 sets `CALLERS` to
    NODE_CALLERS on its facade).  Anything else is the provider's."""

    CALLERS = (("_verify_peer", os.path.join("comm", "secure.py"),
                "handshake"),
               ("verify_peer_msg", os.path.join("gossip", "mcs.py"),
                "alive"),
               ("_validate", os.path.join("endorser", "endorser.py"),
                "proposal"),
               ("verify_fraud_proof_strict",
                os.path.join("byzantine", "monitor.py"), "fraud_proof"),
               ("verify_pardon_strict",
                os.path.join("byzantine", "monitor.py"), "fraud_proof"))
    KERNELS = (("kp3", "p256_fixed", "p256_verify_rows"),
               ("kp2", "p256", "p256_verify"),
               ("ke6", "ed25519", "ed25519_verify_rows"),
               ("ke5", "ed25519", "ed25519_verify"))

    def __init__(self, inner, cause, tally, lock):
        self.inner, self.cause = inner, cause
        self.tally, self.lock = tally, lock

    def _caller(self) -> str:
        f = sys._getframe(2)
        while f is not None:
            for name, path, cause in self.CALLERS:
                if ((name is None or f.f_code.co_name == name)
                        and f.f_code.co_filename.endswith(path)):
                    return cause
            f = f.f_back
        return "other"

    def batch_verify_async(self, items):
        import importlib
        fns = [getattr(importlib.import_module(f"fabric_tpu_torch.ops.{m}"),
                       f) for _k, m, f in self.KERNELS]
        cause = self.cause or self._caller()
        with self.lock:
            n0 = [f.launches for f in fns]
            resolve = self.inner.batch_verify_async(items)
            for (kern, _m, _f), f, a in zip(self.KERNELS, fns, n0):
                key = f"{cause}.{kern}"
                self.tally[key] = self.tally.get(key, 0) + f.launches - a
        return resolve

    def batch_verify(self, items):
        return self.batch_verify_async(items)()

    def verify(self, item) -> bool:
        return bool(self.batch_verify([item])[0])

    def __getattr__(self, name):
        return getattr(self.inner, name)


def intake_peer(name, provider, signer, msps, dev, mcs_provider=None):
    """One peer's intake, as `PeerChannel` wires it: its RpcServer and
    SecureGossipTransport under a ChannelMux, the MCS on `mcs_provider`
    (default `provider`), the privdata Coordinator over the default
    peer's committer on `provider` (classic tail: key-level endorsement
    from the ledger's state, VerdictCache(65536)) on KVLedger (in memory,
    8 state shards) -> a namespace; its GossipNode is made by
    `intake_node`."""
    import types
    from fabric_tpu_torch.comm.rpc import RpcServer
    from fabric_tpu_torch.gossip.comm import ChannelMux, SecureGossipTransport
    from fabric_tpu_torch.gossip.mcs import MessageCryptoService
    from fabric_tpu_torch.privdata import (CollectionRegistry, Coordinator,
                                           PvtDataStore, TransientStore)
    from fabric_tpu_torch.verify_plane import VerdictCache
    committer, _ = commit_stack(provider, None, False, dev, msps=msps,
                                classic=True,
                                cache=VerdictCache(CACHE_CAPACITY,
                                                   owner=name))
    rpc = RpcServer("127.0.0.1", 0, signer, msps).start()
    transport = SecureGossipTransport(rpc, signer, msps)
    return types.SimpleNamespace(
        name=name, signer=signer, msps=msps, rpc=rpc,
        transport=transport, mux=ChannelMux(transport, "ch"),
        mcs=MessageCryptoService(msps, mcs_provider or provider),
        committer=committer, ledger=committer.ledger,
        coordinator=Coordinator(committer, CollectionRegistry(),
                                TransientStore(), PvtDataStore(),
                                mspid=signer.mspid),
        node=None, results={}, committed=None)


def intake_node(peer, other, deliver=None, hold=None):
    """`peer`'s GossipNode (bootstrapped to `other`, window 1), and its
    committer's results recorded by block number.  `hold`: an Event the
    commit waits for (outside the `committer.store_block` span), so the
    caller can keep this peer's commit from overlapping another's."""
    from fabric_tpu_torch.gossip.node import GossipNode
    import threading
    peer.node = GossipNode(
        peer.mux.register_for("ch"), peer.transport.id, peer.coordinator,
        mcs=peer.mcs, signer=peer.signer, deliver_handler=deliver,
        bootstrap=[other.transport.id], msps=peer.msps, window=1)
    peer.committed = threading.Condition()
    inner = peer.committer.store_block

    def store_block(block):
        if hold is not None:
            check(hold.wait(INTAKE_WAIT_S), f"intake: {peer.name}'s commit "
                  "was held too long")
        res = inner(block)
        with peer.committed:
            peer.results[block.header.number] = res
            peer.committed.notify_all()
        return res
    peer.committer.store_block = store_block


def wait_height(peer, height: int, what: str) -> None:
    """Wait (at most INTAKE_WAIT_S) for `peer` to commit up to
    `height`."""
    with peer.committed:
        # the result is recorded after the ledger's height moves: wait
        # for the result, not the height
        ok = peer.committed.wait_for(lambda: height - 1 in peer.results,
                                     timeout=INTAKE_WAIT_S)
    check(ok, f"intake: {peer.name} did not reach height {height} ({what})")


def check_block_rows(peer, num: int, mem_rows) -> None:
    from fabric_tpu_torch.protocol.types import META_TXFLAGS
    codes, meta, rows = mem_rows[num]
    res = peer.results[num]
    stored = peer.ledger.blockstore.get_by_number(num)
    check(res.final_flags.codes() == codes,
          f"intake {peer.name} block {num}: flags != phase 6's")
    check(bytes(stored.metadata.items[META_TXFLAGS]) == meta,
          f"intake {peer.name} block {num}: metadata flags != phase 6's")
    check((*ledger_rows(peer.ledger), peer.ledger.commit_hash) == rows,
          f"intake {peer.name} block {num}: state, history or commit hash "
          "!= phase 6's")


def transport_rates() -> dict:
    """MB/s of the secure channel's AEAD on this host, in the mode it
    runs (ChaCha20-Poly1305 with `cryptography`, else the lite hashlib
    AEAD) and in the lite mode, and of its frame receive loop
    (`comm/secure.py` `_read_frame` over a local socket pair, the
    writer on a thread of its own), on AEAD_PROBE_BYTES each."""
    import socket
    import threading
    from fabric_tpu_torch.comm import secure
    from fabric_tpu_torch.crypto import aead
    data = os.urandom(AEAD_PROBE_BYTES)
    mb = AEAD_PROBE_BYTES / 1e6
    out = {"aead": "chacha20-poly1305" if aead._HAVE_CHACHA else "lite"}
    have = aead._HAVE_CHACHA
    modes = (("", have), ("lite_", False)) if have else (("", False),)
    try:
        for prefix, chacha in modes:
            aead._HAVE_CHACHA = chacha
            a = aead.Aead(b"\x07" * 32)
            t0 = time.perf_counter()
            ct = a.encrypt(b"\x00" * 12, data)
            t1 = time.perf_counter()
            check(a.decrypt(b"\x00" * 12, ct) == data,
                  "intake: AEAD round trip")
            t2 = time.perf_counter()
            out[prefix + "aead_encrypt_mb_s"] = round(mb / (t1 - t0), 3)
            out[prefix + "aead_decrypt_mb_s"] = round(mb / (t2 - t1), 3)
    finally:
        aead._HAVE_CHACHA = have
    for n in (AEAD_PROBE_BYTES, 4 * AEAD_PROBE_BYTES):
        a, b = socket.socketpair()
        try:
            blob = os.urandom(n)
            w = threading.Thread(target=secure._write_frame, args=(a, blob))
            t0 = time.perf_counter()
            w.start()
            got = secure._read_frame(b)
            secs = time.perf_counter() - t0
            w.join()
        finally:
            a.close()
            b.close()
        check(got == blob, "intake: frame round trip")
        out[f"read_frame_{n >> 20}mib_mb_s"] = round(n / 1e6 / secs, 3)
    return out


INTAKE_ROW = ("connect_ms", "deliver_ms", "verify_ms", "gossip_ms",
              "commit_ms", "peer2_mcs_ms", "peer2_commit_ms",
              "peer2_lag_ms")


def new_trace(tracer, root: str, seen: set, done) -> list:
    """The spans of the one trace under `root` not in `seen` once
    `done(spans)` holds (its late fragments, another peer's server spans,
    merged in) -> spans; its id joins `seen`.  Waits at most
    INTAKE_WAIT_S."""
    deadline = time.perf_counter() + INTAKE_WAIT_S
    while True:
        for rec in tracer.recorder.list()["recent"]:
            if rec["root"] != root or rec["trace_id"] in seen:
                continue
            spans = list(tracer.recorder.get(rec["trace_id"])["spans"])
            if done(spans):
                seen.add(rec["trace_id"])
                return spans
        check(time.perf_counter() < deadline,
              f"intake: no complete {root} trace")
        time.sleep(0.005)


def _peer2_cast(spans, by_id):
    """Peer 2's `committer.store_block` and the `rpc.gossip.msg` cast it
    ran under, or (None, None) until both are in `spans`."""
    for s in spans:
        if s["name"] != "committer.store_block":
            continue
        parent = by_id.get(s["parent_id"])
        if parent is not None and parent["name"] == "rpc.gossip.msg":
            return s, parent
    return None, None


def _pull_done(spans) -> bool:
    by_id = {s["span_id"]: s for s in spans}
    return (sum(s["name"] == "committer.store_block" for s in spans) == 2
            and _peer2_cast(spans, by_id)[0] is not None)


def intake_row(spans):
    """One pull's layer times from its trace (the tracer's own spans):
    `gossip.pull_window` the root; `rpc.deliver` (the orderer's side,
    begun once the connection's handshake and the request are done);
    `gossip.verify_window` (peer 1's MCS on the orderer signature);
    peer 1's `committer.store_block`; peer 2's `rpc.gossip.msg` cast with
    its MCS `bccsp.batch_verify` and its `committer.store_block` -> (ms:
    connect (the pull's start to the orderer's span), deliver (to the
    verify: serve, send, receive, decrypt, parse), verify, gossip
    (`add_block` less the commit: the block serialised, encrypted and
    sent to peer 2), commit, peer 2's MCS and commit, and the lag of
    peer 2's commit's end behind peer 1's; {peer: its commit's end, on
    the perf_counter clock})."""
    by_id = {s["span_id"]: s for s in spans}

    def one(name, pred=lambda s: True):
        got = [s for s in spans if s["name"] == name and pred(s)]
        check(len(got) == 1, f"intake: {len(got)} {name} spans in a pull")
        return got[0]

    def end(s):
        return s["start"] + s["duration_s"]

    c2, cast = _peer2_cast(spans, by_id)
    root = one("gossip.pull_window")
    verify = one("gossip.verify_window")
    serve = one("rpc.deliver")
    c1 = one("committer.store_block", lambda s: s is not c2)
    mcs2 = one("bccsp.batch_verify",
               lambda s: s["parent_id"] == cast["span_id"])
    ms = {"connect_ms": serve["start"] - root["start"],
          "deliver_ms": verify["start"] - serve["start"],
          "verify_ms": verify["duration_s"],
          "gossip_ms": end(root) - end(verify) - c1["duration_s"],
          "commit_ms": c1["duration_s"],
          "peer2_mcs_ms": mcs2["duration_s"],
          "peer2_commit_ms": c2["duration_s"],
          "peer2_lag_ms": end(c2) - end(c1)}
    return ({k: round(v * 1e3, 3) for k, v in ms.items()},
            {"peer1": end(c1), "peer2": end(c2)})


def intake_run(torch, ctx, run: str, held: bool = False,
               cold: bool = False) -> dict:
    """The stream through two fresh peers (ledgers at height 0), one
    block a pull, the tracer on, both peers checked against phase 6's
    rows after every block.  `held`: peer 2's commit of a block waits
    until peer 1's pull of it has returned, so the two commits never
    overlap (peer 2's parse and MCS still may).  `cold`: the first run,
    with the drills, block 2's pull profiled, and every provider of the
    run behind a `_ByCause` facade -> {"rows": per block from its trace
    (`intake_row`), "walls": ms from the first pull's start to each
    peer's commit of the last block, less the drills and the time from a
    block's last commit to the next pull (checks, trace reads),
    "profiled": device_busy's (busy, wall, top) of block 2's pull or
    None, "causes": the cold run's launches by cause or None}."""
    import threading
    from fabric_tpu_torch.bccsp import factory
    from fabric_tpu_torch.comm import rpc as rpcmod
    from fabric_tpu_torch.gossip.state import MSG_BLOCK
    from fabric_tpu_torch.msp import CachedMSP
    from fabric_tpu_torch.msp.ca import DevOrg
    from fabric_tpu_torch.node.peer import RemoteDeliver
    c = ctx
    msps, store, registrar = c["msps"], c["store"], c["registrar"]
    provider, mem_rows = c["provider"], c["mem_rows"]
    tally, default = None, factory.get_default()
    # (committer's provider, MCS's provider) a peer
    provs = {"peer1": (provider, provider), "peer2": (provider, provider)}
    if cold:
        tally, lock = {}, threading.Lock()
        factory.set_default(_ByCause(provider, None, tally, lock))
        provs = {"peer1": (_ByCause(provider, "commit_peer1", tally, lock),
                           _ByCause(provider, "orderer_sig", tally, lock)),
                 "peer2": (_ByCause(provider, "commit_peer2", tally, lock),
                           _ByCause(provider, "gossip_mcs", tally, lock))}
    hold = threading.Event() if held else None
    rows, walls, profiled, peers = [], {}, None, []
    try:
        p1 = intake_peer("peer1", provs["peer1"][0], c["signers"][0], msps,
                         c["dev"], mcs_provider=provs["peer1"][1])
        peers.append(p1)
        p2 = intake_peer("peer2", provs["peer2"][0], c["signers"][1], msps,
                         c["dev"], mcs_provider=provs["peer2"][1])
        peers.append(p2)
        intake_node(p1, p2, RemoteDeliver([c["orderer"].addr], p1.signer,
                                          msps))
        intake_node(p2, p1, hold=hold)
        # membership: each peer's signed alive reaches the other
        for _ in range(3):
            for p in (p1, p2):
                p.node.discovery.tick()
            for p, q in ((p1, p2), (p2, p1)):
                deadline = time.perf_counter() + 30.0
                while (not p.node.discovery.is_alive(q.transport.id)
                       and time.perf_counter() < deadline):
                    time.sleep(0.01)
        check(p1.node.discovery.alive_ids() == [p2.transport.id]
              and p2.node.discovery.alive_ids() == [p1.transport.id],
              "intake: membership did not form")
        excluded_s, seen = 0.0, set()
        with Traced() as tracer:
            t_first = time.perf_counter()
            for num in range(len(c["raws"])):
                if cold and num == INTAKE_TAMPERED:
                    d0 = time.perf_counter()
                    # a tampered copy gossiped to peer 2 under a trace of
                    # its own, complete once peer 2's handler returned
                    with tracer.start_span("intake.drill"):
                        p1.node.endpoint.send(p2.transport.id, MSG_BLOCK, {
                            "block": tampered_block(store.get_by_number(
                                num)).serialize()})
                    drill = new_trace(tracer, "intake.drill", seen,
                                      lambda sp: any(
                                          x["name"] == "rpc.gossip.msg"
                                          for x in sp))
                    check(any(x["name"] == "bccsp.batch_verify"
                              for x in drill)
                          and p2.ledger.height == num
                          and p2.node.state.buffered == [],
                          "intake: peer 2's MCS took a tampered block")
                    # then the orderer's tampered copy to peer 1
                    registrar.tamper = num
                    got = p1.node.provider.pull_window()
                    check(got == 0 and p1.ledger.height == num
                          and p1.node.state.buffered == [],
                          "intake: a block with a corrupted orderer "
                          "signature was not dropped")
                    excluded_s += time.perf_counter() - d0
                    phase("intake", run=run, drill=f"tampered block {num}: "
                          "dropped by peer 1's deliver check, refused by "
                          "peer 2's gossip MCS")

                def pull():
                    check(p1.node.provider.pull_window() == 1,
                          f"intake: block {num} was not accepted")
                excluded_before = excluded_s
                if cold and num == 2:
                    (profiled,) = device_busy(
                        torch, {f"peer1 block {num}": pull}).values()
                else:
                    pull()
                if hold is not None:
                    hold.set()
                for p in (p1, p2):
                    wait_height(p, num + 1, f"{run} block {num}")
                row, ends = intake_row(new_trace(
                    tracer, "gossip.pull_window", seen, _pull_done))
                if hold is not None:
                    hold.clear()
                walls = {k: round((v - excluded_before - t_first) * 1e3, 3)
                         for k, v in ends.items()}
                for p in (p1, p2):
                    check_block_rows(p, num, mem_rows)
                excluded_s += time.perf_counter() - max(ends.values())
                row = {"block": num, "txs": len(mem_rows[num][0]),
                       "bytes": c["sizes"][num], **row}
                rows.append(row)
                phase("intake", run=run, **row)
        if cold:
            # a rogue org's client is refused at peer 1's handshake
            evil = DevOrg("Evil")
            rogue = rpcmod.connect(
                p1.rpc.addr, evil.new_identity("rogue"),
                {**msps, "Evil": CachedMSP(evil.msp())}, timeout=30.0)
            try:
                rogue.call("gossip.status", {}, timeout=30.0)
                check(False, "intake: a rogue-org client was served")
            except rpcmod.RpcClosed:
                pass                   # refused: the server hung up
            finally:
                rogue.close()
            phase("intake", run=run, drill="rogue-org client refused at "
                  "peer 1's handshake")
    finally:
        factory.set_default(default)
        for p in peers:
            p.transport.close()
            p.rpc.stop()
    return {"rows": rows, "walls": walls, "profiled": profiled,
            "causes": tally}


def intake_phase(torch, args, provider, orgs, raws, mem_rows, fns,
                 name_power, dev) -> dict:
    """Phase 14.  The peer's block intake on the card.  `provider` is the
    factory's default, the CUDA provider (fail-stop: a failed launch
    raises and fails the phase).  An orderer stand-in (the port's
    RpcServer, DeliverHandler and BlockWriter, an orderer org's identity)
    holds phase 6's stream; peer 1 pulls it through `RemoteDeliver` (the
    GossipNode's BlocksProvider, one block a pull), checks each block's
    orderer signature through its MCS and hands it to gossip and its
    Coordinator; peer 2 gets the blocks only by gossip, each checked by
    its MCS.  After every block both peers' flags, metadata flags, state,
    history and commit hash equal phase 6's (`mem_rows`).  The cold run
    holds the drills (block INTAKE_TAMPERED first served with a
    corrupted orderer signature: dropped, then the good one commits; a
    tampered copy gossiped to peer 2: refused by its MCS; a rogue-org
    client refused at peer 1's handshake), block 2's profile and the
    launches by cause; its two peers commit at once.  Then, unless the
    AEAD is the lite one (its bytes make a run ~100 s), INTAKE_WARM warm
    runs with peer 2's commit held until peer 1's is done, so each peer's
    commit is timed alone, as a peer in a process of its own commits.
    Layer times come from each pull's trace.  -> {kernel: launches} of
    the phase (every count set to 0 just before it, read just after)."""
    from fabric_tpu_torch.bccsp import factory
    from fabric_tpu_torch.bccsp.cuda import CudaProvider
    from fabric_tpu_torch.comm import secure
    from fabric_tpu_torch.msp import CachedMSP
    from fabric_tpu_torch.msp.ca import DevOrg
    t_phase = time.perf_counter()
    check(type(provider) is CudaProvider
          and factory.get_default() is provider,
          "intake: the factory's default is not the CUDA provider")
    fb0 = provider.stats["fallbacks"]
    order_org = DevOrg("OrdererOrg")
    msps = {o.mspid: CachedMSP(o.msp()) for o in list(orgs) + [order_org]}
    rates = transport_rates()
    orderer, registrar, store = intake_orderer(
        raws, order_org.new_identity("orderer0"), msps)
    sizes = [len(store.get_by_number(n).serialize())
             for n in range(len(raws))]
    phase("intake", card=name_power, blocks=len(raws), block_bytes=sizes,
          max_frame=secure.MAX_FRAME, **rates)
    check(max(sizes) < secure.MAX_FRAME, "intake: a block exceeds MAX_FRAME")
    lite = rates["aead"] == "lite"
    n_warm = 0 if lite else min(args.trials, INTAKE_WARM)
    ctx = {"msps": msps, "store": store, "registrar": registrar,
           "orderer": orderer, "raws": raws, "sizes": sizes,
           "mem_rows": mem_rows, "dev": dev, "provider": provider,
           "signers": (orgs[0].new_identity("peer1"),
                       orgs[1].new_identity("peer2"))}
    for f in fns.values():
        f.launches = 0
    try:
        cold = intake_run(torch, ctx, "cold", cold=True)
        cold_launches = {n: f.launches for n, f in fns.items()}
        warm = [intake_run(torch, ctx, f"warm{t + 1}-held", held=True)
                for t in range(n_warm)]
        launches = {n: f.launches for n, f in fns.items()}
    finally:
        orderer.stop()
    check_launches("intake", launches, ("p256_verify_rows", "p256_verify"))
    by_cause = cold["causes"]
    for cause in ("handshake", "alive", "orderer_sig", "gossip_mcs",
                  "commit_peer1", "commit_peer2"):
        check(any(k.startswith(cause + ".") and n
                  for k, n in by_cause.items()),
              f"intake: no KP3/KP2 launch for {cause}")
    for kern, name in (("kp3", "p256_verify_rows"), ("kp2", "p256_verify")):
        check(sum(n for k, n in by_cause.items() if k.endswith("." + kern))
              == cold_launches[name],
              f"intake: {kern} launches by cause != its count in the cold "
              "run")
    check(provider.stats["fallbacks"] == fb0 == 0, "intake: fallbacks != 0")
    phase("intake", run="cold", stream="both peers equal to phase 6's host "
          "stack after every block (flags, metadata flags, state, history, "
          "commit hash)", wall_ms_first_pull_to_last_commit=cold["walls"],
          launches_by_cause={k: n for k, n in sorted(by_cause.items())
                             if n})
    if warm:
        for b in range(len(raws)):
            phase("intake", commits="held", warm_median_of=len(warm),
                  block=b, **{k: round(statistics.median(
                      r["rows"][b][k] for r in warm), 3)
                      for k in INTAKE_ROW})
        walls = {k: [r["walls"][k] for r in warm] for k in ("peer1",
                                                              "peer2")}
        phase("intake", commits="held", warm_median_of=len(warm),
              wall_ms_first_pull_to_last_commit={
                  k: round(statistics.median(v), 3)
                  for k, v in walls.items()},
              wall_ms_min_max={k: (min(v), max(v))
                               for k, v in walls.items()})
    else:
        phase("intake", warm="no warm run: the lite AEAD's bytes make a "
              "run ~100 s")
    busy, wall, top = cold["profiled"]
    phase("intake", profiled="peer1 block 2, cold run", wall_ms=round(wall, 3),
          device_busy_ms=round(busy, 3),
          device_idle_share=round(1 - busy / wall, 4), top_device_ops=top,
          note="peer 2's work for block 2 runs in the same process and "
          "counts when it starts inside the window")
    phase("intake", main_path=launches, runs=1 + len(warm),
          provider=provider.name, fallbacks=0, card=name_power,
          seconds=round(time.perf_counter() - t_phase, 1))
    return launches


def intake_only(torch, args) -> int:
    """`--intake-only`: phase 14 alone.  Builds the kernels, the commit
    stream (spawn pool) and, for the reference rows, the stream through
    the host stack on the CUDA provider (phase 6's host stack), then
    runs `intake_phase`; prints no result line."""
    from fabric_tpu_torch import native
    from fabric_tpu_torch.bccsp import FactoryOpts, init_factories
    from fabric_tpu_torch.ops import _build, p256, p256_fixed
    built = _build.build_all(force=True)
    phase("build", libs=sorted(built))
    native.build("der")
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, multiprocessing.cpu_count())) as pool:
        orgs, signers, endorsers, clients = commit_identities()
        env_blocks, labels, _kinds = build_stream(
            args.commit_txs, args.commit_last, signers, endorsers, clients,
            pool)
    raws = chain_blocks(env_blocks)
    del env_blocks
    provider = init_factories(FactoryOpts(default="CUDA"))
    dev = torch.device("cuda")
    host, _ = commit_stack(provider, orgs, False, dev)
    mem_rows = [(r.final_flags.codes(), meta, after) for r, meta, _s, after
                in commit_stream(host, raws, rows=True)]
    check([c for c, _m, _r in mem_rows] == labels,
          "intake-only: host stack flags != labels")
    del host
    fns = {"p256_verify_rows": p256_fixed.p256_verify_rows,
           "p256_verify": p256.p256_verify}
    intake_phase(torch, args, provider, orgs, raws, mem_rows, fns,
                 smi("name,power.limit"), dev)
    phase("done", by_phase={k: round(v, 1) for k, v in _PHASE_S.items()})
    return 0


# ---------------------------------------------------------------------------
# the endorsement side (phase 15): `_lifecycle`, the endorser behind the
# RPC plane, the endorsed blocks' commit under the privdata coordinator,
# qscc / cscc / discovery through the ACL provider, and the byzantine
# plane on gossip
# ---------------------------------------------------------------------------

ENDORSE_ACCOUNTS = 10_000      # seeded in one block of ENDORSE_SEED_TXS
ENDORSE_SEED_TXS = 20          # txs of 500 writes each
ENDORSE_CLIENTS = 8            # a org: Org1 P-256, Org2 Ed25519
# one block of proposals: 500, the channel's default BatchSize
# MaxMessageCount (config/channelconfig.py), the largest block a
# channel cuts by count
ENDORSE_MIX = (("transfer", 450), ("private", 25), ("poor", 10),
               ("bad_sig", 5), ("outsider", 5), ("query", 5))
ENDORSE_SUBMITTED = ("transfer", "private")
ENDORSE_RESPONSES = {"transfer": (200, ""), "private": (200, ""),
                     "query": (200, ""), "poor": (500, "insufficient funds"),
                     "bad_sig": (500, "bad proposal signature"),
                     "outsider": (500, "unknown or invalid creator identity")}
ENDORSE_BALANCE = 1_000
ENDORSE_POLICY = "AND('Org1.member', 'Org2.member')"
ENDORSE_MAJORITY = "OutOf(2, 'Org1.member', 'Org2.member')"
ENDORSE_COLLECTION = "secrets"
ENDORSE_SPANS = ("rpc.endorse", "endorser.validate", "endorser.simulate",
                 "endorser.sign")
ENDORSE_CAUSES = ("handshake", "proposal", "acl", "commit_peer1",
                  "commit_peer2", "scc_acl", "gossip_mcs", "fraud_proof")
ENDORSE_WAIT_S = 120.0         # bound on one wait for a trace's fragments


def endorse_contract():
    """The channel's chaincode `cc`: seed accounts, transfer between two
    (a read and a write of each), get, and a private write into the
    Org1-only collection."""
    from fabric_tpu_torch.chaincode import SimulationError
    from fabric_tpu_torch.chaincode.runtime import FuncContract

    def seed(stub, *pairs):
        for i in range(0, len(pairs), 2):
            stub.put_state(pairs[i].decode(), pairs[i + 1])
        return str(len(pairs) // 2).encode()

    def transfer(stub, frm, to, amt):
        a = int(stub.get_state(frm.decode()) or b"0")
        b = int(stub.get_state(to.decode()) or b"0")
        n = int(amt)
        if a < n:
            raise SimulationError("insufficient funds")
        stub.put_state(frm.decode(), str(a - n).encode())
        stub.put_state(to.decode(), str(b + n).encode())
        return b"ok"

    def get(stub, key):
        v = stub.get_state(key.decode())
        if v is None:
            raise SimulationError("no such key")
        return v

    def put_private(stub, key, value):
        stub.put_private_data(ENDORSE_COLLECTION, key.decode(), value)
        return b"ok"

    return FuncContract(seed=seed, transfer=transfer, get=get,
                        put_private=put_private)


def endorse_ids():
    """Org1 (P-256) and Org2 (Ed25519), each with its endorsing peer,
    admin and ENDORSE_CLIENTS clients; the orderer stand-in's org; a
    client of an org outside the channel."""
    import types
    from fabric_tpu_torch.bccsp import SCHEME_ED25519
    from fabric_tpu_torch.msp import CachedMSP
    from fabric_tpu_torch.msp.ca import DevOrg
    orgs = (DevOrg("Org1"), DevOrg("Org2", scheme=SCHEME_ED25519))
    order_org = DevOrg("OrdererOrg")
    return types.SimpleNamespace(
        orgs=orgs, orderer=order_org.new_identity("orderer0"),
        peers=tuple(o.new_identity(f"peer{i + 1}")
                    for i, o in enumerate(orgs)),
        clients=[orgs[i % 2].new_identity(f"client{i}")
                 for i in range(2 * ENDORSE_CLIENTS)],
        outsider=DevOrg("Org9").new_identity("mallory"),
        msps={o.mspid: CachedMSP(o.msp())
              for o in list(orgs) + [order_org]})


def endorse_source(orgs):
    """The channel's config: the two application orgs, the default
    policies and ACLs."""
    from fabric_tpu_torch import config as C
    return C.BundleSource(C.Bundle(C.ChannelConfig(
        channel_id="ch", sequence=0,
        orgs=tuple(org_config(C, o) for o in orgs),
        policies=C.default_policies([o.mspid for o in orgs]))))


def endorse_peer(name, index, ids, provider, acl_provider, dev):
    """One org's endorsing peer: KVLedger (in memory, 8 state shards),
    the default peer's committer (classic tail, key-level endorsement
    from state) with `LifecyclePolicyProvider` as its policies (the
    channel default and `_lifecycle`'s own: MAJORITY of the two orgs;
    the collection's hashed namespace, which has no `_lifecycle`
    definition, takes ENDORSE_POLICY), the privdata coordinator
    (collection `cc/secrets`, Org1 only), the chaincode registry (`cc`,
    `_lifecycle`), an ACLProvider over the channel's BundleSource on
    `acl_provider`, and the Endorser -> a namespace."""
    import types
    from fabric_tpu_torch.chaincode import (LIFECYCLE_NS, ChaincodeDefinition,
                                            ChaincodeRegistry,
                                            LifecycleContract,
                                            LifecyclePolicyProvider)
    from fabric_tpu_torch.endorser import Endorser
    from fabric_tpu_torch.ledger import KVLedger, LedgerConfig
    from fabric_tpu_torch.policy import ACLProvider, parse_policy
    from fabric_tpu_torch.privdata import (CollectionRegistry, Coordinator,
                                           PvtDataStore, TransientStore)
    from fabric_tpu_torch.privdata.collection import (CollectionConfig,
                                                      pvt_namespace)
    org = ids.orgs[index]
    signer = ids.peers[index]
    msps = {o.mspid: ids.msps[o.mspid] for o in ids.orgs}
    ledger = KVLedger("ch", LedgerConfig(state_shards=8))
    policies = LifecyclePolicyProvider(
        ledger.statedb, default=parse_policy(ENDORSE_MAJORITY))
    policies.set_policy(LIFECYCLE_NS, parse_policy(ENDORSE_MAJORITY))
    policies.set_policy(pvt_namespace("cc", ENDORSE_COLLECTION),
                        parse_policy(ENDORSE_POLICY))
    registry = ChaincodeRegistry()
    registry.install(ChaincodeDefinition("cc", "1.0"), endorse_contract())
    registry.install(ChaincodeDefinition(LIFECYCLE_NS, "1.0"),
                     LifecycleContract([o.mspid for o in ids.orgs]))
    committer, _ = wire_stack(ledger, provider, policies, msps, dev,
                              classic=True)
    collections = CollectionRegistry()
    collections.define("cc", CollectionConfig(ENDORSE_COLLECTION,
                                              member_orgs=("Org1",)))
    transient, pvt = TransientStore(), PvtDataStore()
    source = endorse_source(ids.orgs)
    acl = ACLProvider(source, acl_provider)
    return types.SimpleNamespace(
        name=name, mspid=org.mspid, signer=signer, ledger=ledger,
        policies=policies, committer=committer, transient=transient,
        pvt=pvt, source=source, acl=acl, msps=msps,
        coordinator=Coordinator(committer, collections, transient, pvt,
                                mspid=org.mspid),
        endorser=Endorser("ch", ledger.statedb, registry, msps, provider,
                          signer, transient_store=transient, pvt_store=pvt,
                          ledger_height=lambda: ledger.height, acl=acl),
        rpc=None, commit_ms=[])


def endorse_rows(peer) -> tuple:
    """(state, history, pvt store, transient store size, commit hash,
    height) of a peer."""
    pvt = (sorted(peer.pvt._state.items()), sorted(peer.pvt._by_txid.items()))
    return (*ledger_rows(peer.ledger), pvt, len(peer.transient),
            peer.ledger.commit_hash, peer.ledger.height)


def serve_endorse(peer, msps):
    """`peer`'s Endorser behind its own RpcServer, method `endorse`, as
    the reference peer node's `_rpc_endorse` serves it."""
    from fabric_tpu_torch.comm.rpc import RpcServer
    from fabric_tpu_torch.endorser.proposal import SignedProposal

    def endorse(body, peer_identity):
        resp = peer.endorser.process_proposal(
            SignedProposal(body["proposal"], body["signature"]))
        out = {"status": resp.status, "message": resp.message,
               "payload": resp.payload}
        if resp.endorsement is not None:
            out["endorser"] = resp.endorsement.endorser
            out["endorsement_sig"] = resp.endorsement.signature
        return out
    srv = RpcServer("127.0.0.1", 0, peer.signer, msps)
    srv.serve("endorse", endorse)
    peer.rpc = srv.start()


def rpc_endorse(conn, sp):
    """One proposal through an endorser's RPC -> ProposalResponse."""
    from fabric_tpu_torch.endorser import ProposalResponse
    from fabric_tpu_torch.protocol.types import Endorsement
    out = conn.call("endorse", {"proposal": sp.proposal_bytes,
                                "signature": sp.signature}, timeout=60.0)
    e = (Endorsement(out["endorser"], out["endorsement_sig"])
         if "endorser" in out else None)
    return ProposalResponse(out["status"], out["message"], out["payload"], e)


def endorse_load(ids, seed: int) -> list:
    """The load block's proposals, signed: (kind, client, signed
    proposal, accounts) in a seeded order.  Transfers move 1-9 units
    between two seeded accounts drawn at random (pairs that share an
    account conflict at commit), `poor` ones more than any balance;
    private writes go to the Org1 collection; `bad_sig` has its
    signature's last byte flipped; `outsider` is signed by a client of
    an org outside the channel; `query` reads an account."""
    from fabric_tpu_torch.endorser import signed_proposal
    from fabric_tpu_torch.endorser.proposal import SignedProposal
    rng = random.Random(seed)
    kinds = [k for k, n in ENDORSE_MIX for _ in range(n)]
    rng.shuffle(kinds)
    out = []
    for i, kind in enumerate(kinds):
        client = ids.clients[i % len(ids.clients)]
        a, b = rng.sample(range(ENDORSE_ACCOUNTS), 2)
        acct = (f"acct{a:05d}", f"acct{b:05d}")
        if kind in ("transfer", "poor", "bad_sig", "outsider"):
            amt = (ENDORSE_BALANCE * 1000 if kind == "poor"
                   else rng.randrange(1, 10))
            fn, args = "transfer", [acct[0].encode(), acct[1].encode(),
                                    str(amt).encode()]
        elif kind == "private":
            fn, args = "put_private", [f"secret{i:04d}".encode(),
                                       rng.randbytes(32)]
        else:
            fn, args = "get", [acct[0].encode()]
        signer = ids.outsider if kind == "outsider" else client
        sp = signed_proposal("ch", "cc", fn, args, signer)
        if kind == "bad_sig":
            sig = bytearray(sp.signature)
            sig[-1] ^= 1
            sp = SignedProposal(sp.proposal_bytes, bytes(sig))
        out.append((kind, client, sp, acct if kind == "transfer" else ()))
    return out


def endorse_labels(load) -> list:
    """The load block's expected flags: a transfer is MVCC_READ_CONFLICT
    (11) when an earlier valid tx of the block wrote one of its accounts,
    else VALID; a private write (hashed key, no read) is VALID."""
    written, out = set(), []
    for kind, _c, _sp, acct in load:
        if kind not in ENDORSE_SUBMITTED:
            continue
        if written.intersection(acct):
            out.append(11)
            continue
        written.update(acct)
        out.append(0)
    return out


def forge_sibling(block, signer):
    """A sibling of `block`: the same number and previous hash, one more
    envelope (so another header hash), signed by `signer` the block
    writer's way — two validly signed headers at one height."""
    from fabric_tpu_torch.orderer import block_signed_bytes
    from fabric_tpu_torch.protocol.build import new_nonce
    from fabric_tpu_torch.protocol.types import (META_LAST_CONFIG,
                                                 META_SIGNATURES, Block,
                                                 BlockHeader, BlockMetadata,
                                                 block_data_hash)
    data = [bytes(d) for d in block.data]
    data.append(data[-1])
    forged = Block(BlockHeader(block.header.number,
                               block.header.previous_hash,
                               block_data_hash(data)), data,
                   BlockMetadata({META_LAST_CONFIG: 0}))
    sig_header = {"creator": signer.serialize(), "nonce": new_nonce()}
    forged.metadata.items[META_SIGNATURES] = [{
        "sig_header": sig_header,
        "signature": signer.sign(block_signed_bytes(forged, sig_header, 0))}]
    return forged


def pct(vals, q: float) -> float:
    """The q-quantile of `vals` (nearest rank), unrounded."""
    s = sorted(vals)
    return s[min(len(s) - 1, max(0, int(round(q * len(s) + 0.5)) - 1))]


def endorse_phase(torch, args, provider, fns, name_power, dev) -> dict:
    """Phase 15.  The endorsement side on the card, on the factory's
    default CUDA provider (fail-stop), the tracer on.  Two endorsing
    peers (Org1 P-256, Org2 Ed25519), each behind its RpcServer, and the
    same two on the port's SoftwareProvider (the plain path) fed the
    same proposals and blocks; an orderer stand-in (the port's
    BlockWriter) signs every block.  (1) `_lifecycle`: both orgs approve
    `cc` (AND of the orgs), Org1 commits it; every peer's
    `policy_for("cc")` the same bytes.  (2) A seed block of
    ENDORSE_SEED_TXS txs creating ENDORSE_ACCOUNTS accounts.  (3) The
    load: ENDORSE_MIX's 500 proposals, each through both endorsers in
    turn, one at a time over the RPC plane (the profiled run); the
    200-status ones assembled into one block, committed by both peers
    through the coordinator (peer 1 takes the private writes' cleartext
    from its transient store, peer 2 keeps hashes).  (4) qscc (chain
    info, every block, every committed tx by id), cscc and discovery
    through the ACL provider.  (5) Each peer's gossip state gets a
    ByzantineMonitor and a ProofGossip; the orderer stand-in signs a
    sibling of the last committed block, gossiped to peer 1, which
    convicts and gossips the fraud proof; peer 2 re-verifies it on the
    card and both quarantine the orderer.  Checks: every response's
    status, message, payload and endorser equal the plain path's, each
    endorsement verifies on SW; flags, metadata flags, state, history,
    pvt store and commit hash equal the plain peers' after every block,
    the load block's flags the mix's labels; qscc equal to the block
    store, every ACL decision equal SW's, discovery's layout {Org1: 1,
    Org2: 1}; the monitor's verdicts; `fallbacks` 0; launches by cause
    (KP2 and KE5 from proposals > 0, the commits' > 0).  -> {kernel:
    launches} of the phase (every count set to 0 just before it, read
    just after)."""
    import shutil
    import threading
    from fabric_tpu_torch.bccsp import factory
    from fabric_tpu_torch.bccsp.cuda import CudaProvider
    from fabric_tpu_torch.bccsp.sw import SoftwareProvider
    from fabric_tpu_torch.comm.rpc import connect
    from fabric_tpu_torch.endorser import (assemble_transaction,
                                           signed_proposal)
    from fabric_tpu_torch.ledger.blkstorage import BlockStore
    from fabric_tpu_torch.msp import deserialize_from_msps
    from fabric_tpu_torch.orderer import BlockWriter
    from fabric_tpu_torch.policy import parse_policy
    from fabric_tpu_torch.protocol import Block
    from fabric_tpu_torch.protocol.types import META_TXFLAGS
    t_phase = time.perf_counter()
    check(type(provider) is CudaProvider
          and factory.get_default() is provider,
          "endorse: the factory's default is not the CUDA provider")
    fb0 = provider.stats["fallbacks"]
    sw = SoftwareProvider()
    ids = endorse_ids()
    tally, lock = {}, threading.Lock()

    def cause(name):
        return _ByCause(provider, name, tally, lock)
    cuda = [endorse_peer(f"peer{i + 1}", i, ids, cause(f"commit_peer{i + 1}"),
                         cause("acl"), dev) for i in range(2)]
    plain = [endorse_peer(f"peer{i + 1}-sw", i, ids, sw, sw, dev)
             for i in range(2)]
    store = BlockStore()
    writer = BlockWriter("ch", store, signer=ids.orderer)
    for f in fns.values():
        f.launches = 0
    factory.set_default(_ByCause(provider, None, tally, lock))
    tmp = os.path.join("build", "endorse")
    shutil.rmtree(tmp, ignore_errors=True)
    conns, times = [], {}
    try:
        for p in cuda:
            serve_endorse(p, ids.msps)
        app = ids.clients[0]
        conns = [connect(p.rpc.addr, app, ids.msps, timeout=30.0)
                 for p in cuda]

        def endorse(sp):
            """`sp` through both CUDA endorsers over RPC, and through the
            plain peers' endorsers, every field held equal."""
            got = [rpc_endorse(c, sp) for c in conns]
            endorse_compare(sp, got)
            return got

        def endorse_compare(sp, got):
            default = factory.get_default()
            factory.set_default(sw)
            try:
                want = [p.endorser.process_proposal(sp) for p in plain]
                for g, w in zip(got, want):
                    check((g.status, g.message, g.payload)
                          == (w.status, w.message, w.payload)
                          and (g.endorsement is None)
                          == (w.endorsement is None),
                          "endorse: a response != the plain path's")
                    if g.endorsement is None:
                        continue
                    check(g.endorsement.endorser == w.endorsement.endorser,
                          "endorse: endorser bytes != the plain path's")
                    ident = deserialize_from_msps(
                        plain[0].msps, g.endorsement.endorser)
                    for e in (g.endorsement, w.endorsement):
                        check(ident.verify(g.payload + e.endorser,
                                           e.signature),
                              "endorse: an endorsement does not verify "
                              "on SW")
                    if ident.mspid == "Org2":
                        check(g.endorsement.signature
                              == w.endorsement.signature,
                              "endorse: Ed25519 endorsement != the plain "
                              "path's")
            finally:
                factory.set_default(default)

        def commit(envs, what):
            """One block of `envs` written and signed by the orderer
            stand-in, committed by the CUDA peers (each timed) and the
            plain peers -> flags; every CUDA peer's flags, metadata flags
            and rows equal its plain twin's."""
            block = writer.write_block(writer.create_next_block(
                [e.serialize() for e in envs]))
            raw = block.serialize()
            flags = []
            for p, q in zip(cuda, plain):
                b = Block.deserialize(raw)
                t0 = time.perf_counter()
                res = p.coordinator.store_block(b)
                p.commit_ms.append((what, (time.perf_counter() - t0) * 1e3))
                bq = Block.deserialize(raw)
                resq = q.coordinator.store_block(bq)
                check(res.final_flags.codes() == resq.final_flags.codes()
                      and bytes(b.metadata.items[META_TXFLAGS])
                      == bytes(bq.metadata.items[META_TXFLAGS])
                      and endorse_rows(p) == endorse_rows(q),
                      f"endorse {what}: {p.name} != the plain path's "
                      "(flags, metadata flags, state, history, pvt store "
                      "or commit hash)")
                flags.append(res.final_flags.codes())
            check(flags[0] == flags[1] and endorse_rows(cuda[0])[0]
                  == endorse_rows(cuda[1])[0],
                  f"endorse {what}: the two peers disagree")
            return flags[0]

        with Traced() as tracer:
            tracer.recorder.max_traces = 4096
            # 1. lifecycle: both orgs approve cc, then Org1 commits it
            pol = parse_policy(ENDORSE_POLICY).serialize()
            t0 = time.perf_counter()
            for fn, orgs in (("approve_for_org", (0, 1)), ("commit", (0,))):
                envs = []
                for o in orgs:
                    admin = ids.orgs[o].admin
                    sp = signed_proposal("ch", "_lifecycle", fn,
                                         [b"cc", b"1.0", b"1", pol], admin)
                    envs.append(assemble_transaction(sp, endorse(sp),
                                                     admin))
                check(commit(envs, fn) == [0] * len(envs),
                      f"endorse: lifecycle {fn} not valid")
            for p in cuda + plain:
                got = p.policies.policy_for("cc")
                check(got is not None and got.serialize() == pol,
                      f"endorse: {p.name}'s policy_for('cc') != the "
                      "committed definition")
            times["lifecycle_s"] = time.perf_counter() - t0
            # 2. seed: ENDORSE_ACCOUNTS accounts in one block
            t0 = time.perf_counter()
            per = ENDORSE_ACCOUNTS // ENDORSE_SEED_TXS
            envs = []
            for t in range(ENDORSE_SEED_TXS):
                client = ids.clients[t % len(ids.clients)]
                pairs = [x for i in range(t * per, (t + 1) * per)
                         for x in (f"acct{i:05d}".encode(),
                                   str(ENDORSE_BALANCE).encode())]
                sp = signed_proposal("ch", "cc", "seed", pairs, client)
                envs.append(assemble_transaction(sp, endorse(sp), client))
            check(commit(envs, "seed") == [0] * ENDORSE_SEED_TXS,
                  "endorse: seed block not valid")
            times["seed_s"] = time.perf_counter() - t0
            # 3. the load: every proposal through both endorsers in turn
            t0 = time.perf_counter()
            load = endorse_load(ids, SEED + 15)
            labels = endorse_labels(load)
            times["sign_s"] = time.perf_counter() - t0
            calls = []

            def run_load():
                for kind, client, sp, _acct in load:
                    resps = []
                    for peer, conn in zip(cuda, conns):
                        c0 = time.perf_counter()
                        with tracer.start_span(
                                "endorse.call",
                                attributes={"peer": peer.name}) as span:
                            resps.append(rpc_endorse(conn, sp))
                        calls.append((kind, client.mspid, peer.name,
                                      (time.perf_counter() - c0) * 1e3,
                                      span.context.trace_id))
                    load_resps.append(resps)
            load_resps = []
            launches0 = {n: f.launches for n, f in fns.items()}
            causes0 = dict(tally)
            (profiled,) = device_busy(torch, {"endorse load": run_load},
                                      threaded=True).values()
            proposal_launches = {n: f.launches - launches0[n]
                                 for n, f in fns.items()}
            by_cause_load = {k: n - causes0.get(k, 0)
                             for k, n in tally.items()}
            t0 = time.perf_counter()
            for (kind, _c, sp, _a), got in zip(load, load_resps):
                want = ENDORSE_RESPONSES[kind]
                check(all((r.status, r.message) == want for r in got),
                      f"endorse: a {kind} proposal's responses "
                      f"{[(r.status, r.message) for r in got]} != {want}")
                endorse_compare(sp, got)
            # the plain path's endorsers on the same proposals
            times["compare_s"] = time.perf_counter() - t0
            envs = [assemble_transaction(sp, got, client)
                    for (kind, client, sp, _a), got in zip(load, load_resps)
                    if kind in ENDORSE_SUBMITTED]
            flags = commit(envs, "load")
            check(flags == labels, "endorse: the load block's flags != the "
                  f"mix's labels ({sum(f != 0 for f in flags)} invalid, "
                  f"{sum(l != 0 for l in labels)} expected)")
            p1, p2 = cuda
            n_pvt = dict(ENDORSE_MIX)["private"]
            check(len(p1.pvt._by_txid) == n_pvt and not p2.pvt._by_txid
                  and len(p1.transient) == len(p2.transient) == 0,
                  "endorse: private data: peer 1 should hold every "
                  "cleartext, peer 2 none, both transient stores purged")
            spans = endorse_spans(tracer, calls)
        # 4. qscc, cscc, discovery through the ACL provider
        scc = endorse_scc(cause, sw, ids, cuda[0], store)
        # 5. the byzantine plane on gossip
        byz = endorse_byzantine(ids, cuda, cause, store, tmp)
    finally:
        factory.set_default(provider)
        for c in conns:
            c.close()
        for p in cuda:
            if p.rpc is not None:
                p.rpc.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {n: f.launches for n, f in fns.items()}
    check_launches("endorse", launches, ("p256_verify", "ed25519_verify"),
                   maybe=("p256_verify_rows", "ed25519_verify_rows"))
    for kern in ("kp2", "ke5"):
        check(by_cause_load.get(f"proposal.{kern}", 0) > 0,
              f"endorse: no {kern} launch from the proposals")
    for c in ENDORSE_CAUSES:
        check(sum(n for k, n in tally.items() if k.startswith(c + ".")) > 0,
              f"endorse: no launch for {c}")
    check(sum(tally.values()) == sum(launches.values()),
          "endorse: launches by cause != the phase's launches")
    check(provider.stats["fallbacks"] == fb0 == 0, "endorse: fallbacks != 0")
    # --- report ---
    phase("endorse", card=name_power, accounts=ENDORSE_ACCOUNTS,
          clients=len(ids.clients), mix=dict(ENDORSE_MIX),
          submitted=len(labels), mvcc_conflicts=labels.count(11),
          policy=ENDORSE_POLICY, **{k: round(v, 3) for k, v in times.items()})
    for peer in ("peer1", "peer2"):
        rows = [c for c in calls if c[2] == peer]
        for org in ("Org1", "Org2"):
            sel = [c for c in rows if c[1] == org]
            ms = {"call_ms": [c[3] for c in sel]}
            for name in ENDORSE_SPANS:
                ms[name] = [spans[c[4]][name] for c in sel
                            if name in spans[c[4]]]
            phase("endorse", endorser=peer, client_org=org,
                  proposals=len(sel),
                  **{f"{k}_p50_ms": round(pct(v, 0.5), 3)
                     for k, v in ms.items() if v},
                  **{f"{k}_p99_ms": round(pct(v, 0.99), 3)
                     for k, v in ms.items() if v})
        total_s = sum(c[3] for c in rows) / 1e3
        phase("endorse", endorser=peer, proposals=len(rows),
              proposals_per_s=round(len(rows) / total_s, 3),
              busy_s=round(total_s, 3))
    for p in cuda:
        phase("endorse", peer=p.name, commit_ms={
            what: round(ms, 3) for what, ms in p.commit_ms})
    busy, wall, top = profiled
    phase("endorse", profiled=f"the load ({len(calls)} calls over RPC)",
          wall_ms=round(wall, 3), device_busy_ms=round(busy, 3),
          device_idle_share=round(1 - busy / wall, 4), top_device_ops=top)
    phase("endorse", **scc)
    phase("endorse", **byz)
    phase("endorse", launches_by_cause_load={
        k: n for k, n in sorted(by_cause_load.items()) if n},
        launches_by_cause={k: n for k, n in sorted(tally.items()) if n},
        load_launches=proposal_launches)
    phase("endorse", main_path=launches, provider=provider.name,
          fallbacks=0, card=name_power,
          seconds=round(time.perf_counter() - t_phase, 1))
    return launches


def endorse_spans(tracer, calls) -> dict:
    """{trace id: {span name: ms}} of each call's trace (ENDORSE_SPANS),
    once its server fragment (`rpc.endorse` and its children) has landed;
    each endorser span a child of `rpc.endorse`, that a child of the
    client's `endorse.call`.  Waits at most ENDORSE_WAIT_S in all."""
    out = {}
    deadline = time.perf_counter() + ENDORSE_WAIT_S
    for *_rest, tid in calls:
        while True:
            rec = tracer.recorder.get(tid)
            by = {s["name"]: s for s in rec["spans"]} if rec else {}
            if "rpc.endorse" in by and "endorse.call" in by:
                break
            check(time.perf_counter() < deadline,
                  "endorse: a proposal's trace never got its server spans")
            time.sleep(0.005)
        check(by["rpc.endorse"]["parent_id"] == by["endorse.call"]["span_id"]
              and all(by[n]["parent_id"] == by["rpc.endorse"]["span_id"]
                      for n in ENDORSE_SPANS[1:] if n in by),
              "endorse: the endorser's spans are not under rpc.endorse")
        out[tid] = {n: by[n]["duration_s"] * 1e3 for n in ENDORSE_SPANS
                    if n in by}
    return out


def endorse_scc(cause, sw, ids, peer, store) -> dict:
    """qscc on peer 1's block store (chain info, every block by number
    and by hash, every committed tx by id), cscc (the channel list and
    config) and discovery (`cc`'s layouts), each call behind its ACL
    resource on the CUDA provider (cause `scc_acl`), callers an Org1
    (P-256) and an Org2 (Ed25519) client in turn; each answer against
    the block store (and the orderer's headers), every decision of a
    sweep (resources x a member of each org, a tampered signature, no
    caller) equal to an ACLProvider's on SW -> the report's fields."""
    import types
    from fabric_tpu_torch.policy import ACLError, ACLProvider, SignedData
    from fabric_tpu_torch.protocol import Envelope
    from fabric_tpu_torch.scc import Cscc, DiscoveryService, Qscc
    acl = ACLProvider(peer.source, cause("scc_acl"))
    acl_sw = ACLProvider(peer.source, sw)
    bs = peer.ledger.blockstore
    sds = [SignedData(b"scc", c.serialize(), c.sign(b"scc"))
           for c in ids.clients[:2]]
    ms = {}

    def timed(kind, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        ms.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
        return out
    q = Qscc("ch", bs, acl=acl)
    info = timed("GetChainInfo", q.get_chain_info, sds[0])
    ci = bs.chain_info()
    check(info == {"height": bs.height, "current_hash": ci.current_hash,
                   "previous_hash": ci.previous_hash}
          and bs.height == store.height,
          "endorse: qscc GetChainInfo != the block store")
    n_tx = 0
    for num in range(bs.height):
        sd = sds[num % 2]
        blk = timed("GetBlockByNumber", q.get_block_by_number, num, sd)
        check(blk.serialize() == bs.get_by_number(num).serialize()
              and blk.header == store.get_by_number(num).header,
              f"endorse: qscc block {num} != the block store's")
        check(timed("GetBlockByHash", q.get_block_by_hash, blk.hash(),
                    sd).serialize() == blk.serialize(),
              f"endorse: qscc block {num} by hash != by number")
        for raw in blk.data:
            txid = Envelope.deserialize(raw).header().channel_header.txid
            env = timed("GetTransactionByID", q.get_transaction_by_id,
                        txid, sds[n_tx % 2])
            check(env.serialize() == bytes(raw),
                  f"endorse: qscc tx {txid} != the block's envelope")
            n_tx += 1
    cscc = Cscc()
    cscc.register("ch", types.SimpleNamespace(bundle_source=peer.source))
    acl.check_acl("cscc/GetChannels", sds[1])
    check(timed("cscc.GetChannels", cscc.get_channels, sds[1]) == ["ch"],
          "endorse: cscc channels")
    acl.check_acl("cscc/GetChannelConfig", sds[0])
    cfg = timed("cscc.GetChannelConfig", cscc.get_channel_config, "ch",
                sds[0])
    check(cfg.to_dict() == peer.source.current().config.to_dict(),
          "endorse: cscc config != the channel's")
    members = [{"id": "peer1", "mspid": "Org1", "roles": ["peer"]},
               {"id": "peer2", "mspid": "Org2", "roles": ["peer"]}]
    acl.check_acl("discovery/Discover", sds[1])
    got = timed("discovery", DiscoveryService(
        lambda: members, peer.policies.policy_for).endorsers, "cc")
    layouts = [lay.as_dict() for lay in got["layouts"]]
    check(layouts == [{"Org1:member": 1, "Org2:member": 1}],
          f"endorse: discovery layouts {layouts}")
    bad = SignedData(b"scc", sds[0].identity, sds[1].signature)

    def decide(a, res, sd):
        try:
            a.check_acl(res, sd)
            return "allow"
        except ACLError as exc:
            return f"deny: {exc}"
    resources = ("qscc/GetChainInfo", "qscc/GetTransactionByID",
                 "cscc/GetChannels", "cscc/JoinChain", "discovery/Discover",
                 "peer/Propose")
    sweep = [(r, i) for r in resources for i in range(4)]
    callers = sds + [bad, None]
    got = [decide(acl, r, callers[i]) for r, i in sweep]
    want = [decide(acl_sw, r, callers[i]) for r, i in sweep]
    check(got == want, "endorse: an ACL decision != SW's")
    check(got.count("allow") == 2 * len(resources) - 2,
          f"endorse: ACL sweep {got}")
    return {"qscc_txs": n_tx, "qscc_blocks": bs.height,
            "scc_ms_p50": {k: round(pct(v, 0.5), 3) for k, v in ms.items()},
            "scc_ms_max": {k: round(max(v), 3) for k, v in ms.items()},
            "acl_sweep": f"{len(sweep)} decisions equal SW's",
            "discovery_layouts": layouts}


def endorse_byzantine(ids, cuda, cause, store, root) -> dict:
    """Each CUDA peer's GossipNode (an in-process network) with its
    gossip state's ByzantineMonitor (witness log, quarantine registry
    and fraud proofs under `root`) and ProofGossip, wired as the
    reference's peer channel wires them; the MCS on the CUDA provider
    (`gossip_mcs`).  The orderer's last block, gossiped again, is
    stale; a sibling of it signed by the orderer stand-in, gossiped to
    peer 1, is rejected and convicts the orderer (fork); peer 1's proof
    reaches peer 2, which re-verifies it (`fraud_proof`: the accuser's
    and the orderer's signatures on the card, its own chain the second
    witness) and convicts; its relay back is a duplicate -> the
    report's fields."""
    from fabric_tpu_torch.byzantine import (ByzantineMonitor, ProofGossip,
                                            QuarantineRegistry, WitnessLog)
    from fabric_tpu_torch.gossip.comm import InProcNetwork
    from fabric_tpu_torch.gossip.mcs import MessageCryptoService
    from fabric_tpu_torch.gossip.node import GossipNode
    from fabric_tpu_torch.gossip.state import MSG_BLOCK
    from fabric_tpu_torch.orderer.cluster import cert_fingerprint
    net = InProcNetwork()
    nodes = []
    for i, p in enumerate(cuda):
        node = GossipNode(net.register, p.name, p.coordinator,
                          mcs=MessageCryptoService(ids.msps,
                                                   cause("gossip_mcs")),
                          signer=p.signer, bootstrap=[cuda[1 - i].name])
        d = os.path.join(root, p.name)
        os.makedirs(d)
        mon = ByzantineMonitor(
            "ch", WitnessLog(os.path.join(d, "witness_log.json")),
            QuarantineRegistry(os.path.join(d, "quarantine.json")),
            ledger=p.ledger, msps=ids.msps, signer=p.signer,
            proof_dir=os.path.join(d, "fraud_proofs"))
        node.state.monitor = mon
        pg = ProofGossip(node.endpoint, node.discovery, mon)
        node.state.proofs = pg
        mon.on_proof = pg.broadcast
        mon.on_pardon = pg.broadcast_pardon
        nodes.append((node, mon, pg))
    (n1, m1, pg1), (n2, m2, pg2) = nodes
    verdicts, check_ms = [], []
    inner = m1.check_block

    def check_block(block, source):
        t0 = time.perf_counter()
        v = inner(block, source)
        check_ms.append((time.perf_counter() - t0) * 1e3)
        verdicts.append(v)
        return v
    m1.check_block = check_block
    heights = [p.ledger.height for p in cuda]
    last = store.get_by_number(store.height - 1)
    t0 = time.perf_counter()
    for blk in (last, forge_sibling(last, ids.orderer)):
        net.send("orderer-relay", cuda[0].name, MSG_BLOCK,
                 {"block": blk.serialize()})
        net.deliver_all()
    wall = (time.perf_counter() - t0) * 1e3
    accused = f"{ids.orderer.mspid}|{cert_fingerprint(ids.orderer.cert)}"
    check(verdicts == ["stale", "reject"],
          f"endorse: peer 1's monitor verdicts {verdicts}")
    check([p["reason"] for p in m1.proofs] == ["fork"]
          and [p["accused"] for p in m2.proofs] == [accused],
          "endorse: the fork's fraud proofs")
    check(pg1.broadcasts == 1 and pg2.received["convicted"] == 1
          and pg2.relayed == 1 and pg1.received["duplicate"] == 1,
          f"endorse: proof gossip {pg1.snapshot()} {pg2.snapshot()}")
    check(m1.quarantine.is_quarantined(accused)
          and m2.quarantine.is_quarantined(accused)
          and m1.quarantine.count() == m2.quarantine.count() == 1,
          "endorse: both peers should quarantine the orderer alone")
    check([p.ledger.height for p in cuda] == heights
          and n1.state.buffered == n2.state.buffered == [],
          "endorse: the forged block reached a ledger")
    return {"monitor_verdicts": verdicts,
            "check_block_ms": [round(x, 3) for x in check_ms],
            "fork_to_both_quarantined_ms": round(wall, 3),
            "quarantined": accused[:24] + "...",
            "peer2_proofs": pg2.received}


def endorse_only(torch, args) -> int:
    """`--endorse-only`: phase 15 alone.  Builds the kernels and the C
    parts, then runs `endorse_phase` on the factory's CUDA provider;
    prints no result line."""
    from fabric_tpu_torch import native
    from fabric_tpu_torch.bccsp import FactoryOpts, init_factories
    from fabric_tpu_torch.ops import _build, ed25519, p256, p256_fixed
    built = _build.build_all(force=True)
    phase("build", libs=sorted(built))
    native.build("der")
    provider = init_factories(FactoryOpts(default="CUDA"))
    fns = {"p256_verify_rows": p256_fixed.p256_verify_rows,
           "p256_verify": p256.p256_verify,
           "ed25519_verify_rows": ed25519.ed25519_verify_rows,
           "ed25519_verify": ed25519.ed25519_verify}
    endorse_phase(torch, args, provider, fns, smi("name,power.limit"),
                  torch.device("cuda"))
    phase("done", by_phase={k: round(v, 1) for k, v in _PHASE_S.items()})
    return 0


# ---------------------------------------------------------------------------
# 16. the node
# ---------------------------------------------------------------------------

NODE_SEED_TXS = 10_000         # block 0: `create` txs, made once
NODE_CLIENTS = 16              # clients a org (Org1 P-256, Org2 Ed25519:
#                                the provisioned client books)
NODE_CLIENT_PROCS = 4          # processes the 2 x NODE_CLIENTS clients run
#                                in, a thread a client (none in a peer's)
NODE_TXS_PER_CLIENT = 16       # transfers each, submitted without waiting
NODE_HOT_PAIRS = 6             # client pairs whose first txs share an asset
NODE_WAIT_S = 120.0            # bound on each wait of phase 16
NODE_ORDERERS = 3              # the Raft cluster: a process an orderer
SEED_BATCH = 500               # the seed's envelopes a broadcast call (the
#                                channel's MaxMessageCount: a block a call)
ORDERER_CLIENTS = 8            # phase 17 (a): clients, 4 a process
ORDERER_TXS_PER_CLIENT = 16    # their transfers: 128 in flight at the kill
ORDERER_RESUBMIT_S = 6.0       # a tx with no status that long after its
#                                client's last submit is resubmitted (the
#                                new leader cuts within its 2-s timeout)
ORDERER_WAIT_S = 60.0          # bound on each wait of phase 17
ORDERER_BUDGET_S = 90.0        # phase 17's share of the script's time
NODE_ROUTES = ("/healthz", "/verify_plane", "/gateway", "/byzantine",
               "/state", "/traces", "/slo")
NODE_CAUSES = ("proposal", "acl", "speculative", "commit", "deliver_sig",
               "handshake", "gossip_mcs", "alive", "other")
# the factory default's callers in a peer node, innermost frame first
NODE_CALLERS = (
    ("_verify_peer", os.path.join("comm", "secure.py"), "handshake"),
    ("verify_peer_msg", os.path.join("gossip", "mcs.py"), "alive"),
    (None, os.path.join("gossip", "mcs.py"), "gossip_mcs"),
    (None, os.path.join("policy", "aclmgmt.py"), "acl"),
    ("_validate", os.path.join("endorser", "endorser.py"), "proposal"),
    ("_verify_batch", os.path.join("verify_plane", "speculative.py"),
     "speculative"),
    ("_deliver_loop", os.path.join("node", "peer.py"), "deliver_sig"),
    (None, os.path.join("committer", "txvalidator.py"), "commit"),
    (None, os.path.join("committer", "committer.py"), "commit"))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def node_seed(signers, peers, n: int) -> list:
    """Block 0's envelopes: `create` of asset00000.. (a read of the
    absent key and its write, as the contract simulates it), creators
    alternating between the two orgs' clients, endorsed by both peers
    (the chaincode's AND of the orgs)."""
    from fabric_tpu_torch.protocol import build
    from fabric_tpu_torch.protocol.types import (KVRead, KVWrite, NsRwSet,
                                                 TxRwSet)
    out = []
    for i in range(n):
        key = f"asset{i:05d}"
        rw = TxRwSet((NsRwSet("assets", reads=(KVRead(key, None),),
                              writes=(KVWrite(key, b"owner0"),)),))
        env = build.endorser_tx("ch", "assets", "1.0", rw, signers[i % 2],
                                peers, args=[key.encode(), b"owner0"],
                                response_payload=b"created")
        out.append(env.serialize())
    return out


class _CacheSources:
    """Peer 1's verdict cache, spied: each entry's source (`attest` from
    the orderer's deliver attestations, `speculative` from the gateway's
    stamps, else `commit`) by the caller of `put`, and the commit-time
    lookups' hits by source."""

    def __init__(self, cache):
        from fabric_tpu_torch.verify_plane import item_digest
        self.digest = item_digest
        self.source, self.hits = {}, {}
        self.inner_put, self.inner_lookup = cache.put, cache.lookup
        cache.put, cache.lookup = self.put, self.lookup

    @staticmethod
    def _on_stack(*names) -> str:
        f = sys._getframe(2)
        while f is not None:
            for name in names:
                if f.f_code.co_name == name:
                    return name
            f = f.f_back
        return ""

    def put(self, item, verdict, trace_id="", scope=""):
        caller = self._on_stack("accept_block_attestations", "_verify_batch")
        self.source[self.digest(item)] = {
            "accept_block_attestations": "attest",
            "_verify_batch": "speculative"}.get(caller, "commit")
        return self.inner_put(item, verdict, trace_id=trace_id, scope=scope)

    def lookup(self, item):
        got = self.inner_lookup(item)
        if got[0] is not None:
            f = sys._getframe(1)
            while f is not None and not f.f_code.co_filename.endswith(
                    os.path.join("committer", "txvalidator.py")):
                f = f.f_back
            if f is not None:
                src = self.source.get(self.digest(item), "other")
                self.hits[src] = self.hits.get(src, 0) + 1
        return got


def node_clients(spec_path: str) -> int:
    """Phase 16's client process, started as `python -c "import
    chip_smoke; chip_smoke.node_clients(spec)"`: the clients that the
    spec names, a thread each, against the peers' gateways.  Standard
    output carries the steps, a line each: `up`; on `endorse`, each
    client endorses and assembles its txs one after another, then
    `endorsed`; on `submit`, each client submits all its envelopes at
    once (a thread an envelope, one multiplexed connection a client),
    then asks the commit status of each; then `result <json>` (per tx:
    txid, endorse s, submit s, submit time, status time, code, block,
    endorsements, org, endorse start, resubmits; times on the monotonic
    clock, which the parent shares), and `failed <text>` instead of any
    step that raised.  The clients check the peers' handshakes on SW: no
    peer runs here.  Spec keys beside the clients: `key_base` (the first
    asset a client's txs transfer, default 100), `sequential` (each
    client submits its txs one after another, the clients together)
    and `resubmit_after_s`
    (phase 17: a tx with no commit status that long after its client's
    last submit is submitted again, once, through the other peer's
    gateway, as a Fabric client does after an orderer lost it)."""
    import threading
    from fabric_tpu_torch.bccsp import FactoryOpts, init_factories
    from fabric_tpu_torch.config import Bundle, ChannelConfig
    from fabric_tpu_torch.endorser import assemble_transaction
    from fabric_tpu_torch.gateway import GatewayClient, GatewayError
    from fabric_tpu_torch.node.orderer import load_signing_identity

    def say(line: str) -> None:
        sys.stdout.write(line + "\n")
        sys.stdout.flush()

    def hear(word: str) -> None:
        line = sys.stdin.readline().strip()
        if line != word:
            raise RuntimeError(f"expected {word!r}, got {line!r}")
    try:
        with open(spec_path) as f:
            spec = json.load(f)
        init_factories(FactoryOpts(default="SW"))
        msps = Bundle(ChannelConfig.deserialize(bytes.fromhex(
            spec["channel_config_hex"]))).msps
        signers = []
        for path in spec["identities"]:
            with open(path) as f:
                c = json.load(f)
            signers.append(load_signing_identity(
                c["mspid"], c["cert_pem"].encode(), c["key_pem"].encode()))
        n_txs, wait_s = spec["txs_per_client"], spec["wait_s"]
        key_base = int(spec.get("key_base", 100))
        retry_s = spec.get("resubmit_after_s")
        hot = {int(c): j for c, j in spec["hot"].items()}
        gws = {c: GatewayClient(tuple(spec["gateways"][(c // 2) % 2]),
                                signers[c % 2], msps, channel_id="ch",
                                call_timeout=wait_s)
               for c in spec["clients"]}
        others = {c: GatewayClient(tuple(spec["gateways"][1 - (c // 2) % 2]),
                                   signers[c % 2], msps, channel_id="ch",
                                   call_timeout=wait_s)
                  for c in spec["clients"]} if retry_s else {}
        txs, errors, lock = {}, [], threading.Lock()

        def run_all(fn, keys):
            def guarded(key):
                try:
                    fn(key)
                except Exception as exc:
                    with lock:
                        errors.append(f"{key}: {exc!r}")
            threads = [threading.Thread(target=guarded, args=(k,))
                       for k in keys]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=3 * wait_s)
            if errors or any(t.is_alive() for t in threads):
                raise RuntimeError(f"clients failed: {errors[:3]}")

        def endorse(c):
            for i in range(n_txs):
                k = (hot[c] if i == 0 and c in hot
                     else key_base + c * n_txs + i)
                t0 = time.monotonic()
                sp, responses = gws[c].endorse("assets", "transfer", [
                    f"asset{k:05d}".encode(), f"owner{c}-{i}".encode()])
                t1 = time.monotonic()
                txs[(c, i)] = {
                    "env": assemble_transaction(sp, responses,
                                                signers[c % 2]),
                    "endorse_s": t1 - t0, "t_endorse": t0,
                    "n_end": len(responses), "org": c % 2}

        def submit(key):
            tx = txs[key]
            t2 = time.monotonic()
            out = gws[key[0]].submit_envelope(tx["env"], timeout_s=wait_s)
            tx.update(txid=out["txid"], submit_s=time.monotonic() - t2,
                      t_sub=t2)

        def client(c):
            if spec.get("sequential"):
                for i in range(n_txs):
                    submit((c, i))
            else:
                run_all(submit, [(c, i) for i in range(n_txs)])
            deadline = time.monotonic() + (retry_s or wait_s)
            lost = []
            for i in range(n_txs):
                tx = txs[(c, i)]
                tx["resubmits"] = 0
                try:
                    tx["code"], tx["block"] = gws[c].commit_status(
                        tx["txid"], timeout_s=max(
                            deadline - time.monotonic(), 0.1))
                    tx["t_status"] = time.monotonic()
                except GatewayError:
                    if not retry_s:
                        raise
                    lost.append(tx)
            for tx in lost:
                tx["resubmits"] = 1
                others[c].submit_envelope(tx["env"], timeout_s=wait_s)
            for tx in lost:
                tx["code"], tx["block"] = others[c].commit_status(
                    tx["txid"], timeout_s=wait_s)
                tx["t_status"] = time.monotonic()
        say("up")
        hear("endorse")
        run_all(endorse, spec["clients"])
        say("endorsed")
        hear("submit")
        run_all(client, spec["clients"])
        for gw in list(gws.values()) + list(others.values()):
            gw.close()
        say("result " + json.dumps([
            [tx["txid"], tx["endorse_s"], tx["submit_s"], tx["t_sub"],
             tx["t_status"], tx["code"], tx["block"], tx["n_end"], tx["org"],
             tx["t_endorse"], tx["resubmits"]] for tx in txs.values()]))
        return 0
    except Exception as exc:
        say("failed " + repr(exc)[:2000])
        return 1


def child_status(conns: dict, name: str, addr, signer, msps) -> dict:
    """The node's `status` (height, commit hash) over one connection a
    node, kept in `conns`."""
    from fabric_tpu_torch.comm.rpc import connect
    if name not in conns:
        conns[name] = connect(tuple(addr), signer, msps, timeout=10.0)
    try:
        return conns[name].call("status", {}, timeout=30.0)
    except Exception:
        conns.pop(name).close()
        raise


def wait_until(pred, what: str, timeout_s: float = NODE_WAIT_S,
               step_s: float = 0.05) -> None:
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            if pred():
                return
        except Exception:
            pass
        check(time.monotonic() < deadline, f"node: timed out ({timeout_s} "
              f"s) waiting for {what}")
        time.sleep(step_s)


def post_url(url: str) -> dict:
    import urllib.request
    req = urllib.request.Request(url, data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


class _BlockSpans:
    """Polls an ops server's /traces while it commits, keeping each
    `committer.store_block` span's ms by block number (the flight
    recorder's ring turns over under the load's request traces)."""

    def __init__(self, url: str):
        import threading
        self.url, self.ms, self.seen = url, {}, set()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def poll(self) -> None:
        for rec in json.loads(get_url(self.url + "/traces"))["recent"]:
            tid = rec["trace_id"]
            if tid in self.seen or rec["root"] in (
                    "rpc.endorse", "rpc.gateway.endorse",
                    "rpc.gateway.submit", "rpc.gateway.commit_status",
                    "rpc.gateway.evaluate", "gateway.batch"):
                continue
            self.seen.add(tid)
            doc = json.loads(get_url(f"{self.url}/traces/{tid}?follow=0"))
            for e in doc["traceEvents"]:
                if e.get("ph") == "X" and e["name"] == OPS_ROOT:
                    self.ms[int(e["args"]["block"])] = e["dur"] / 1e3

    def _run(self) -> None:
        while not self._stop.wait(0.2):
            try:
                self.poll()
            except Exception:
                pass

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=10)
        self.poll()
        return self.ms


def node_ledger(data_dir: str):
    """A node's durable ledger of channel `ch`, opened from its files."""
    from fabric_tpu_torch.ledger import KVLedger, LedgerConfig
    return KVLedger("ch", LedgerConfig(
        root=os.path.join(data_dir, "channels", "ch", "ledger"),
        state_shards=8, snapshot_every=256))


def node_chain(ledger) -> list:
    """Each block's (number, tx flags, commit hash) from a ledger."""
    from fabric_tpu_torch.protocol.types import META_COMMIT_HASH, META_TXFLAGS
    out = []
    for n in range(ledger.height):
        md = ledger.blockstore.get_by_number(n).metadata.items
        out.append((n, bytes(md.get(META_TXFLAGS) or b""),
                    bytes(md.get(META_COMMIT_HASH) or b"")))
    return out


class _Heights:
    """Polls `read()` (a height) every 20 ms on a thread of its own and
    keeps the monotonic time each block was first seen: block n's time
    is when the height first passed n (from `start` on, when given; else
    from the first reading)."""

    def __init__(self, read, start=None):
        import threading
        self.read, self.at, self.last = read, {}, start
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(0.02):
            try:
                h = int(self.read())
            except Exception:
                continue
            now = time.monotonic()
            if self.last is not None:
                for n in range(self.last, h):
                    self.at.setdefault(n, now)
            self.last = h if self.last is None else max(self.last, h)

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=5)
        return self.at


def hist_ms(m0: dict, m1: dict, name: str, **labels) -> dict:
    """One histogram's observations between two /metrics readings:
    count, mean ms, and the p50 and p99 as the upper bound of their
    bucket (ms)."""
    key = tuple(sorted(labels.items()))
    n = moved_by(m0, m1, name + "_count", **labels)
    if n <= 0:
        return {"count": 0}
    out = {"count": int(n), "mean_ms": round(
        moved_by(m0, m1, name + "_sum", **labels) / n * 1e3, 3)}
    rows = []
    for lk, v in m1.get(name + "_bucket", {}).items():
        rest = tuple(kv for kv in lk if kv[0] != "le")
        if rest == key:
            le = dict(lk)["le"]
            rows.append((float(le), v - m0.get(name + "_bucket", {}).get(
                lk, 0.0)))
    for label, q in (("p50_le_ms", 0.5), ("p99_le_ms", 0.99)):
        for ub, cum in sorted(rows):
            if cum >= q * n:
                out[label] = ub * 1e3
                break
    return out


def orderer_figures(m0: dict, m1: dict) -> dict:
    """One orderer process's figures between two readings of its
    /metrics: its `broadcast_batch` calls (the RPC handler's wall time: a
    gateway batch's admission), its SigFilter's device verifies and
    attested skips, its Raft entry verifies, its provider's dispatches by
    lane (`generic`: KP2 and KE5; `rows`: KP3 and KE6) and their resolve
    seconds (the device wait its threads saw)."""
    return {
        "broadcast_batch": hist_ms(m0, m1, "rpc_request_duration_seconds",
                                   method="broadcast_batch"),
        "sig_filter_device_verifies": moved_by(
            m0, m1, "verify_plane_device_verifications_total",
            site="orderer"),
        "attested_skips": moved_by(m0, m1,
                                   "verify_plane_attested_skips_total"),
        "entry_verifies": moved_by(m0, m1, "orderer_entry_verifies_total",
                                   result="ok"),
        "bad_entry_sigs": moved_by(m0, m1, "orderer_entry_verifies_total",
                                   result="bad_entry_sig"),
        "dispatches_by_lane": {
            lane: moved_by(m0, m1, "provider_lane_fill_count", lane=lane)
            for lane in ("generic", "rows")},
        "resolve_s": round(moved_by(m0, m1, "provider_resolve_seconds_sum"),
                           6)}


def orderer_chains(ocfgs) -> dict:
    """{channel: [each orderer's block header hashes]}, read from the
    orderers' block stores on disk (the processes stopped)."""
    from fabric_tpu_torch.ledger.blkstorage import BlockStore
    from fabric_tpu_torch.protocol import block_header_hash
    out = {}
    for oc in ocfgs:
        for cid in sorted(os.listdir(oc["data_dir"])):
            d = os.path.join(oc["data_dir"], cid, "ledger")
            if not os.path.isdir(d):
                continue
            store = BlockStore(d)
            out.setdefault(cid, []).append(
                [block_header_hash(store.get_by_number(n).header).hex()
                 for n in range(store.height)])
    return out


def seek_body(signer, cid: str, start: int, stop: int) -> dict:
    """A `deliver` request for blocks start..stop of `cid`, signed by
    `signer` for the orderer's Readers check."""
    payload = b"seek:%s" % cid.encode()
    return {"channel": cid, "start": start, "stop": stop, "timeout_s": 10,
            "behavior": "fail_if_not_ready",
            "signed_data": {"data": payload, "identity": signer.serialize(),
                            "signature": signer.sign(payload)}}


def orderer_phase(torch, net, fns, name_power) -> dict:
    """Phase 17, on phase 16's network after its load: the ordering
    service's failure drills on the card.
    (a) ORDERER_CLIENTS clients in two processes of their own endorse
        ORDERER_TXS_PER_CLIENT `transfer`s each (fresh assets), then
        submit them through both gateways, each client one tx after
        another, the clients together; once the leader has admitted half
        of them (its /metrics), it is SIGKILLed.  A tx with
        no commit status ORDERER_RESUBMIT_S after its client's last
        submit is submitted again, once, through the other gateway, as a
        Fabric client does after an orderer lost it.  Timed on the monotonic clock: kill -> a new
        leader (the survivors' `status`) -> its first block -> that
        block committed at both peers.  Held: every tx committed exactly
        once, VALID, with the code its client was told.
    (b) The killed orderer restarted from its WAL (`python -m
        fabric_tpu_torch.node.orderer` again): its /healthz the CUDA
        backend, and its height and tip header hash the leader's.
    (c) A second channel at runtime: its config (the channel's, Admins
        any one org admin) joined on the three orderers through the
        admin-gated `participation.join` RPC (the admin CLI has no
        orderer verb, in either package), and on both peers by `python
        -m fabric_tpu_torch.node.admin channel join`; one tx committed
        VALID on it.  Onboarding: a port OrdererNode in this process on
        the spare consenter's identity (its provider the factory's CUDA
        kind) joins both channels with a catch-up target at the
        cluster's heights, as a snapshot install sets it, and
        `_replicate_once` pulls every block and verifies each orderer
        signature on the card.
    (d) A Raft append whose entry payload was spliced after the leader
        signed it, cast to a follower on the leader's own transport
        identity: rejected as `bad_entry_sig` by the follower's CUDA
        provider (its /metrics).  That onboarded node, as the port's
        `testing.adversary.EquivocatingOrderer`, serves the honest block
        and a forged sibling at a committed height; peer 1's byzantine
        monitor convicts it of a fork and quarantines its binding.
    -> the phase's launches by kernel in this process."""
    import dataclasses
    import signal
    from fabric_tpu_torch.bccsp import factory
    from fabric_tpu_torch.comm.rpc import connect
    from fabric_tpu_torch.config import ChannelConfig
    from fabric_tpu_torch.gateway import GatewayClient
    from fabric_tpu_torch.msp import Principal
    from fabric_tpu_torch.node.orderer import load_signing_identity
    from fabric_tpu_torch.orderer import block_signature_items
    from fabric_tpu_torch.orderer.cluster import (cert_fingerprint,
                                                  msg_to_dict)
    from fabric_tpu_torch.orderer.consensus import make_entry_signer
    from fabric_tpu_torch.orderer.raft import Entry, Message
    from fabric_tpu_torch.policy import n_out_of, signed_by
    from fabric_tpu_torch.protocol import Block, Envelope, block_header_hash
    from fabric_tpu_torch.protocol.txflags import TxFlags
    from fabric_tpu_torch.protocol.types import META_TXFLAGS
    from fabric_tpu_torch.testing.adversary import EquivocatingOrderer
    t_phase = time.perf_counter()
    base = {f: fns[f].launches for f in fns}
    node1, ch1, ocfgs = net.node1, net.ch1, net.ocfgs
    alive = list(range(1, NODE_ORDERERS + 1))

    def metrics():
        return {k: scrape(net.ourl[k - 1] + "/metrics") for k in alive}

    def ident(c):
        return load_signing_identity(c["mspid"], c["cert_pem"].encode(),
                                     c["key_pem"].encode())
    parts, t_part = {}, [t_phase]

    def part(name):
        now = time.perf_counter()
        parts[name] = round(now - t_part[0], 2)
        t_part[0] = now
    m0 = metrics()

    # --- (a) the leader killed mid-submission ---------------------------
    old = net.leader[0]
    h0 = net.ostatus(old)["height"]
    key_base = 100 + 2 * NODE_CLIENTS * NODE_TXS_PER_CLIENT
    n_tx = ORDERER_CLIENTS * ORDERER_TXS_PER_CLIENT
    half = ORDERER_CLIENTS // 2
    specs = [dict(net.spec0, clients=list(range(k * half, (k + 1) * half)),
                  hot={}, txs_per_client=ORDERER_TXS_PER_CLIENT,
                  key_base=key_base, sequential=True,
                  resubmit_after_s=ORDERER_RESUBMIT_S)
             for k in range(2)]
    tell, hear = net.clients_up("drill", specs)
    hear("up")
    tell("endorse")
    hear("endorsed")
    part("a_endorse")
    lurl = net.ourl[old - 1] + "/metrics"

    def admitted() -> float:
        m = scrape(lurl)
        return (moved_by(m0[old], m, "verify_plane_attested_skips_total")
                + moved_by(m0[old], m,
                           "verify_plane_device_verifications_total",
                           site="orderer"))
    tell("submit")
    t_sub = time.monotonic()
    while admitted() < n_tx // 2 and time.monotonic() - t_sub < 10.0:
        time.sleep(0.005)
    at_kill = admitted()
    proc = net.procs[f"orderer{old}"]
    t_kill = time.monotonic()
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)
    alive.remove(old)
    h_kill = max(net.ostatus(k)["height"] for k in alive)
    new = None
    while new is None:
        check(time.monotonic() - t_kill < ORDERER_WAIT_S,
              "orderer: no new leader after the kill")
        for k in alive:
            try:
                if net.ostatus(k)["role"] == "leader":
                    new = k
            except Exception:
                pass
        if new is None:
            time.sleep(0.01)
    t_leader = time.monotonic()
    net.leader[0] = new
    own = {}
    heights = {"leader": _Heights(lambda: child_status(
        own, "leader", ("127.0.0.1", ocfgs[new - 1]["port"]),
        net.clients[0], node1.msps)["height"], h_kill),
               "peer2": _Heights(lambda: child_status(
                   own, "peer2", ("127.0.0.1", net.cfg2["port"]),
                   net.clients[0], node1.msps)["height"], h_kill)}
    results, resubmits, t_subs = {}, 0, []
    for said in hear("result"):
        for (txid, _e, _s, t_s, _tst, code, num, _n, _org, _te,
             resub) in json.loads(said):
            results[txid] = (code, num)
            resubmits += resub
            t_subs.append(t_s)
    t_statuses = time.monotonic()
    part("a_submit_kill_and_status")
    height = net.ostatus(new)["height"]
    wait_until(lambda: net.at(height, ("peer2",)),
               f"height {height} on peers 1 and 2", ORDERER_WAIT_S)
    cut_at = heights["leader"].stop()
    p2_at = heights["peer2"].stop()
    for conn in own.values():
        conn.close()
    first = min(n for n in cut_at if n >= h_kill) if any(
        n >= h_kill for n in cut_at) else h_kill
    check(first in cut_at and first in p2_at
          and first in net.committed_at,
          f"orderer: the new leader's first block {first} was not seen "
          f"cut and committed (cut {sorted(cut_at)}, peer 2 "
          f"{sorted(p2_at)})")
    t_both = max(net.committed_at[first], p2_at[first])
    # each drill tx committed once, VALID, with its client's code
    seen = {}
    for num in range(h0, height):
        blk = ch1.ledger.blockstore.get_by_number(num)
        flags = TxFlags.from_bytes(blk.metadata.items[META_TXFLAGS])
        for j, d in enumerate(blk.data):
            txid = Envelope.deserialize(bytes(d)).header() \
                .channel_header.txid
            if txid in results:
                seen.setdefault(txid, []).append((int(flags.flag(j)), num))
    check(len(results) == n_tx, f"orderer: {len(results)} of {n_tx} drill "
          "txs have a commit status")
    bad = [(t, results[t], seen.get(t)) for t in results
           if seen.get(t) != [results[t]] or results[t][0] != 0]
    check(not bad, f"orderer: {len(bad)} drill txs not committed exactly "
          f"once, VALID, as their clients were told: {bad[:3]}")
    phase("orderer", drill="leader killed mid-submission",
          killed=f"orderer{old}", admitted_at_kill=int(at_kill),
          new_leader=f"orderer{new}", txs=n_tx, resubmitted=resubmits,
          kill_to_last_submit_s=round(max(t_subs) - t_kill, 3),
          kill_to_last_status_s=round(t_statuses - t_kill, 3),
          kill_to_new_leader_s=round(t_leader - t_kill, 3),
          kill_to_first_block_cut_s=round(cut_at[first] - t_kill, 3),
          kill_to_committed_on_both_peers_s=round(t_both - t_kill, 3),
          first_block=first, blocks=height - h0,
          exactly_once="each tx once, VALID, the code its client got",
          card=name_power)
    part("a_checks")

    # --- (b) the killed orderer restarted from its WAL -------------------
    t0 = time.monotonic()
    net.spawn(f"orderer{old}", net.argv_of[f"orderer{old}"])
    alive.append(old)
    alive.sort()
    health = {}
    wait_until(lambda: health.__setitem__(0, json.loads(get_url(
        net.ourl[old - 1] + "/healthz"))) or True,
        f"orderer{old}'s /healthz after its restart "
        f"({net.tail(f'orderer{old}')})", ORDERER_WAIT_S)
    up_s = time.monotonic() - t0
    check(health[0].get("status") == "OK" and health[0].get("bccsp") == {
        "name": "cuda", "backend": "cuda", "degraded": False},
        f"orderer: the restarted orderer's /healthz {health[0]}")
    wait_until(lambda: net.ostatus(old)["height"] == height,
               f"orderer{old} back at height {height}", ORDERER_WAIT_S)
    caught_s = time.monotonic() - t0

    def tip(k, cid="ch", h=None):
        h = net.ostatus(k)["height"] if h is None else h
        conn = connect(("127.0.0.1", ocfgs[k - 1]["port"]), node1.signer,
                       node1.msps, timeout=10.0)
        try:
            got = [Block.deserialize(bytes(x["block"])) for x in
                   conn.call_stream("deliver", seek_body(
                       node1.signer, cid, h - 1, h - 1))]
        finally:
            conn.close()
        return block_header_hash(got[-1].header).hex()
    check(tip(old) == tip(new), "orderer: the restarted orderer's tip "
          "header differs from the leader's")
    phase("orderer", drill="restart from the WAL", restarted=f"orderer{old}",
          healthz_s=round(up_s, 3), caught_up_s=round(caught_s, 3),
          height=height, tip="the leader's header hash", card=name_power)
    part("b_restart")

    # --- (c) a second channel at runtime ---------------------------------
    cfg = ChannelConfig.deserialize(bytes.fromhex(
        ocfgs[0]["channel_config_hex"]))
    mspids = [o.mspid for o in cfg.orgs]
    cfg2 = dataclasses.replace(cfg, channel_id="ch2", policies=dict(
        cfg.policies, Admins=n_out_of(1, [signed_by(Principal.admin(m))
                                          for m in mspids])))
    raw2 = cfg2.serialize()
    ch2_path = os.path.join(net.root, "ch2.bin")
    with open(ch2_path, "wb") as f:
        f.write(raw2)
    t0 = time.monotonic()
    with open(net.paths["admins"]["Org1"]) as f:
        admin = ident(json.load(f))
    for k in alive:
        conn = connect(("127.0.0.1", ocfgs[k - 1]["port"]), admin,
                       node1.msps, timeout=10.0)
        try:
            out = conn.call("participation.join", {"config": raw2},
                            timeout=60.0)
        finally:
            conn.close()
        check(out == {"channel": "ch2", "status": "joined"},
              f"orderer: orderer{k} join of ch2 said {out}")
    # the two peers' joins by the admin CLI, a process each, together
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {name: subprocess.Popen(
        [sys.executable, "-m", "fabric_tpu_torch.node.admin",
         "--client", net.paths["admins"][org], "--msp-config", cfg_path,
         "channel", "join", "--peer", f"127.0.0.1:{port}",
         "--config", ch2_path], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": here})
        for name, cfg_path, port, org in (
            ("peer1", net.paths["peers"][0], net.cfg1["port"], "Org1"),
            ("peer2", net.paths["peers"][1], net.cfg2["port"], "Org2"))}
    cli = {}
    for name, run in runs.items():
        out, err = run.communicate(timeout=ORDERER_WAIT_S)
        check(run.returncode == 0, f"orderer: the admin CLI's join of "
              f"{name}: rc {run.returncode} {err[-1500:]}")
        cli[name] = json.loads(out.strip().splitlines()[-1])
    join_s = time.monotonic() - t0
    gw = GatewayClient(("127.0.0.1", net.cfg1["port"]), net.clients[0],
                       node1.msps, channel_id="ch2",
                       call_timeout=ORDERER_WAIT_S)
    try:
        code, num2 = gw.submit_transaction(
            "assets", "create", [b"asset-ch2", b"owner0"], channel="ch2",
            commit_timeout_s=ORDERER_WAIT_S)
    finally:
        gw.close()
    check(code == 0, f"orderer: the tx on ch2 committed as {code}")
    wait_until(lambda: node1.channels["ch2"].ledger.height >= num2 + 1,
               "ch2's block on peer 1", ORDERER_WAIT_S)
    ch2_height = node1.channels["ch2"].ledger.height
    tx_s = time.monotonic() - t0 - join_s
    part("c_join")
    # onboarding: a node on the spare consenter's identity catches up
    # both channels from the cluster's deliver streams
    with open(net.paths["spare_orderers"][0]) as f:
        spare = json.load(f)
    spare.update(port=free_port(), data_dir=os.path.join(net.root, "spare"))
    spare.pop("ops_port", None)
    os.makedirs(spare["data_dir"], exist_ok=True)
    fork = net.seed_blocks - 1
    prev = factory.get_default()
    adv = EquivocatingOrderer(spare, data_dir=spare["data_dir"],
                              crimes={"fork_height": fork, "channel": "ch"})
    factory.set_default(prev)
    try:
        check(adv.provider.name == "cuda", "orderer: the onboarding node's "
              "provider is not the CUDA provider")
        adv.join_channel(ChannelConfig.deserialize(raw2))
        targets = {"ch": height, "ch2": ch2_height}
        for cid, h in targets.items():
            adv.registrar.get(cid).chain.catchup_target = {
                "height": h, "index": 10 ** 9}
        n0 = {f: fns[f].launches for f in fns}
        t0 = time.monotonic()
        pulled = adv._replicate_once()
        onboard_s = time.monotonic() - t0
        onboard = {f: fns[f].launches - n0[f] for f in fns}
        check(pulled == sum(targets.values()) and all(
            adv.registrar.get(cid).ledger.height == h
            for cid, h in targets.items()),
            f"orderer: onboarding pulled {pulled} blocks of "
            f"{sum(targets.values())}")
        check(onboard["p256_verify"] + onboard["p256_verify_rows"]
              >= pulled, f"orderer: onboarding's signature checks "
              f"launched {onboard}, {pulled} blocks")
        phase("orderer", drill="a channel joined at runtime, onboarding",
              orderers_joined=len(alive), peers_joined_by_cli=sorted(cli),
              join_s=round(join_s, 3), ch2_first_tx_commit_s=round(tx_s, 3),
              onboarded_blocks=targets, onboard_s=round(onboard_s, 3),
              onboard_launches={k: v for k, v in onboard.items() if v},
              card=name_power)
        part("c_onboard")

        # --- (d) a spliced entry, an equivocating orderer ----------------
        lead = net.leader[0]
        follower = next(k for k in alive if k != lead)
        fb = scrape(net.ourl[follower - 1] + "/metrics")
        lsigner = ident(ocfgs[lead - 1])
        st = net.ostatus(follower)
        idx = 10 ** 6
        proposer, sig = make_entry_signer(lsigner)(
            st["term"], idx, b"the leader's batch", "normal")
        spliced = Entry(st["term"], idx, b"a spliced batch", "normal",
                        proposer, sig)
        conn = connect(("127.0.0.1", ocfgs[follower - 1]["port"]), lsigner,
                       node1.msps, timeout=10.0)
        try:
            conn.cast("raft.step", {"channel": "ch", "msg": msg_to_dict(
                Message("app", lead, follower, st["term"], index=idx - 1,
                        log_term=st["term"], entries=(spliced,)))})
            furl = net.ourl[follower - 1] + "/metrics"
            wait_until(lambda: moved_by(
                fb, scrape(furl), "orderer_entry_verifies_total",
                result="bad_entry_sig") >= 1,
                f"orderer{follower}'s bad_entry_sig", ORDERER_WAIT_S)
        finally:
            conn.close()
        fa = scrape(furl)
        check(net.ostatus(follower)["height"] == net.ostatus(lead)["height"],
              "orderer: the follower moved on the spliced entry")
        adv.rpc.start()
        src = f"{adv.signer.mspid}|{cert_fingerprint(adv.signer.cert)}"
        mon = ch1.byz_monitor
        proofs0 = len(mon.proofs)
        conn = connect(adv.rpc.addr, node1.signer, node1.msps, timeout=10.0)
        verdicts = []
        try:
            for x in conn.call_stream("deliver", seek_body(
                    node1.signer, "ch", fork, fork)):
                block = Block.deserialize(bytes(x["block"]))
                items = block_signature_items(block, ch1.msps)
                check(bool(node1.provider.batch_verify(items).all()),
                      "orderer: a served block's signature did not verify")
                verdicts.append(mon.check_block(block, src))
        finally:
            conn.close()
        new_proofs = mon.proofs[proofs0:]
        check(len(verdicts) == 2 and verdicts[0] == "stale"
              and verdicts[1] == "reject" and len(new_proofs) == 1
              and new_proofs[0]["reason"] == "fork"
              and new_proofs[0]["accused"] == src
              and node1.byzantine.is_quarantined(src),
              f"orderer: the equivocation was not convicted: {verdicts}, "
              f"{[(p['reason'], p['accused']) for p in new_proofs]}")
        phase("orderer", drill="spliced entry, equivocating orderer",
              spliced_to=f"orderer{follower}", as_leader=f"orderer{lead}",
              follower_bad_entry_sigs=moved_by(
                  fb, fa, "orderer_entry_verifies_total",
                  result="bad_entry_sig"),
              follower_dispatches=moved_by(
                  fb, fa, "provider_lane_fill_count", lane="generic"),
              equivocation_at=fork, verdicts=verdicts,
              convicted=new_proofs[0]["reason"], quarantined=True,
              card=name_power)
        part("d_byzantine")
    finally:
        adv.rpc.stop()
        for s in list(adv.cluster._senders.values()):
            s.stop()
        for support in adv.registrar.channels().values():
            support.chain.halt()
    m1 = metrics()
    for k in alive:
        # the restarted orderer's series start at its restart
        phase("orderer", orderer=k,
              role="leader" if k == net.leader[0] else "follower",
              since="its restart" if k == old else "the phase's start",
              **orderer_figures(m0[k] if k != old else {}, m1[k]),
              card=name_power)
    seconds = time.perf_counter() - t_phase
    phase("orderer", parts_s=parts, seconds=round(seconds, 1),
          budget_s=ORDERER_BUDGET_S)
    return {f: fns[f].launches - base[f] for f in fns}


def node_phase(torch, args, fns, name_power, dev,
               orderer_drill: bool = True) -> tuple:
    """Phase 16, then phase 17 on its network.  The peer as a process, on
    the card: the reference's dev network (`provision_network(n_orderers=3,
    peer_orgs=("Org1", "Org2"), peers_per_org=1, batch=BatchConfig(),
    spare_orderers=1)`, the port's provisioning; Fabric's channel
    defaults: MaxMessageCount 500, BatchTimeout 2 s, AbsoluteMaxBytes 10
    MiB); the contract `assets` (asset_demo) under AND of the orgs.  The
    ordering service: three `python -m fabric_tpu_torch.node.orderer
    <node.json>` processes, a Raft cluster, each from its provisioned
    config with no `bccsp` key (the factory's CUDA kind, fail-stop; each
    loads its kernels before its cluster clock starts); peer 1 (Org1) a
    PeerNode in this process from its provisioned config with no `bccsp`
    key, its provider behind a by-cause facade; peer 2 (Org2) `python -m
    fabric_tpu_torch.node.peer <node.json>` in a child process, also with
    no `bccsp` key; a third node of Org1 with `"bccsp": "SW"` in a child
    process of its own, following the same orderers (the identity check,
    untimed).  Ops ports on, the tracer at the node's defaults.  The
    seed: NODE_SEED_TXS `create` txs made once, stamped by peer 1's
    gateway plane (`speculative.stamp`: the creators verified in one
    batch, the endorsement sets queued) and broadcast through its
    gateway's broadcaster with the verdict attestations, 500 a call, so
    the leader's SigFilter honours the allowlisted peer's verdicts; the
    orderers cut them at 500 a block.  The load (profiled): 2 x
    NODE_CLIENTS clients in NODE_CLIENT_PROCS processes of their own
    (`node_clients`, a thread a client), half through each peer's
    gateway; each `GatewayClient.endorse`s NODE_TXS_PER_CLIENT
    `transfer`s, then every client `submit_envelope`s all of them at
    once without waiting, then asks `commit_status` of each;
    NODE_HOT_PAIRS pairs' first txs transfer one asset, so the load holds
    MVCC conflicts; one envelope with a broken creator signature, refused
    by the leader's SigFilter.  Checks: each block's flags and commit
    hash equal on the three peers, and their state and history; no tx
    ordered twice, and each commit-status code equal to its tx's
    committed flag; `fallbacks` 0; launches by cause sum to the wrappers'
    counts and every proposal's creator check launched on the card; the
    ops routes on peers 1 and 2 (peer 2's /healthz the CUDA backend, not
    degraded) and each orderer's /healthz the CUDA backend; then phase 17
    (`orderer_phase`, unless `orderer_drill` is off); then `POST /drain`
    on peers 2 and 1, peer 1 reopened on its data_dir at the same heights
    and commit hashes, and the orderers' block stores, read from disk
    after they stop, equal header for header -> (phase 16's launches by
    kernel in this process: peer 1 and the clients; phase 17's)."""
    import dataclasses
    import shutil
    import threading
    import types
    from fabric_tpu_torch.bccsp import factory
    from fabric_tpu_torch.config import BatchConfig, ChannelConfig
    from fabric_tpu_torch.msp import Principal
    from fabric_tpu_torch.policy import n_out_of, signed_by
    from fabric_tpu_torch.endorser import assemble_transaction
    from fabric_tpu_torch.gateway import GatewayClient, GatewayError
    from fabric_tpu_torch.node import peer as peer_mod
    from fabric_tpu_torch.node.orderer import load_signing_identity
    from fabric_tpu_torch.node.provision import provision_network
    from fabric_tpu_torch.protocol import Envelope
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "node")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    paths = provision_network(root, n_orderers=NODE_ORDERERS,
                              peer_orgs=("Org1", "Org2"), peers_per_org=1,
                              batch=BatchConfig(), spare_orderers=1)

    def load(path):
        with open(path) as f:
            return json.load(f)
    # one channel-config ACL override: cscc/JoinChain to any one peer
    # org's admin, so the admin CLI (one identity) may join a peer to a
    # channel at runtime in phase 17 (the default maps it to the
    # channel's Admins, a majority of the three orgs' admins)
    genesis = ChannelConfig.deserialize(bytes.fromhex(
        load(paths["orderers"][0])["channel_config_hex"]))
    genesis = dataclasses.replace(
        genesis, acls=dict(genesis.acls, **{"cscc/JoinChain": "PeerAdmins"}),
        policies=dict(genesis.policies, PeerAdmins=n_out_of(1, [
            signed_by(Principal.admin(m)) for m in ("Org1", "Org2")])))
    for path in (paths["orderers"] + paths["peers"]
                 + paths["spare_orderers"]):
        cfg = load(path)
        cfg["channel_config_hex"] = genesis.serialize().hex()
        with open(path, "w") as f:
            json.dump(cfg, f)
    ocfgs = [load(p) for p in paths["orderers"]]
    cfg1, cfg2 = (load(p) for p in paths["peers"])
    check(not any("bccsp" in c for c in ocfgs + [cfg1, cfg2]),
          "node: a provisioned node config names a bccsp")
    # the spare consenter identity is phase 17's, and never started: the
    # peers know the three running orderers only
    for cfg in (cfg1, cfg2):
        cfg["orderers"] = [["127.0.0.1", oc["port"]] for oc in ocfgs]

    def ident(path):
        c = load(path)
        return load_signing_identity(c["mspid"], c["cert_pem"].encode(),
                                     c["key_pem"].encode())
    clients = (ident(paths["clients"]["Org1"]),
               ident(paths["clients_ed25519"]["Org2"]))
    peer_ids = [load_signing_identity(c["mspid"], c["cert_pem"].encode(),
                                      c["key_pem"].encode())
                for c in (cfg1, cfg2)]

    tally, lock = {}, threading.Lock()
    procs, logs, argv_of = {}, {}, {}
    child_env = {k: v for k, v in os.environ.items()
                 if not k.startswith(("FABRIC_TPU_ORDERER_",
                                      "FABRIC_TPU_PEER_"))}
    child_env["PYTHONPATH"] = here

    def spawn(name, argv):
        """A node's process (its log appended to), as `name`."""
        argv_of[name] = argv
        if name in logs:
            logs[name].close()
        logs[name] = open(os.path.join(root, f"{name}.log"), "ab")
        procs[name] = subprocess.Popen(argv, cwd=here, env=child_env,
                                       stdout=logs[name],
                                       stderr=subprocess.STDOUT)
        return procs[name]

    def tail(name) -> str:
        logs[name].flush()
        with open(os.path.join(root, f"{name}.log"), "rb") as f:
            return f.read()[-3000:].decode(errors="replace")

    def clients_up(tag, specs):
        """A `node_clients` process a spec -> (tell, hear): `tell(word)`
        writes a step to each, `hear(word)` waits for each one's line."""
        import queue
        names, heard = [], []
        for k, spec in enumerate(specs):
            name = f"{tag}{k}"
            path = os.path.join(root, f"{name}.json")
            with open(path, "w") as f:
                json.dump(spec, f)
            logs[name] = open(os.path.join(root, f"{name}.log"), "wb")
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "sys.exit(chip_smoke.node_clients(sys.argv[1]))", path],
                cwd=here, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=logs[name], text=True, env=child_env)
            names.append(name)
            heard.append(queue.Queue())
            threading.Thread(target=lambda out, q: [q.put(line.strip())
                                                    for line in out],
                             args=(procs[name].stdout, heard[-1]),
                             daemon=True).start()

        def tell(word: str) -> None:
            for name in names:
                procs[name].stdin.write(word + "\n")
                procs[name].stdin.flush()

        def hear(word: str) -> list:
            out = []
            for name, q in zip(names, heard):
                try:
                    line = q.get(timeout=3 * NODE_WAIT_S)
                except queue.Empty:
                    line = "(nothing)"
                check(line.split(" ", 1)[0] == word, f"node: client "
                      f"process {name} said {line[:600]!r}, not {word!r} "
                      f"({tail(name)})")
                out.append(line[len(word):].strip())
            return out
        return tell, hear

    # the ordering service: three of the port's orderers, a process
    # each, on the factory's default (the card), ops ports on
    for i, oc in enumerate(ocfgs):
        oc["ops_port"] = free_port()
        path = os.path.join(root, f"orderer{i + 1}.run.json")
        with open(path, "w") as f:
            json.dump(oc, f)
        spawn(f"orderer{i + 1}", [sys.executable, "-m",
                                  "fabric_tpu_torch.node.orderer", path])
    # the children: peer 2 (the entry point, the card) and the SW node
    cfg2["ops_port"] = free_port()
    sw_dir = os.path.join(root, "peerOrg1_sw")
    cfg_sw = dict(cfg1, port=free_port(), ops_port=free_port(),
                  data_dir=sw_dir, peers=[], gateway_enabled=False,
                  bccsp="SW")
    for name, cfg in (("peer2", cfg2), ("sw", cfg_sw)):
        path = os.path.join(root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        spawn(name, [sys.executable, "-m", "fabric_tpu_torch.node.peer",
                     path])

    # the clients' processes start while block 0 is signed
    n_all = 2 * NODE_CLIENTS
    hot = {2 * j: j for j in range(NODE_HOT_PAIRS)}
    hot.update({2 * j + 1: j for j in range(NODE_HOT_PAIRS)})
    gateways = [["127.0.0.1", cfg1["port"]], ["127.0.0.1", cfg2["port"]]]
    spec0 = {"txs_per_client": NODE_TXS_PER_CLIENT, "wait_s": NODE_WAIT_S,
             "gateways": gateways,
             "identities": [paths["clients"]["Org1"],
                            paths["clients_ed25519"]["Org2"]],
             "channel_config_hex": ocfgs[0]["channel_config_hex"]}
    specs = []
    for k in range(NODE_CLIENT_PROCS):
        mine = list(range(k * n_all // NODE_CLIENT_PROCS,
                          (k + 1) * n_all // NODE_CLIENT_PROCS))
        specs.append(dict(spec0, clients=mine,
                          hot={c: hot[c] for c in mine if c in hot}))
    tell, hear = clients_up("clients", specs)

    node1 = node1_again = None
    conns = {}
    parts, t_part = {}, [t_phase]

    def part(name):
        now = time.perf_counter()
        parts[name] = round(now - t_part[0], 2)
        t_part[0] = now
    try:
        part("provision_and_spawn")
        # block 0 is signed while the children start
        seed = node_seed(clients, peer_ids, NODE_SEED_TXS)
        part("seed_sign")
        # peer 1 in this process: what the node asks of the factory is
        # recorded, and the provider it gets is put behind the facade
        asked, real_init = [], peer_mod.init_factories

        def counted_init(opts):
            asked.append(opts)
            facade = _ByCause(real_init(opts), None, tally, lock)
            facade.CALLERS = NODE_CALLERS
            factory.set_default(facade)
            return facade
        cfg1["ops_port"] = free_port()
        peer_mod.init_factories = counted_init
        try:
            node1 = peer_mod.PeerNode(cfg1, data_dir=cfg1["data_dir"])
        finally:
            peer_mod.init_factories = real_init
        check(len(asked) == 1 and asked[0].default.upper() == "CUDA"
              and not asked[0].degrade,
              f"node: peer 1 asked the factory for {asked}")
        check(node1.provider.inner.name == "cuda",
              "node: peer 1's provider is not the CUDA provider")
        ch1 = node1.channels["ch"]
        spy = _CacheSources(node1.verify_cache)
        served = [0]
        inner_pp = ch1.endorser.process_proposal

        def process_proposal(sp):
            served[0] += 1
            return inner_pp(sp)
        ch1.endorser.process_proposal = process_proposal
        commit_ms, committed_at = {}, {}
        inner_sb = ch1.committer.store_block

        def store_block(block):
            # the monotonic clock: the clients' processes share it
            t0 = time.monotonic()
            res = inner_sb(block)
            committed_at[block.header.number] = time.monotonic()
            commit_ms[block.header.number] = (
                committed_at[block.header.number] - t0) * 1e3
            return res
        ch1.committer.store_block = store_block
        node1.start()
        url1 = "http://127.0.0.1:%d" % cfg1["ops_port"]
        url2 = "http://127.0.0.1:%d" % cfg2["ops_port"]
        ourl = ["http://127.0.0.1:%d" % oc["ops_port"] for oc in ocfgs]
        for name, url in (("peer2", url2), ("sw", "http://127.0.0.1:%d"
                                             % cfg_sw["ops_port"])):
            wait_until(lambda url=url: get_url(url + "/version"),
                       f"{name}'s ops server ({tail(name)})")
        ohealth = {}
        for k, url in enumerate(ourl, 1):
            # 200 once the orderer knows a Raft leader; its provider's
            # fields are the card's
            wait_until(lambda url=url, k=k: ohealth.__setitem__(
                k, json.loads(get_url(url + "/healthz"))) or True,
                f"orderer{k}'s /healthz ({tail(f'orderer{k}')})")
            check(ohealth[k].get("status") == "OK" and ohealth[k].get(
                "bccsp") == {"name": "cuda", "backend": "cuda",
                             "degraded": False},
                f"node: orderer{k}'s /healthz {ohealth[k]}")
        part("peer1_children_and_orderers_up")
        spans2 = _BlockSpans(url2)

        def ostatus(k):
            return child_status(conns, f"orderer{k}",
                                ("127.0.0.1", ocfgs[k - 1]["port"]),
                                clients[0], node1.msps)
        leader = [0]

        def find_leader():
            for k in range(1, NODE_ORDERERS + 1):
                if f"orderer{k}" in procs and procs[f"orderer{k}"].poll() \
                        is None and ostatus(k)["role"] == "leader":
                    leader[0] = k
                    return True
            return False
        wait_until(find_leader, "a Raft leader among the orderers")
        phase("node", orderers=", ".join(
            f"orderer{k} pid {procs[f'orderer{k}'].pid} port "
            f"{ocfgs[k - 1]['port']} ops {ocfgs[k - 1]['ops_port']}"
            for k in range(1, NODE_ORDERERS + 1)), leader=leader[0],
              peer1=f"in process, ops {cfg1['ops_port']}",
              peer2=f"child pid {procs['peer2'].pid}, ops {cfg2['ops_port']}",
              sw_node=f"child pid {procs['sw'].pid}",
              batch="500 / 10 MiB / 2 s", card=name_power)

        # --- the seed ---------------------------------------------------
        base_phase = {f: fns[f].launches for f in fns}
        t0 = time.perf_counter()
        check(node1.speculative is not None and node1.gateway is not None,
              "node: peer 1 has no gateway or speculative plane")
        # what peer 1's gateway does with a batch: stamp the creators'
        # verdicts (one batched verify) and send the attestations with
        # the envelopes, which the orderer honours for an allowlisted peer
        attests = node1.speculative.stamp(seed, ["ch"] * len(seed))
        check(len(attests) == len(seed) and all(attests),
              "node: the seed's creators were not all stamped")
        stamp_s = time.perf_counter() - t0
        for lo in range(0, len(seed), SEED_BATCH):
            res = node1.gateway.broadcaster.broadcast_batch(
                seed[lo:lo + SEED_BATCH], attests=attests[lo:lo + SEED_BATCH])
            check(all(st == 200 for st, _info in res),
                  f"node: a seed broadcast was refused: {res[:2]}")
        broadcast_s = time.perf_counter() - t0 - stamp_s
        seed_blocks = -(-NODE_SEED_TXS // SEED_BATCH)
        status = {}

        def at(height, names=("peer2", "sw")):
            for name, cfg in (("peer2", cfg2), ("sw", cfg_sw)):
                if name in names:
                    status[name] = child_status(conns, name,
                                                ("127.0.0.1", cfg["port"]),
                                                clients[0], node1.msps)
            # peer 1's block store moves first, then its state and
            # history: wait for their savepoints and its commit's end
            return (height - 1 in commit_ms
                    and ch1.ledger.statedb.savepoint == height - 1
                    and ch1.ledger.historydb.savepoint == height - 1
                    and all(status[n]["height"] >= height for n in names))
        # the SW node (untimed) catches up during the load
        wait_until(lambda: at(seed_blocks, ("peer2",)),
                   f"the seed's {seed_blocks} blocks on peers 1 and 2",
                   step_s=0.1)
        seed_s = time.perf_counter() - t0
        part("seed_order_and_commit")
        check(ch1.ledger.height == seed_blocks and all(
            len(ch1.ledger.blockstore.get_by_number(n).data) == SEED_BATCH
            for n in range(seed_blocks)),
            f"node: the seed was not cut into {seed_blocks} blocks of "
            f"{SEED_BATCH}")
        seed_metrics = {k: scrape(url + "/metrics")
                        for k, url in enumerate(ourl, 1)}
        phase("node", seed_txs=NODE_SEED_TXS, sign_s=parts["seed_sign"],
              seed_blocks=seed_blocks, stamp_s=round(stamp_s, 3),
              broadcast_s=round(broadcast_s, 3),
              ordered_delivered_and_committed_on_peers_1_2_s=round(
                  seed_s, 3),
              peer1_commit_ms_sum=round(sum(
                  commit_ms[n] for n in range(seed_blocks)), 3),
              leader_attested=round(moved_by(
                  {}, seed_metrics[leader[0]],
                  "verify_plane_attested_skips_total")),
              card=name_power)

        # --- the load ---------------------------------------------------
        hear("up")
        base = {f: fns[f].launches for f in fns}
        tally0 = dict(tally)
        served0 = served[0]
        per_tx, results = [], {}
        om0 = {k: scrape(url + "/metrics") for k, url in enumerate(ourl, 1)}
        # the leader's height on the monotonic clock: each block's cut
        own = {}
        cuts = _Heights(lambda: child_status(
            own, "leader", ("127.0.0.1", ocfgs[leader[0] - 1]["port"]),
            clients[0], node1.msps)["height"])

        def run_load():
            # every client endorses its txs, then all submit at once: 512
            # envelopes reach the leader inside one BatchTimeout
            tell("endorse")
            hear("endorsed")
            tell("submit")
            for said in hear("result"):
                for (txid, e_s, s_s, t_sub, t_st, code, num, n_end, org,
                     t_end, _resub) in json.loads(said):
                    results[txid] = (code, num)
                    per_tx.append((e_s, s_s, t_st - t_sub, n_end, org, num,
                                   t_sub, t_end, t_st))
        profiled = device_busy(torch, {"load": run_load}, threaded=True)
        cut_at = cuts.stop()
        for conn in own.values():
            conn.close()
        part("load")
        n_load = n_all * NODE_TXS_PER_CLIENT
        check(len(results) == n_load, f"node: {len(results)} of {n_load} "
              "txs have a commit status")

        # one envelope with a broken creator signature
        gw = GatewayClient(tuple(gateways[0]), clients[0], node1.msps,
                           channel_id="ch", call_timeout=NODE_WAIT_S)
        try:
            sp, responses = gw.endorse("assets", "transfer", [
                f"asset{NODE_SEED_TXS - 1:05d}".encode(), b"mallory"])
            env = assemble_transaction(sp, responses, clients[0])
            sig = bytearray(env.signature)
            sig[-1] ^= 1
            refused = None
            try:
                gw.submit_envelope(Envelope(env.payload, bytes(sig)),
                                   timeout_s=NODE_WAIT_S)
            except GatewayError as exc:
                refused = str(exc)
        finally:
            gw.close()
        check(refused is not None and "SigFilter" in refused,
              f"node: the broken envelope was not refused ({refused})")
        # launches of the load and the broken envelope, by kernel and cause
        launched = {f: fns[f].launches - base[f] for f in fns}
        by_cause = {}
        for key, n in tally.items():
            d = n - tally0.get(key, 0)
            if d:
                cause, kern = key.rsplit(".", 1)
                by_cause.setdefault(cause, {})[kern] = d
        proposals = served[0] - served0

        part("broken_envelope")
        # --- checks -----------------------------------------------------
        om1 = {k: scrape(url + "/metrics") for k, url in enumerate(ourl, 1)}
        height = ostatus(leader[0])["height"]
        wait_until(lambda: at(height), f"height {height} on every node",
                   step_s=0.1)
        check(all(ostatus(k)["height"] == height
                  for k in range(1, NODE_ORDERERS + 1)),
              "node: the orderers are not at one height")
        chain1 = node_chain(ch1.ledger)
        # the load's blocks: (number, txs, cut at the count or the timeout)
        load_blocks = []
        for num in range(seed_blocks, height):
            n = len(ch1.ledger.blockstore.get_by_number(num).data)
            load_blocks.append((num, n, "count" if n == 500 else "timeout"))
        # each committed txid -> (flag, block).  A txid ordered twice (a
        # gateway's broadcast sent again after a call that failed) fails
        # the phase: its later copy is DUPLICATE_TXID, and the notifier
        # answers with a txid's last copy (ROADMAP C23)
        flag_of, twice = {}, []
        from fabric_tpu_torch.protocol.txflags import TxFlags
        from fabric_tpu_torch.protocol.types import META_TXFLAGS
        for num, _n, _why in load_blocks:
            blk = ch1.ledger.blockstore.get_by_number(num)
            flags = TxFlags.from_bytes(blk.metadata.items[META_TXFLAGS])
            for j, d in enumerate(blk.data):
                txid = Envelope.deserialize(bytes(d)).header() \
                    .channel_header.txid
                if txid in flag_of:
                    twice.append((txid, flag_of[txid][1], num))
                else:
                    flag_of[txid] = (int(flags.flag(j)), num)
        check(not twice,
              f"node: {len(twice)} txs ordered twice {twice[:3]}; peer 1's "
              f"broadcaster {node1.gateway.broadcaster.states()}; peer 2's "
              f"/gateway {get_url(url2 + '/gateway')[:1500]}")
        wrong = [(t, r, flag_of.get(t)) for t, r in results.items()
                 if flag_of.get(t) != r]
        check(not wrong, f"node: {len(wrong)} commit statuses differ from "
              f"the committed flag: {wrong[:3]}")
        codes = [code for code, _num in flag_of.values()]
        conflicts, valid = codes.count(11), codes.count(0)
        check(set(flag_of) == set(results) and conflicts >= 1
              and valid + conflicts == n_load,
              f"node: load codes: {valid} valid, {conflicts} MVCC, "
              f"{n_load - valid - conflicts} other")
        check(node1.provider.stats.get("fallbacks", 0) == 0,
              f"node: fallbacks {node1.provider.stats.get('fallbacks')}")
        caused = sum(n for kerns in by_cause.values() for n in kerns.values())
        total = sum(launched[f] for f in ("p256_verify_rows", "p256_verify",
                                          "ed25519_verify_rows",
                                          "ed25519_verify"))
        check(caused == total, f"node: launches by cause {caused} != the "
              f"wrappers' {total}: {by_cause}")
        creator_launches = sum(by_cause.get("proposal", {}).values())
        check(proposals > 0 and creator_launches == proposals,
              f"node: {proposals} proposals at peer 1, {creator_launches} "
              "creator checks launched on the card")

        routes = {}
        for name, url in (("peer1", url1), ("peer2", url2)):
            # a deliver pull refused while the orderers started marks the
            # peer unhealthy until its next window ends (5 s at the tip)
            wait_until(lambda url=url: json.loads(get_url(
                url + "/healthz"))["status"] == "OK",
                f"{name}'s /healthz OK", 30.0, 0.2)
            for route in NODE_ROUTES:
                doc = json.loads(get_url(url + route))
                routes[(name, route)] = sorted(doc) if isinstance(
                    doc, dict) else type(doc).__name__
            health = json.loads(get_url(url + "/healthz"))
            check(health.get("status") == "OK" and health.get("bccsp") == {
                "name": "cuda", "backend": "cuda", "degraded": False},
                f"node: {name}'s /healthz {health}")
        check(routes[("peer1", "/healthz")] == routes[("peer2", "/healthz")]
              and all(routes[("peer1", r)] == routes[("peer2", r)]
                      for r in NODE_ROUTES),
              f"node: the two peers' routes differ: {routes}")
        for k, url in enumerate(ourl, 1):
            health = json.loads(get_url(url + "/healthz"))
            check(health.get("status") == "OK" and health.get("bccsp") == {
                "name": "cuda", "backend": "cuda", "degraded": False},
                f"node: orderer{k}'s /healthz {health}")
        block_ms2 = spans2.stop()
        part("flags_routes_spans")

        # --- figures ----------------------------------------------------
        # the phase's launches in this process (the seed and the load)
        node_launches = {f: fns[f].launches - base_phase[f] for f in fns}
        busy_ms, wall_ms, top = profiled["load"]
        e_ms = [e * 1e3 for e, *_ in per_tx]
        s_ms = [s * 1e3 for _e, s, *_ in per_tx]
        c_ms = [c * 1e3 for _e, _s, c, *_ in per_tx]
        # submit to the end of its block's commit at peer 1 (its clock)
        k_ms = [(committed_at[num] - t_sub) * 1e3
                for *_x, num, t_sub, _te, _ts in per_tx]
        span_s = (max(x[8] for x in per_tx) - min(x[7] for x in per_tx))
        count_cut = [n for _num, n, why in load_blocks if why == "count"]
        # the first submit to each load block's cut at the leader (the
        # timeout's 2 s start at the first envelope pending)
        t_first_sub = min(x[6] for x in per_tx)
        cut_s = {num: round(cut_at[num] - t_first_sub, 3)
                 for num, _n, _why in load_blocks if num in cut_at}
        print(name_power, flush=True)
        phase("node", load_txs=n_load, clients=2 * NODE_CLIENTS,
              endorsements_per_tx=sorted({x[3] for x in per_tx}),
              endorse_p50_ms=round(pct(e_ms, 0.5), 3),
              endorse_p99_ms=round(pct(e_ms, 0.99), 3),
              submit_p50_ms=round(pct(s_ms, 0.5), 3),
              submit_p99_ms=round(pct(s_ms, 0.99), 3),
              submit_to_status_p50_ms=round(pct(c_ms, 0.5), 3),
              submit_to_status_p99_ms=round(pct(c_ms, 0.99), 3),
              submit_to_peer1_commit_p50_ms=round(pct(k_ms, 0.5), 3),
              submit_to_peer1_commit_p99_ms=round(pct(k_ms, 0.99), 3),
              committed_tx_per_s=round(n_load / span_s, 1),
              valid=valid, mvcc_conflicts=conflicts, ordered_twice=0,
              blocks_cut_at_count=count_cut, first_submit_to_cut_s=cut_s,
              first_endorse_to_last_status_s=round(span_s, 3),
              card=name_power)
        phase("node", blocks=[list(b) for b in load_blocks],
              peer1_validate_commit_ms={k: round(v, 3)
                                        for k, v in sorted(
                                            commit_ms.items())
                                        if k >= seed_blocks},
              peer2_validate_commit_ms={k: round(v, 3)
                                        for k, v in sorted(
                                            block_ms2.items())
                                        if k >= seed_blocks},
              refused=refused[:80])
        for k in range(1, NODE_ORDERERS + 1):
            # each orderer's own process, over the load and the broken
            # envelope: its broadcast spans, its SigFilter's device
            # verifies, its Raft entry verifies, its provider's
            # dispatches by lane and their resolve seconds
            phase("node", orderer=k,
                  role="leader" if k == leader[0] else "follower",
                  **orderer_figures(om0[k], om1[k]),
                  card=name_power)
        phase("node", launches_by_cause={
            c: by_cause[c] for c in NODE_CAUSES if c in by_cause},
              load_launches=launched, proposals_at_peer1=proposals,
              creator_checks_on_card=creator_launches,
              cache_hits_by_source=dict(spy.hits),
              device_busy_ms=round(busy_ms, 3), wall_ms=round(wall_ms, 3),
              device_idle_share=round(1 - busy_ms / wall_ms, 4),
              top_device_ops=top, fallbacks=0, card=name_power)

        # --- phase 17 on this network -----------------------------------
        orderer_launches = {}
        if orderer_drill:
            orderer_launches = orderer_phase(torch, types.SimpleNamespace(
                root=root, paths=paths, ocfgs=ocfgs, ourl=ourl, cfg1=cfg1,
                cfg2=cfg2, node1=node1, ch1=ch1, clients=clients,
                procs=procs, spawn=spawn, argv_of=argv_of, tail=tail,
                ostatus=ostatus, find_leader=find_leader, leader=leader,
                at=at, spec0=spec0, clients_up=clients_up,
                committed_at=committed_at, seed_blocks=seed_blocks,
                tally=tally, lock=lock), fns, name_power)
            height = ostatus(leader[0])["height"]
            wait_until(lambda: at(height), f"height {height} on every node "
                       "after phase 17", step_s=0.1)
            chain1 = node_chain(ch1.ledger)
        # --- phase 18 (c): the port's top on this network ---------------
        heights = {"peer1": ch1.ledger.height}
        for name, cfg in (("peer2", cfg2), ("sw", cfg_sw)):
            heights[name] = child_status(conns, name, ("127.0.0.1",
                                                       cfg["port"]),
                                         clients[0], node1.msps)["height"]
        top_phase(dict({f"orderer{k}": "127.0.0.1:%d" % oc["ops_port"]
                        for k, oc in enumerate(ocfgs, 1)},
                       **{name: "127.0.0.1:%d" % cfg["ops_port"]
                          for name, cfg in (("peer1", cfg1), ("peer2", cfg2),
                                            ("sw", cfg_sw))}),
                  heights, name_power)
        t_tail = time.perf_counter()

        # drain the children, stop them, read their ledgers
        for conn in conns.values():
            conn.close()
        conns.clear()
        drained = {}
        for name, cfg in (("peer2", cfg2), ("sw", cfg_sw)):
            drained[name] = post_url("http://127.0.0.1:%d/drain"
                                     % cfg["ops_port"])
            procs[name].terminate()
            procs[name].wait(timeout=30)
        others = {}
        for name, cfg in (("peer2", cfg2), ("sw", cfg_sw)):
            ledger = node_ledger(cfg["data_dir"])
            others[name] = (node_chain(ledger), ledger_rows(ledger))
        rows1 = ledger_rows(ch1.ledger)
        for name, (chain, rows) in others.items():
            check(chain == chain1, f"node: {name}'s flags or commit hashes "
                  "differ from peer 1's")
            check(rows == rows1, f"node: {name}'s state or history differs "
                  "from peer 1's")
        # drain peer 1 and reopen it on its data_dir
        drain1 = post_url(url1 + "/drain")
        check(drain1["lifecycle"] == "drained"
              and json.loads(get_url(url1 + "/healthz"))["lifecycle"]
              == "drained", f"node: peer 1's drain {drain1}")
        before = (ch1.ledger.height, ch1.ledger.commit_hash)
        node1.stop()
        node1, closed = None, node1
        del closed
        node1_again = peer_mod.PeerNode(dict(cfg1, port=0, ops_port=None),
                                        data_dir=cfg1["data_dir"])
        again = node1_again.channels["ch"].ledger
        check((again.height, again.commit_hash) == before,
              "node: peer 1 reopened at another height or commit hash")
        # the orderers stop; their block stores, read from disk, hold one
        # chain a channel, header for header
        for k in range(1, NODE_ORDERERS + 1):
            proc = procs[f"orderer{k}"]
            proc.terminate()
            proc.wait(timeout=30)
        stores = orderer_chains(ocfgs)
        for cid, chains in stores.items():
            check(len(chains) == NODE_ORDERERS and all(
                c == chains[0] for c in chains[1:]) and chains[0],
                f"node: the orderers' {cid} block stores differ: "
                f"{[len(c) for c in chains]} blocks")
        check(len(stores["ch"][0]) == before[0],
              f"node: the orderers hold {len(stores['ch'][0])} blocks of ch, "
              f"peer 1 {before[0]}")
        phase("node", nodes_equal="flags, commit hashes, state, history "
              f"at {before[0]} blocks", commit_status="== flags",
              routes="answer on both peers", healthz="cuda, not degraded "
              "on peer 2 and the three orderers",
              drained=drained["peer2"]["lifecycle"],
              reopened=f"height {before[0]}",
              orderer_stores={cid: len(c[0]) for cid, c in stores.items()},
              parts_s=parts, tail_s=round(time.perf_counter() - t_tail, 1),
              seconds=round(time.perf_counter() - t_phase, 1))
        return node_launches, orderer_launches
    finally:
        for conn in conns.values():
            conn.close()
        for node in (node1, node1_again):
            if node is not None:
                try:
                    node.stop()
                except Exception:
                    pass
        if node1_again is not None:
            node1_again.rpc.stop()
        for name, proc in procs.items():
            if proc.stdin is not None:
                proc.stdin.close()
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            logs[name].close()


def node_only(torch, args, orderer_drill: bool = False) -> int:
    """`--node-only`: phase 16 alone; `--orderer-only`: phases 16 and 17.
    Builds the kernels and the C parts, then runs `node_phase`; prints
    no result line."""
    from fabric_tpu_torch import native
    from fabric_tpu_torch.ops import _build, ed25519, p256, p256_fixed
    built = _build.build_all(force=True)
    phase("build", libs=sorted(built))
    native.build("der")
    for ext in native.EXTENSIONS:
        native.build_extension(ext)
    fns = {"p256_verify_rows": p256_fixed.p256_verify_rows,
           "p256_verify": p256.p256_verify,
           "ed25519_verify_rows": ed25519.ed25519_verify_rows,
           "ed25519_verify": ed25519.ed25519_verify}
    node_phase(torch, args, fns, smi("name,power.limit"),
               torch.device("cuda"), orderer_drill=orderer_drill)
    phase("done", by_phase={k: round(v, 1) for k, v in _PHASE_S.items()})
    return 0


# ---------------------------------------------------------------------------
# 18. the workload plane
# ---------------------------------------------------------------------------

WORKLOAD_SCENARIO = "membership-churn"   # the catalog scenario on the card
WORKLOAD_SEED = 7
WORKLOAD_CLI = ["--scenario", "burst", "--rate", "30", "--duration", "8",
                "--seed", "7"]           # the load shape through the CLI
WORKLOAD_WAIT_S = 300.0        # bound on the CLI child
WORKLOAD_KERNELS = ("p256_verify_rows", "p256_verify", "ed25519_verify_rows",
                    "ed25519_verify")


def workload_child_env(here: str) -> dict:
    """A child's environment: no `FABRIC_TPU_*` setting of ours, so
    its nodes take their defaults; the checkout on its path."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FABRIC_TPU_")}
    env["PYTHONPATH"] = here
    return env


def workload_phase(torch, fns, name_power) -> dict:
    """Phase 18 (a) and (b): the workload plane on the card.
    (a) `run_scenario(WORKLOAD_SCENARIO, seed=7, strict=True)` with the
        default provider (the card), in this process: the catalog's
        membership churn (scenarios.py: three orderers and a spare, Org1
        and Org2 with a peer each, 10 tx/s open loop for 14 s; at 2 s the
        spare is added by an add-consenter config entry through the Raft
        log, started, handed leadership, then orderer1 is removed by a
        second entry and killed).  Held: the SLO passes with its 5
        checks; every node built is on the CUDA provider with no
        fallback; KP3 and KP2 launched, KP2 also beyond the orderers'
        start-up warm launches (the load's own checks: at 10 tx/s no key
        brings the 64 signatures to one batch that earn it a KP3 table);
        each orderer still running verified Raft entry
        signatures (`EntryVerifier.verifies`, its share of
        orderer_entry_verifies_total).  Printed: offered, accepted and
        committed per phase, sojourn p50/p99, committed tx/s, the drill's
        timeline (add, start, leadership, remove, kill) in seconds from
        the call, launches by kernel, the wall time.
    (b) `python -m fabric_tpu_torch.workload <WORKLOAD_CLI> --json-out
        build/workload/burst.json` in a child process on its default
        provider (the card), its log build/workload/burst.log.  Held:
        exit 0, offered > 0 and committed >= 1.  Printed: the gateway's
        admission snapshot (shed by level).
    -> (a)'s launches by kernel (this process)."""
    import shutil
    import threading
    from fabric_tpu_torch.node.orderer import OrdererNode
    from fabric_tpu_torch.testing import chaos
    from fabric_tpu_torch.workload import scenarios
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "workload")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.monotonic()
    built, timeline, warm, lock = [], [], [], threading.Lock()

    def at():
        return round(time.monotonic() - t0, 3)
    real_build, real_restart = chaos.ChaosNet._build, chaos.ChaosNet.restart
    real_kill, real_admin = chaos.ChaosNet.kill, scenarios._admin_call
    real_warm = OrdererNode.warm_kernels

    def build(self, name):
        node = real_build(self, name)
        built.append((name, node))
        return node

    def restart(self, name, *a, **kw):
        timeline.append(("start", name, at()))
        return real_restart(self, name, *a, **kw)

    def kill(self, name):
        timeline.append(("kill", name, at()))
        return real_kill(self, name)

    def admin_call(net, admin, msps, method, body, *a, **kw):
        who, resp = real_admin(net, admin, msps, method, body, *a, **kw)
        timeline.append((method.split(".", 1)[1], who,
                         (resp or {}).get("status"), at()))
        return who, resp

    def warm_kernels(self):
        with lock:
            before = {f: fns[f].launches for f in WORKLOAD_KERNELS}
            out = real_warm(self)
            warm.append({f: fns[f].launches - before[f]
                         for f in WORKLOAD_KERNELS})
        return out
    base = {f: fns[f].launches for f in fns}
    chaos.ChaosNet._build, chaos.ChaosNet.restart = build, restart
    chaos.ChaosNet.kill, scenarios._admin_call = kill, admin_call
    OrdererNode.warm_kernels = warm_kernels
    verifiers = {}
    real_stop_all = chaos.ChaosNet.stop_all
    try:
        def stop_all(self):
            # the orderers still running, read before they stop
            for name, node in self.nodes.items():
                if self._specs[name][0] == "orderer":
                    verifiers[name] = sum(
                        v.verifies for v in node.cluster._verifiers.values())
            return real_stop_all(self)
        chaos.ChaosNet.stop_all = stop_all
        report = scenarios.run_scenario(
            WORKLOAD_SCENARIO, seed=WORKLOAD_SEED,
            base_dir=os.path.join(root, "mc"),
            report_path=os.path.join(root, "mc.json"), strict=True)
    finally:
        chaos.ChaosNet._build, chaos.ChaosNet.restart = real_build, \
            real_restart
        chaos.ChaosNet.kill, scenarios._admin_call = real_kill, real_admin
        chaos.ChaosNet.stop_all = real_stop_all
        OrdererNode.warm_kernels = real_warm
    wall_s = time.monotonic() - t0
    launched = {f: fns[f].launches - base[f] for f in fns}
    slo = report["slo"]
    names = sorted(n for n, _ in built)
    # the three first orderers warm up one at a time before the load; the
    # spare's warm-up overlaps it, so it is taken to launch what they did
    beyond = {f: launched[f] - len(warm) * warm[0][f]
              for f in WORKLOAD_KERNELS} if warm else {}
    tot = report["totals"]
    churn = report["membership_churn"]
    print(name_power, flush=True)
    phase("workload", scenario=WORKLOAD_SCENARIO, seed=WORKLOAD_SEED,
          slo=f"pass={slo['pass']} ({slo['checks']} checks)",
          phases=[(p["name"], p["offered"], p["accepted"], p["committed"],
                   p["conflicts"]) for p in report["phases"]],
          sojourn_p50_ms=(tot["sojourn_ms"] or {}).get("p50"),
          sojourn_p99_ms=(tot["sojourn_ms"] or {}).get("p99"),
          commit_p50_ms=(tot["commit_ms"] or {}).get("p50"),
          commit_p99_ms=(tot["commit_ms"] or {}).get("p99"),
          committed_tx_per_s=tot["committed_rate"],
          offered_tx_per_s=tot["offered_rate"], card=name_power)
    phase("workload", drill={k: churn.get(k) for k in (
        "spare", "added_joined", "leader_transferred", "removed_isolated",
        "removed_self_evicted", "error")}, timeline_s=timeline,
          entry_verifies=verifiers, nodes=names,
          providers={n: (node.provider.name,
                         node.provider.stats.get("fallbacks"))
                     for n, node in built})
    phase("workload", launches=launched, warm_ups=len(warm),
          warm_launches={f: sum(w[f] for w in warm)
                         for f in WORKLOAD_KERNELS},
          beyond_warm=beyond, wall_s=round(wall_s, 1))
    check(slo["pass"] and slo["checks"] == 5,
          f"workload: {WORKLOAD_SCENARIO} SLO {slo}")
    check(names == ["orderer1", "orderer2", "orderer3", "orderer4",
                    "peerOrg1_0", "peerOrg2_0"],
          f"workload: nodes built {names}")
    for name, node in built:
        prov = node.provider
        check(prov.name == "cuda" and prov.stats.get("fallbacks", 0) == 0,
              f"workload: {name}'s provider {prov.name} "
              f"{getattr(prov, 'stats', None)}")
    check(len(warm) == 4 and warm[0] == warm[1] == warm[2],
          f"workload: the orderers' warm launches {warm}")
    for f in ("p256_verify_rows", "p256_verify"):
        check(launched[f] > 0, f"workload: {f} not launched on the card")
    # the traffic's own checks reach the card (past the start-up warm-up)
    check(beyond["p256_verify"] > 0, "workload: no P-256 check of the "
          f"load launched on the card ({launched})")
    remaining = sorted(verifiers)
    check(remaining == ["orderer2", "orderer3", "orderer4"]
          and all(verifiers[n] > 0 for n in remaining),
          f"workload: Raft entry verifies by orderer {verifiers}")

    # (b) a load shape through the CLI, in a child on the card
    out = os.path.join(root, "burst.json")
    env = workload_child_env(here)
    t1 = time.monotonic()
    with open(os.path.join(root, "burst.log"), "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fabric_tpu_torch.workload",
             *WORKLOAD_CLI, "--json-out", out], cwd=here, env=env,
            stdout=log, stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=WORKLOAD_WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
    with open(os.path.join(root, "burst.log"), "rb") as f:
        tail = f.read()[-3000:].decode(errors="replace")
    check(rc == 0, f"workload: the CLI exited {rc} ({tail})")
    with open(out) as f:
        cli = json.load(f)
    ctot = cli["totals"]
    check(ctot["offered"] > 0 and ctot["committed"] >= 1,
          f"workload: the CLI's totals {ctot}")
    adm = cli.get("admission") or {}
    phase("workload", cli=" ".join(WORKLOAD_CLI),
          phases=[(p["name"], p["offered"], p["accepted"], p["shed"],
                   p["committed"]) for p in cli["phases"]],
          committed_tx_per_s=ctot["committed_rate"],
          sojourn_p99_ms=(ctot["sojourn_ms"] or {}).get("p99"),
          admission={k: adm[k] for k in sorted(adm)
                     if k not in ("transitions",)},
          transitions=len(adm.get("transitions") or ()),
          client_sheds=cli["clients"]["sheds"],
          child_s=round(time.monotonic() - t1, 1), card=name_power)
    return launched


def top_phase(targets: dict, heights: dict, name_power) -> None:
    """Phase 18 (c), on phase 16's network before its drains: the port's
    `top.collect_node` on every orderer's and peer's ops address
    (`targets`: name -> host:port), `render`, then `python -m
    fabric_tpu_torch.node.top --targets <all> --once` as a child.  Held:
    every row up and the child's exit 0 with every address in its frame;
    each peer's row height equals its ledger's (`heights`); peer 1's row
    reads its slot series on device cuda:0."""
    from fabric_tpu_torch.node import top
    here = os.path.dirname(os.path.abspath(__file__))
    rows = {name: top.collect_node(addr, timeout=10.0)
            for name, addr in targets.items()}
    down = sorted(n for n, r in rows.items() if not r["up"])
    check(not down, f"workload: top rows down {down}: "
          f"{[rows[n].get('error') for n in down]}")
    for name, h in heights.items():
        check(rows[name]["height"] == h, f"workload: top's height for "
              f"{name} {rows[name]['height']} != its ledger's {h}")
    check("cuda:0" in (rows["peer1"].get("devices") or {}),
          f"workload: peer 1's device cell {rows['peer1'].get('devices')}")
    table = top.render(list(rows.values()))
    res = subprocess.run(
        [sys.executable, "-m", "fabric_tpu_torch.node.top", "--targets",
         ",".join(targets.values()), "--once", "--timeout", "10"],
        cwd=here, env=workload_child_env(here), capture_output=True,
        text=True, timeout=120)
    check(res.returncode == 0 and all(a in res.stdout
                                      for a in targets.values())
          and "DOWN" not in res.stdout,
          f"workload: top --once exited {res.returncode}: "
          f"{res.stdout[-1500:]} {res.stderr[-1500:]}")
    os.makedirs(os.path.join(here, "build", "workload"), exist_ok=True)
    with open(os.path.join(here, "build", "workload", "top.txt"), "w") as f:
        f.write(table + "\n\n" + res.stdout)
    phase("workload", top_rows={n: {"height": r["height"],
                                    "devices": r.get("devices"),
                                    "health": r.get("health"),
                                    "occupancy": r.get("occupancy")}
                                for n, r in rows.items()},
          top_child="exit 0, every row up", card=name_power)
    for line in table.splitlines():
        print("   ", line, flush=True)


def workload_only(torch, args) -> int:
    """`--workload-only`: phase 18 (a) and (b) alone (its (c) needs phase
    16's network).  Builds the kernels and the C parts first; prints no
    result line."""
    from fabric_tpu_torch import native
    from fabric_tpu_torch.ops import _build, ed25519, p256, p256_fixed
    built = _build.build_all(force=True)
    phase("build", libs=sorted(built))
    native.build("der")
    for ext in native.EXTENSIONS:
        native.build_extension(ext)
    fns = {"p256_verify_rows": p256_fixed.p256_verify_rows,
           "p256_verify": p256.p256_verify,
           "ed25519_verify_rows": ed25519.ed25519_verify_rows,
           "ed25519_verify": ed25519.ed25519_verify}
    workload_phase(torch, fns, smi("name,power.limit"))
    phase("done", by_phase={k: round(v, 1) for k, v in _PHASE_S.items()})
    return 0


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
    ap.add_argument("--ops-only", action="store_true",
                    help="phase 6's ops-plane check alone (the commit "
                    "stream, then a warm block 2 read back over HTTP); "
                    "prints no result line")
    ap.add_argument("--intake-only", action="store_true",
                    help="phase 14 alone (the kernels, the commit stream "
                    "and its host-stack rows, then the intake); prints no "
                    "result line")
    ap.add_argument("--endorse-only", action="store_true",
                    help="phase 15 alone (the kernels, then the "
                    "endorsement side); prints no result line")
    ap.add_argument("--node-only", action="store_true",
                    help="phase 16 alone (the kernels, then the peer "
                    "node); prints no result line")
    ap.add_argument("--orderer-only", action="store_true",
                    help="phases 16 and 17 alone (the kernels, the peer "
                    "node behind the port's Raft orderers, then the "
                    "ordering service's drills); prints no result line")
    ap.add_argument("--workload-only", action="store_true",
                    help="phase 18's catalog scenario and CLI load shape "
                    "alone (the kernels, then the workload plane); prints "
                    "no result line")
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
    if args.ops_only:
        return ops_only(torch, args)
    if args.intake_only:
        return intake_only(torch, args)
    if args.endorse_only:
        return endorse_only(torch, args)
    if args.node_only or args.orderer_only:
        return node_only(torch, args, orderer_drill=args.orderer_only)
    if args.workload_only:
        return workload_only(torch, args)

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
    exp_results = experiments_phase(torch, dev, args.trials)
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

    # --- 14. intake ----------------------------------------------------------
    intake_launches = intake_phase(
        torch, args, provider, orgs, commit_raws, mem_rows,
        fns, name_power, dev)
    del mem_rows

    # --- 15. endorse ---------------------------------------------------------
    endorse_launches = endorse_phase(torch, args, provider, fns, name_power,
                                     dev)

    # --- 16. node, 17. orderer (18 (c), top, on their network) -------------
    node_launches, orderer_launches = node_phase(torch, args, fns,
                                                 name_power, dev)

    # --- 18. workload ------------------------------------------------------
    workload_launches = workload_phase(torch, fns, name_power)

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
        # phases 12's, 13's, 14's, 15's, 16's, 17's and 18's main-path
        # launches, each in its own count
        row["classic_launches"] = classic_launches.get(row["name"], 0)
        row["window_launches"] = window_launches.get(row["name"], 0)
        row["intake_launches"] = intake_launches.get(row["name"], 0)
        row["endorse_launches"] = endorse_launches.get(row["name"], 0)
        row["node_launches"] = node_launches.get(row["name"], 0)
        row["orderer_launches"] = orderer_launches.get(row["name"], 0)
        row["workload_launches"] = workload_launches.get(row["name"], 0)
    phase("done", seconds=round(time.perf_counter() - t_start, 1),
          by_phase={k: round(v, 1) for k, v in _PHASE_S.items()})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
