#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (fabric_tpu_torch).

Drives the port's main paths at the size of real blocks, holds every
hand-written kernel against its plain PyTorch version, times them, and
ends with one JSON line.  Phases:

1. device  — the card's name and power limit; aborts without CUDA
2. build   — nvcc builds every kernel from fabric_tpu_torch/ops/csrc/
             (KP1-KP3, KE5, KE6, one nvcc each, all at once), cc the C
             DER parser from fabric_tpu_torch/native/
3. field   — KP1 (field_mul_chain) against its plain version and Python
             ints, mod p, mod n and mod p25519, edge values included
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
             their plain versions on their whole batches
6. times   — medians of repeated runs (CUDA events for kernels); each
             kernel's plain version is timed by its one comparison call
             on the path's own batch for that kernel; one large pinned
             host-to-device copy gives the link rate that bounds a table
             upload
7. kernels — one JSON line per the port's kernel table, then the result

Each main-path run (block cold and warm, config 2 cold and warm, config
3, the generic load) sets every launch count to 0 just before it and
reads the counts just after; the block launches KP3, KP2 (the off-curve
keys of the corrupted items) and KE5, config 2 only KE6, config 3 KP3,
KP2 and KE6, the generic load KE5.  KP1 is the field layer's benchmark
kernel and is not on a main path: its count there is 0.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--txs N] [--ed N] [--gen N] [--trials K]

Any failed check raises, so the script exits non-zero and prints no
result line.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
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
CHAIN_K = 256
SPILL_TXS = 500
H2D_BYTES = 1 << 28            # the one large copy that gives the link rate

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


def phase(tag: str, **kv) -> None:
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


def device_busy(torch, fn):
    """One profiled call of fn (which synchronises): -> (device busy ms,
    wall ms, the three ops with the most device time).  Busy time is the
    sum of self device time over all ops: one stream, so nothing
    overlaps."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, ev.key))
    rows.sort(reverse=True)
    top = [f"{key[:40]}:{us / 1e3:.3f}ms" for us, key in rows[:3]]
    return sum(us for us, _ in rows) / 1e3, wall_ms, top


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--txs", type=int, default=10_000,
                    help="transactions in the block (4 signatures each)")
    ap.add_argument("--ed", type=int, default=10_000,
                    help="Ed25519 signatures of BASELINE config 2")
    ap.add_argument("--gen", type=int, default=4096,
                    help="Ed25519 items of the generic load")
    ap.add_argument("--trials", type=int, default=5,
                    help="timed repetitions per measurement")
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
    from fabric_tpu_torch.ops import (_build, ed25519, ed25519_tables,
                                      field, p256, p256_fixed, p256_tables)

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
        rinv = pow(R, -1, m)
        for k in (0, 1, 8):
            got = field.field_mul_chain(a, b, k, mod)
            plain = field.mul_chain_plain(a, b, k, mod)
            torch.cuda.synchronize()
            got_i = field.words_le_to_ints(got)
            want = [x * pow(y * rinv, k, m) % m
                    for x, y in zip(vals_a, vals_b)]
            check(got_i == want, f"KP1 mod {mod} k={k} != python ints")
            check(torch.equal(got, plain),
                  f"KP1 mod {mod} k={k} != mul_chain_plain")
            field_err = max(field_err, max(
                abs(g - p) for g, p in zip(got_i,
                                           field.words_le_to_ints(plain))))
        phase("field", modulus=mod, lanes=FIELD_LANES, k="0,1,8",
              vs_ints="equal", vs_plain="equal")

    # --- 4. block ----------------------------------------------------------
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
           "field_mul_chain": field.field_mul_chain}
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

    def timed_build(pk):
        t = time.perf_counter()
        tab = build_fn(pk)
        build_s.append(time.perf_counter() - t)
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

    # --- 6. times ----------------------------------------------------------
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

    # KP2 on the whole block's device-bound words, as in slice 1
    recs, _ = cudaprov.parse_p256(p256_items, range(n_p256))
    keep, arrays = cudaprov.pack_p256_recs(recs)
    block_words = [torch.from_numpy(a).to(dev) for a in arrays]
    kp2_ms = event_ms(torch, lambda: p256.p256_verify(*block_words, table), t)
    kern = p256.p256_verify(*block_words, table)
    plain, plain_ms = timed_once(torch, lambda: (
        p256.verify_words_plain(*block_words, table)))
    check(torch.equal(kern, plain), "KP2 != verify_words_plain on the block")
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

    muls, imads = chain_muls, p256.imads_per_launch()
    for qx_, qy_, r_, s_, e_ in zip(*[ints(a) for a in arrays]):
        w = pow(s_ % n, n - 2, n)
        u1, u2 = e_ * w % n, r_ * w % n
        muls += sum(p256.field_ops_per_verify(u1, u2).values())
        imads += p256.imads_per_verify(u1, u2)
    kp2_ops_s = imads / imad_rate
    kp2_bytes_s = (lanes * (5 * 32 + 1) + table.nbytes) / HBM_BYTES_PER_S
    kp2_bound_ms = max(kp2_ops_s, kp2_bytes_s) * 1e3
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

    busy_ms, wall_ms, top = device_busy(torch, lambda: provider.batch_verify(
        items))
    c2_busy_ms, c2_wall_ms, c2_top = device_busy(
        torch, lambda: provider.batch_verify(c2_items))

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
          kp3_bound_by="operations" if kp3_ops_s >= kp3_bytes_s else "bytes")
    phase("times", kp2_ms=round(kp2_ms, 4), kp2_sigs=lanes,
          plain_ms=round(plain_ms, 2), kp2_vs_plain_on_block="equal",
          mont_muls_per_verify=round(muls / lanes, 1),
          imads_per_verify=round(imads / lanes, 1),
          kp2_bound_ms=round(kp2_bound_ms, 4))
    phase("times", ke6_ms=round(ke6_ms, 4), ke6_sigs=ke6_lanes,
          ke6_plain_ms=round(ke6_plain_ms, 2),
          mont_muls_per_verify=round(e6_ops / ke6_lanes, 1),
          imads_per_verify=round(e6_imads / ke6_lanes, 1),
          ke6_bound_ms=round(ke6_bound_ms, 4))
    phase("times", ke5_ms=round(ke5_ms, 4), ke5_sigs=ke5_lanes,
          ke5_plain_ms=round(ke5_plain_ms, 2),
          mont_muls_per_verify=round(e5_ops / ke5_lanes, 1),
          imads_per_verify=round(e5_imads / ke5_lanes, 1),
          ke5_bound_ms=round(ke5_bound_ms, 4))
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
    for run, (b_ms, w_ms, tp) in (("block", (busy_ms, wall_ms, top)),
                                  ("config2", (c2_busy_ms, c2_wall_ms,
                                               c2_top))):
        if b_ms > 0:
            phase("times", profiled=run, wall_ms=round(w_ms, 3),
                  device_busy_ms=round(b_ms, 3),
                  device_idle_share=round(1 - b_ms / w_ms, 4),
                  top_device_ops=tp)
        else:
            phase("times", profiled=run, device_idle_share="not measured "
                  "(the profiler recorded no device time)")
    phase("times", library="none: no PyTorch call computes ECDSA or "
          "Ed25519 verify (any lane) or a Montgomery multiply chain")

    # --- 7. kernels ----------------------------------------------------------
    def by(ops_s, bytes_s):
        return "operations" if ops_s >= bytes_s else "bytes"

    phase("kernels", main_path_launches=total,
          runs="block cold+warm, config 2 cold+warm, config 3, generic load")
    kernels = [
        {"name": "p256_verify_rows", "route": "cuda",
         "source": "fabric_tpu_torch/ops/csrc/p256_verify_rows.cu",
         "replaces": "fabric_tpu/ops/p256_fixed.py:94",
         "launches": total["p256_verify_rows"], "max_abs_err": kp3_err,
         "ms": kp3_ms, "plain_ms": kp3_plain_ms, "bound_ms": kp3_bound_ms,
         "bound_by": by(kp3_ops_s, kp3_bytes_s),
         "library_ms": None, "on_main_path": True},
        {"name": "p256_verify", "route": "cuda",
         "source": "fabric_tpu_torch/ops/csrc/p256_verify.cu",
         "replaces": "fabric_tpu/ops/ecp256.py:447",
         "launches": total["p256_verify"], "max_abs_err": kp2_err,
         "ms": kp2_ms, "plain_ms": plain_ms, "bound_ms": kp2_bound_ms,
         "bound_by": by(kp2_ops_s, kp2_bytes_s),
         "library_ms": None, "on_main_path": True},
        {"name": "ed25519_verify_rows", "route": "cuda",
         "source": "fabric_tpu_torch/ops/csrc/ed25519_verify_rows.cu",
         "replaces": "fabric_tpu/ops/ed25519.py:75",
         "launches": total["ed25519_verify_rows"], "max_abs_err": ke6_err,
         "ms": ke6_ms, "plain_ms": ke6_plain_ms, "bound_ms": ke6_bound_ms,
         "bound_by": by(ke6_ops_s, ke6_bytes_s),
         "library_ms": None, "on_main_path": True},
        {"name": "ed25519_verify", "route": "cuda",
         "source": "fabric_tpu_torch/ops/csrc/ed25519_verify.cu",
         "replaces": "fabric_tpu/ops/ed25519.py:47",
         "launches": total["ed25519_verify"], "max_abs_err": ke5_err,
         "ms": ke5_ms, "plain_ms": ke5_plain_ms, "bound_ms": ke5_bound_ms,
         "bound_by": by(ke5_ops_s, ke5_bytes_s),
         "library_ms": None, "on_main_path": True},
        {"name": "field_mul_chain", "route": "cuda",
         "source": "fabric_tpu_torch/ops/csrc/field_chain.cu",
         "replaces": "experiments/proto_pallas.py:94",
         "launches": total["field_mul_chain"], "max_abs_err": field_err,
         "ms": kp1_ms, "plain_ms": kp1_plain_ms, "bound_ms": kp1_bound_ms,
         "bound_by": by(kp1_ops_s, kp1_bytes_s),
         "library_ms": None, "on_main_path": False},
    ]
    phase("done", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
