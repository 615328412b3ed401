"""Driver entry points: single-device check and multi-device dry run.

Counterpart of `__graft_entry__.py`.  `entry()` returns the flagship step,
the batched ECDSA-P256 verify that the commit path runs per block (the
reference peer's per-tx verify loop, validator.go:194-209): KP2's
wrapper over (8, 128) uint32 word tensors on the card.

`dryrun_multichip(n)` builds a mesh of n shards over the visible CUDA
devices, round-robin (on one H100, n shards on cuda:0, each on its own
stream; device="cpu" gives n CPU shards, which run the plain versions),
and runs the reference's four checks through the sharded lanes
(`parallel/mesh.py`): P-256 (KP2), Ed25519 (KE5), the fixed-key lane with
two keys (KP3 over a replicated bank) and the streamed-window probe, a
depth-2 window of `batch_verify_async` through the sharded and the
single-device provider, held to bit-identical verdicts, to the known
corruption pattern and to `fallbacks == 0`.  Like the reference, it
claims no speedup: on one card the shards share its SMs.

    python -m fabric_tpu_torch.entry N
"""

from __future__ import annotations

import hashlib
import json
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import crypto
from .device import resolve_device, visible_devices

# the reference's sizes: 8 blocks of 96 signatures (below the fast-lane
# threshold per key: every key stays on the generic lane)
WINDOW_BLOCKS = 8
WINDOW_SIGS = 96


def _p256_cases(n: int, n_keys: int = 4):
    """Deterministic keys, valid low-S signatures: (qx, qy, r, s, e)
    (8, n) uint32 word arrays."""
    from .ops import p256
    rng = random.Random(7)
    keys = [crypto.p256_key_from_scalar(rng.getrandbits(255) | 1)
            for _ in range(n_keys)]
    cols = [[], [], [], [], []]
    for i in range(n):
        key = keys[i % n_keys]
        pub = crypto.p256_public_bytes(key)
        digest = hashlib.sha256(rng.randbytes(48)).digest()
        r, s = crypto.p256_sign_digest(key, digest)
        vals = (int.from_bytes(pub[1:33], "big"),
                int.from_bytes(pub[33:], "big"), r, min(s, p256.N - s),
                int.from_bytes(digest, "big"))
        for c, v in zip(cols, vals):
            c.append(v)
    return tuple(p256.ints_to_words(c) for c in cols)


def _ed25519_cases(n: int, n_keys: int = 4):
    """(ay, a_sign, ry, r_sign, s, k) of n valid Ed25519 signatures."""
    from .ops import ed25519
    rng = random.Random(11)
    keys = [crypto.ed25519_key_from_seed(rng.randbytes(32))
            for _ in range(n_keys)]
    pks, sigs, msgs = [], [], []
    for i in range(n):
        key = keys[i % n_keys]
        msg = rng.randbytes(40)
        pks.append(crypto.ed25519_public_bytes(key))
        sigs.append(crypto.ed25519_sign(key, msg))
        msgs.append(msg)
    return ed25519.pack_verify_inputs(pks, sigs, msgs)


def entry(device=None):
    """(fn, example_args): fn is KP2's wrapper over five (8, B) uint32
    word tensors on `device` (default the card; "cpu" runs its plain
    version), G's table bound; example_args are 128 valid signatures
    under 4 keys, on that device."""
    from .ops import p256, p256_tables
    dev = resolve_device(device)
    table = p256_tables.g_table(dev)
    args = tuple(torch.from_numpy(a).to(dev) for a in _p256_cases(128))

    def fn(qx, qy, r, s, e):
        return p256.p256_verify(qx, qy, r, s, e, table)

    return fn, args


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"dryrun_multichip: {what}")


def _sizes(n_devices: int) -> tuple:
    """The reference's sizes for n shards: (items of the P-256 and
    Ed25519 checks, max(16, 2 n), not rounded to a multiple of n since
    nothing is padded; signatures of the fixed-key check, 8 a shard;
    blocks of the window probe; signatures a block)."""
    return max(16, 2 * n_devices), 8 * n_devices, WINDOW_BLOCKS, WINDOW_SIGS


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded pass of each verify lane on an n-shard mesh, then the
    streamed-window probe.

    device None: the visible CUDA devices round-robin (raises without
    CUDA); otherwise n shards on that device.  Raises AssertionError on
    any failed check; -> the probe's record."""
    from .ops import p256_tables
    from .parallel import mesh as meshmod
    devs = visible_devices() if device is None else [resolve_device(device)]
    mesh = meshmod.make_mesh([devs[i % len(devs)] for i in range(n_devices)])
    batch, n_rows, blocks, block_sigs = _sizes(n_devices)

    p256_fn = meshmod.sharded_p256_verify(mesh)
    gt = {d: p256_tables.g_table(d) for d in mesh.distinct_devices}
    verdicts, count = p256_fn(*_p256_cases(batch), gt)
    _check(bool(verdicts.all()), "p256 verdicts must all pass")
    _check(int(count) == batch, "p256 count")

    from .ops import ed25519_tables
    ed_fn = meshmod.sharded_ed25519_verify(mesh)
    bt = {d: ed25519_tables.b_table(d) for d in mesh.distinct_devices}
    verdicts, count = ed_fn(*_ed25519_cases(batch), bt)
    _check(bool(verdicts.all()), "ed25519 verdicts must all pass")
    _check(int(count) == batch, "ed25519 count")

    # the fixed-key lane: signatures under two keys, key-major (the
    # provider's layout), over a replicated two-slot bank
    from .ops.device_bank import DeviceBank
    qx, qy, r, s, e = _p256_cases(n_rows, n_keys=2)
    pks = [b"\x04" + b"".join(int(w).to_bytes(4, "big") for w in qx[:, i])
           + b"".join(int(w).to_bytes(4, "big") for w in qy[:, i])
           for i in range(n_rows)]
    bank = DeviceBank(2, (p256_tables.ROWS, p256_tables.ROW_WORDS),
                      p256_tables.table_for_pubkey,
                      devices=mesh.distinct_devices)
    slot = np.asarray([bank.get_or_build(pk) for pk in pks], np.int32)
    order = np.argsort(slot, kind="stable")
    rows_fn = meshmod.sharded_p256_rows_verify(mesh)
    verdicts, count = rows_fn(r[:, order], s[:, order], e[:, order],
                              slot[order], bank.replicas(), gt)
    _check(bool(verdicts.all()), "rows verdicts must all pass")
    _check(int(count) == n_rows, "rows count")
    _check(bank.stats["builds"] == len(set(pks)), "one table build a key")

    return _dryrun_window_probe(mesh, blocks, block_sigs)


def _window_blocks(n_blocks: int, block_sigs: int, n_keys: int = 32):
    """Deterministic per-block item lists with a known corruption pattern
    (every 7th digest bit-flipped), so the probe checks the verdicts
    themselves, not only sharded against single-device."""
    from .bccsp.provider import SCHEME_P256, VerifyItem
    from .ops import p256
    rng = random.Random(23)
    keys = [crypto.p256_key_from_scalar(rng.getrandbits(255) | 1)
            for _ in range(n_keys)]
    pubs = [crypto.p256_public_bytes(k) for k in keys]
    blocks, expect = [], []
    g = 0
    for _ in range(n_blocks):
        items = []
        for _ in range(block_sigs):
            ki = (g * 7 + 3) % n_keys           # spread keys (stay generic)
            digest = hashlib.sha256(rng.randbytes(48)).digest()
            r, s = crypto.p256_sign_digest(keys[ki], digest)
            bad = g % 7 == 5
            if bad:
                digest = bytes([digest[0] ^ 1]) + digest[1:]
            items.append(VerifyItem(SCHEME_P256, pubs[ki],
                                    crypto.encode_dss_signature(
                                        r, min(s, p256.N - s)), digest))
            expect.append(not bad)
            g += 1
        blocks.append(items)
    return blocks, np.asarray(expect, dtype=bool)


def _card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def _dryrun_window_probe(mesh, n_blocks: int, block_sigs: int) -> dict:
    """Depth-2 pipelined batch_verify_async through the sharded provider
    and the single-device one: bit-identical verdicts, equal to the known
    corruption pattern, no fallback.  Prints one JSON line labelled with
    the shard count, the shards per device and the card; a plumbing and
    correctness probe, not a claim of speed."""
    from .bccsp.cuda import CudaProvider
    blocks, expect = _window_blocks(n_blocks, block_sigs)
    cuda = mesh.devices[0].type == "cuda"

    def run(provider):
        outs, completions, pending = [], [], []
        if cuda:
            provider.batch_verify(blocks[0])      # the first use's loads
        for blk in blocks:
            pending.append(provider.batch_verify_async(blk))
            if len(pending) >= 2:                 # double-buffered window
                outs.append(pending.pop(0)())
                completions.append(time.perf_counter())
        while pending:
            outs.append(pending.pop(0)())
            completions.append(time.perf_counter())
        ivals = [b - a for a, b in zip(completions, completions[1:])]
        return np.concatenate(outs), ivals[1:]    # drop the pipeline fill

    sharded = CudaProvider(mesh=mesh)
    single = CudaProvider(device=mesh.devices[0])
    vs, iv_s = run(sharded)
    v1, iv_1 = run(single)
    _check(np.array_equal(vs, v1),
           "sharded window verdicts diverge from single-device")
    _check(np.array_equal(vs, expect),
           "window verdicts diverge from the known corruption pattern")
    _check(sharded.stats["fallbacks"] == 0, f"fallbacks {sharded.stats}")
    _check(single.stats["fallbacks"] == 0, f"fallbacks {single.stats}")
    rec = {
        "shards": len(mesh),
        "shards_per_device": {str(d): mesh.devices.count(d)
                              for d in mesh.distinct_devices},
        "card": _card() if cuda else None,
        "block_sigs": block_sigs, "blocks": n_blocks,
        "note": "a plumbing and correctness probe, not a claim of speed",
    }
    if cuda and iv_s and iv_1:
        s_rate = block_sigs / statistics.median(iv_s)
        one_rate = block_sigs / statistics.median(iv_1)
        rec.update(single_sigs_per_sec=one_rate, sharded_sigs_per_sec=s_rate)
    print(json.dumps({"multichip_window": rec}), flush=True)
    return rec


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dryrun_multichip(n)
    print(f"dryrun_multichip({n}) OK")
