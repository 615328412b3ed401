"""The port's device table bank (fabric_tpu_torch.ops.device_bank, K4)
and host table cache (p256_tables.KeyTableCache) against the JAX
package on the CPU: the same sequence of lookups, builds, pins and
unpins gives the same slots, LRU order, spills and stats as the
reference's DeviceBank; KeyTableCache behaves as the reference's does
in tests/test_ecp256.py:193-208; and a bank filled from reference tables
through from_jax_comb_table equals one filled by the port's own tables,
slot for slot, with the same KP3 verdicts."""
import hashlib
import random

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)

from fabric_tpu.ops import p256_tables as ref_tables
from fabric_tpu.ops.device_bank import DeviceBank as RefBank
from fabric_tpu_torch import crypto
from fabric_tpu_torch.ops import p256, p256_fixed, p256_tables
from fabric_tpu_torch.ops.device_bank import DeviceBank

SHAPE = (4, 2)


def fake_build(pk: bytes):
    """A cheap table per key; keys starting with b"bad" have none."""
    if pk.startswith(b"bad"):
        return None
    return np.full(SHAPE, pk[-1], dtype=np.uint32)


def script():
    """(op, key, pin) steps over a 3-slot bank: fills it, refreshes the
    LRU, evicts, pins every slot so a build spills, releases a pin, and
    rejects keys with no table."""
    k = [b"k%d" % i for i in range(7)]
    return [
        ("build", k[1], True), ("build", k[2], False), ("build", k[3], False),
        ("lookup", k[1], False), ("lookup", k[6], False),   # hit, miss
        ("build", k[4], False),                  # evicts k2 (LRU, unpinned)
        ("lookup", k[3], True), ("lookup", k[4], True),
        ("build", k[5], False),                  # every slot pinned: spill
        ("build", b"bad-key", False),
        ("unpin", k[3], None),
        ("build", k[5], True),                   # evicts k3
        ("lookup", k[1], True), ("unpin", k[1], None),
        ("build", k[6], False),                  # k1 still pinned once: spill
        ("unpin", k[1], None), ("unpin", k[4], None), ("unpin", k[5], None),
        ("build", k[2], False),                  # evicts k4
        ("build", k[1], False),                  # resident: a hit
    ]


def run(bank, steps):
    slots_of, trace = {}, []
    for op, key, pin in steps:
        if op == "build":
            got = bank.get_or_build(key, pin=pin)
        elif op == "lookup":
            got = bank.lookup(key, pin=pin)
        else:
            bank.unpin([slots_of[key]])
            got = None
        if got is not None:
            slots_of[key] = got
        trace.append((op, key, got, key in bank, len(bank),
                      {k: v for k, v in bank.stats.items()
                       if k != "h2d_bytes"}))
    return trace, slots_of


def test_bank_matches_reference_slot_for_slot():
    ref = RefBank(3, SHAPE, lambda pk: None if fake_build(pk) is None
                  else fake_build(pk).astype(np.float32))
    port = DeviceBank(3, SHAPE, fake_build, device="cpu")
    assert set(port.stats) == set(ref.stats)
    ref_trace, _ = run(ref, script())
    port_trace, slots_of = run(port, script())
    assert port_trace == ref_trace
    st = port.stats
    assert st["pinned_spills"] == 2 and st["evictions"] == 3
    assert st["rejects"] == 1 and st["builds"] == 6
    assert st["h2d_bytes"] == ref.stats["h2d_bytes"] == \
        st["builds"] * np.prod(SHAPE) * 4
    # each resident key's table sits in its slot of the device bank
    arr = port.array()
    assert arr.dtype == torch.uint32 and arr.shape == (3,) + SHAPE
    assert b"k6" not in port and len(port) == 3
    for key in (b"k1", b"k2", b"k5"):
        assert key in port
        assert (arr[slots_of[key]] == key[-1]).all()
    np.testing.assert_array_equal(np.asarray(ref.array()),
                                  arr.numpy().astype(np.float32))


def test_pin_refcounts():
    bank = DeviceBank(1, SHAPE, fake_build, device="cpu")
    s = bank.get_or_build(b"k1", pin=True)
    assert bank.lookup(b"k1", pin=True) == s
    bank.unpin([s])
    assert bank.get_or_build(b"k2") is None          # still pinned once
    bank.unpin([s])
    assert bank.get_or_build(b"k2") == s             # now evictable
    assert b"k1" not in bank and b"k2" in bank
    assert bank.stats["pinned_spills"] == 1
    assert bank.stats["evictions"] == 1
    with pytest.raises(ValueError, match="bank entry"):
        DeviceBank(1, (3, 3), fake_build, device="cpu").get_or_build(b"k1")


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBank(1, SHAPE, fake_build)


def sec1(key):
    return crypto.p256_public_bytes(key)


def test_rejects_off_curve_and_short_keys_like_reference():
    key = crypto.p256_key_from_scalar(777)
    pk = sec1(key)
    off = pk[:-1] + bytes([pk[-1] ^ 1])
    big = b"\x04" + (p256.P).to_bytes(32, "big") + pk[33:]

    def ref_build(pk):                   # JaxTpuProvider's _build_p256
        if len(pk) != 65 or pk[0] != 0x04:
            return None
        try:
            return ref_tables.comb_table_for_point(
                int.from_bytes(pk[1:33], "big"),
                int.from_bytes(pk[33:65], "big"))
        except ValueError:
            return None

    port = DeviceBank(2, (8192, 16), p256_tables.table_for_pubkey,
                      device="cpu")
    ref = RefBank(2, (8192, 44), ref_build)
    for bad in (off, pk[:33], b"", b"\x05" + pk[1:], big):
        assert port.get_or_build(bad, pin=True) is None
        assert ref.get_or_build(bad, pin=True) is None
    assert port.stats == ref.stats
    assert port.stats["rejects"] == 5 and len(port) == 0


def test_key_table_cache():
    """tests/test_ecp256.py:193-208 on the port's cache, plus its LRU."""
    sec = sec1(crypto.p256_key_from_scalar(4242))
    cache = p256_tables.KeyTableCache(max_keys=1)
    t1 = cache.get_or_build(sec)
    assert t1 is not None and t1.shape == (8192, 16)
    assert t1.dtype == np.uint32 and cache.stats["builds"] == 1
    t2 = cache.get_or_build(sec)
    assert t2 is t1 and cache.stats["hits"] >= 1
    bad = bytearray(sec)
    bad[-1] ^= 1
    assert cache.get_or_build(bytes(bad)) is None
    assert cache.get_or_build(sec[:33]) is None
    assert cache.stats["rejects"] == 2
    other = sec1(crypto.p256_key_from_scalar(4243))
    assert cache.get_or_build(other) is not None
    assert other in cache and sec not in cache       # LRU evicted
    assert set(cache.stats) == set(ref_tables.KeyTableCache().stats)


def test_bank_from_reference_tables_equals_port_bank():
    """The converter carries reference per-key tables into the port's
    layout: a bank built through it equals the port's own bank slot
    for slot, and KP3's plain version gives the same verdicts on both."""
    rng = random.Random(31)
    keys = [crypto.p256_key_from_scalar(rng.randrange(1, p256.N))
            for _ in range(2)]

    def via_reference(pk):
        qx = int.from_bytes(pk[1:33], "big")
        qy = int.from_bytes(pk[33:65], "big")
        return p256_tables.from_jax_comb_table(
            ref_tables.comb_table_for_point(qx, qy)).numpy()

    a = DeviceBank(2, (8192, 16), via_reference, device="cpu")
    b = DeviceBank(2, (8192, 16), p256_tables.table_for_pubkey,
                   device="cpu")
    for key in keys:
        assert a.get_or_build(sec1(key)) == b.get_or_build(sec1(key))
    assert torch.equal(a.array(), b.array())

    rows, slot, want = [], [], []
    for i in range(6):
        key = keys[i % 2]
        digest = hashlib.sha256(bytes([i])).digest()
        r, s = crypto.p256_sign_digest(key, digest)
        e = int.from_bytes(digest, "big") ^ (i == 4)
        rows.append((r, min(s, p256.N - s), e))
        slot.append(b.lookup(sec1(key)))
        want.append(i != 4)
    r, s, e = [torch.from_numpy(p256.ints_to_words(list(v)))
               for v in zip(*rows)]
    slot = torch.tensor(slot, dtype=torch.int32)
    g = p256_tables.g_table("cpu")
    got_a = p256_fixed.verify_words_rows_plain(r, s, e, slot, a.array(), g)
    got_b = p256_fixed.verify_words_rows_plain(r, s, e, slot, b.array(), g)
    assert got_a.tolist() == got_b.tolist() == want
