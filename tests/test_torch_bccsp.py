"""The port's BCCSP (fabric_tpu_torch.bccsp) against the reference
providers on the CPU: CudaProvider(device="cpu"), which runs the plain
PyTorch version of the P-256 kernel, must return bool arrays identical to
fabric_tpu's SoftwareProvider and to JaxTpuProvider's generic lane on the
corpora of tests/test_bccsp.py:42-125 and tests/test_p256.py:72-96.

The plain verify costs seconds per call on the CPU whatever the batch
size, so the corpora ride one batch per provider (a module fixture) and
each test checks its own slice of it.

The two-lane dispatch (keys with a resident table, or that bring
fast_key_threshold signatures, go to KP3; the rest to KP2) mirrors
tests/test_provider_perf.py:76-186 and tests/test_p256.py:129-174: the
many-keys differential and the overflow / rotation test run the real
arithmetic; the tests of lane choice, uploads and chunking stub the
kernels and the table build.  The Ed25519 items take the same two-lane
choice between KE6 and KE5 (fabric_tpu/bccsp/jaxtpu.py:764-808): a
mixed-curve batch runs the real arithmetic of all four lanes against
SW, the lane choice, pins and build counts run on stubs."""
import hashlib
import random

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)

from fabric_tpu.bccsp import SCHEME_ED25519 as REF_ED25519
from fabric_tpu.bccsp import SCHEME_P256 as REF_P256
from fabric_tpu.bccsp import VerifyItem as RefItem
from fabric_tpu.bccsp.jaxtpu import JaxTpuProvider
from fabric_tpu.bccsp.jaxtpu import ProviderStats as RefStats
from fabric_tpu.bccsp.sw import SoftwareProvider as RefSW
from fabric_tpu.crypto import decode_dss_signature as ref_decode
from fabric_tpu.crypto import encode_dss_signature as ref_encode
from fabric_tpu_torch import crypto
from fabric_tpu_torch.bccsp import (FactoryOpts, SCHEME_ED25519,
                                    SCHEME_IDEMIX, SCHEME_P256, VerifyItem,
                                    init_factories)
from fabric_tpu_torch.bccsp import factory
from fabric_tpu_torch.bccsp import cuda as cudaprov
from fabric_tpu_torch.bccsp.cuda import CudaProvider
from fabric_tpu_torch.bccsp.degrade import DegradingProvider
from fabric_tpu_torch.bccsp.sw import P256_N, SoftwareProvider
from fabric_tpu_torch.ops import ed25519_tables, p256_tables

N = P256_N
P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
HALF_N = (N - 1) // 2

GENERIC_ONLY = 1 << 30          # fast_key_threshold: every key generic


def port(items):
    return [VerifyItem(*it) for it in items]


def sec1(x, y):
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def bccsp_corpora(sw):
    """tests/test_bccsp.py:42-125, on the reference SW provider's keys."""
    rng = random.Random(11)
    out = {}
    items = []
    for _ in range(4):
        k = sw.key_gen(REF_P256)
        digest = hashlib.sha256(rng.randbytes(50)).digest()
        items.append(RefItem(REF_P256, k.public_bytes(),
                             sw.sign(k, digest), digest))
    for _ in range(3):
        k = sw.key_gen(REF_ED25519)
        msg = rng.randbytes(rng.randrange(0, 99))
        items.append(RefItem(REF_ED25519, k.public_bytes(),
                             sw.sign(k, msg), msg))
    b1, b2 = items[1], items[5]
    items[1] = RefItem(b1.scheme, b1.pubkey, b1.signature,
                       hashlib.sha256(b"other").digest())
    items[5] = RefItem(b2.scheme, b2.pubkey, b2.signature, b2.payload + b"x")
    out["mixed"] = (items, None)

    k = sw.key_gen(REF_P256)
    digest = hashlib.sha256(b"m").digest()
    good = RefItem(REF_P256, k.public_bytes(), sw.sign(k, digest), digest)
    out["malformed"] = ([
        good,
        RefItem(REF_P256, b"\x04" + b"\x00" * 10, good.signature, digest),
        RefItem(REF_P256, good.pubkey, b"\x30\x01\x00", digest),
        RefItem(REF_P256, good.pubkey, good.signature, b"short"),
        RefItem(REF_ED25519, b"\x00" * 31, b"\x00" * 64, b""),
        RefItem("rsa-4096", good.pubkey, good.signature, digest),
        good,
    ], [True, False, False, False, False, False, True])

    k = sw.key_gen(REF_P256)
    digest = hashlib.sha256(b"hs").digest()
    sig = sw.sign(k, digest)
    r, s = ref_decode(sig)
    high = ref_encode(r, N - s)
    out["high_s"] = ([RefItem(REF_P256, k.public_bytes(), high, digest),
                      RefItem(REF_P256, k.public_bytes(), sig, digest)],
                     [False, True])
    return out


def p256_cases(sw):
    """tests/test_p256.py:32-96: adversarial batch and swapped
    signatures, as (qx, qy, r, s, digest) rows turned into items."""
    rng = random.Random(99)

    def make_case(mutate=None):
        k = sw.key_gen(REF_P256)
        pub = k.public_bytes()
        qx = int.from_bytes(pub[1:33], "big")
        qy = int.from_bytes(pub[33:], "big")
        digest = hashlib.sha256(rng.randbytes(48)).digest()
        r, s = ref_decode(sw.sign(k, digest))
        e = int.from_bytes(digest, "big")
        if mutate == "high_s":
            s = N - s
        elif mutate == "wrong_digest":
            e ^= 1 << 13
        elif mutate == "r_zero":
            r = 0
        elif mutate == "s_zero":
            s = 0
        elif mutate == "r_eq_n":
            r = N
        elif mutate == "off_curve":
            qy = (qy + 1) % P
        elif mutate == "qx_ge_p":
            qx = P
        elif mutate == "flip_sig_bit":
            r ^= 1 << 200
        return (qx, qy, r, s, e)

    def item(c):
        qx, qy, r, s, e = c
        return RefItem(REF_P256, sec1(qx, qy), ref_encode(r, s),
                       e.to_bytes(32, "big"))

    mutations = [None, "high_s", "wrong_digest", "r_zero", "s_zero",
                 "r_eq_n", "off_curve", "qx_ge_p", "flip_sig_bit", None]
    out = {"adversarial": ([item(make_case(m)) for m in mutations],
                           [m is None for m in mutations])}
    a, b = make_case(), make_case()
    swapped = [(a[0], a[1], b[2], b[3], a[4]), (b[0], b[1], a[2], a[3], b[4]),
               a, b]
    out["swapped"] = ([item(c) for c in swapped], [False, False, True, True])
    out["high_s_relaxed"] = ([item(make_case("high_s")), item(make_case())],
                             [True, True])
    return out


@pytest.fixture(scope="module")
def corpora():
    sw = RefSW()
    out = bccsp_corpora(sw)
    out.update(p256_cases(sw))
    return out


@pytest.fixture(scope="module")
def verdicts(corpora):
    """{corpus: (port, reference SW, JaxTpuProvider)} for the low-S
    corpora, each provider run once over all of them."""
    names = [n for n in corpora if n != "high_s_relaxed"]
    batch, spans = [], {}
    for n in names:
        spans[n] = (len(batch), len(batch) + len(corpora[n][0]))
        batch += corpora[n][0]
    prov = CudaProvider(device="cpu")
    got = {
        "port": prov.batch_verify(port(batch)),
        "sw": RefSW().batch_verify(batch),
        "jax": JaxTpuProvider(fast_key_threshold=GENERIC_ONLY)
        .batch_verify(batch),
    }
    out = {n: tuple(np.asarray(got[k][lo:hi]) for k in ("port", "sw", "jax"))
           for n, (lo, hi) in spans.items()}
    out["_stats"] = dict(prov.stats)
    return out


@pytest.mark.parametrize("corpus", ["mixed", "malformed", "high_s",
                                    "adversarial", "swapped"])
def test_port_matches_sw_and_jaxtpu(corpus, corpora, verdicts):
    got, sw, jax_lane = verdicts[corpus]
    assert got.dtype == bool
    np.testing.assert_array_equal(got, sw)
    np.testing.assert_array_equal(got, jax_lane)
    want = corpora[corpus][1]
    if want is not None:
        np.testing.assert_array_equal(got, want)
    else:
        assert got.sum() == len(got) - 2


def test_high_s_accepted_without_low_s_rule(corpora):
    items, want = corpora["high_s_relaxed"]
    got = CudaProvider(require_low_s=False, device="cpu").batch_verify(
        port(items))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, RefSW(require_low_s=False).batch_verify(items))
    np.testing.assert_array_equal(
        got, JaxTpuProvider(require_low_s=False,
                            fast_key_threshold=GENERIC_ONLY)
        .batch_verify(items))


def test_stats_keys_match_reference_and_no_fallback(verdicts):
    stats = verdicts["_stats"]
    ref = JaxTpuProvider(fast_key_threshold=GENERIC_ONLY).stats
    assert set(stats) == set(ref)
    assert stats["fallbacks"] == 0
    assert stats["dispatches"] == 2             # one KP2, one KE5 launch
    assert stats["device_sigs"] > 0 and stats["host_rejects"] > 0


def test_empty_batch():
    prov = CudaProvider(device="cpu")
    out = prov.batch_verify([])
    assert out.shape == (0,) and out.dtype == bool
    assert prov.stats["dispatches"] == 0


def test_async_resolve_and_chunking(corpora, monkeypatch):
    """Chunks scatter back to the right slots; the device call is a
    stub here (the kernel's arithmetic has its own tests)."""
    items = port(corpora["adversarial"][0] + corpora["malformed"][0])
    calls = []

    def fake_verify(qx, qy, r, s, e, table, require_low_s=True):
        calls.append(qx.shape[1])
        return torch.ones(qx.shape[1], dtype=torch.bool)

    monkeypatch.setattr(cudaprov.p256mod, "p256_verify", fake_verify)
    monkeypatch.setattr(cudaprov, "MAX_CHUNK", 3)
    prov = CudaProvider(device="cpu")
    resolve = prov.batch_verify_async(items)
    assert callable(resolve)
    got = resolve()
    recs, rejected = cudaprov.parse_p256(
        items, [i for i, it in enumerate(items) if it.scheme == SCHEME_P256])
    well_formed = {rec[0] for rec in recs}
    assert sum(calls) == len(recs) and max(calls) == 3
    assert prov.stats["dispatches"] == len(calls)
    assert prov.stats["device_sigs"] == len(recs)
    for i, it in enumerate(items):
        if it.scheme == SCHEME_P256:
            assert got[i] == (i in well_formed)


def test_idemix_item_raises():
    """Idemix items no longer raise (the test keeps the name it had when
    it pinned that): garbage ones come back False from both providers
    without reaching the card; tests/test_torch_idemix.py holds the lane
    against the reference."""
    items = [VerifyItem(SCHEME_IDEMIX, b"ipk", b"sig", b"msg"),
             VerifyItem(SCHEME_IDEMIX, b"", b"", b"")]
    prov = CudaProvider(device="cpu")
    assert prov.batch_verify(items).tolist() == [False, False]
    assert prov.stats["device_sigs"] == 0 and prov.stats["fallbacks"] == 0
    assert SoftwareProvider().batch_verify(items).tolist() == [False, False]


def test_unknown_scheme_is_false_and_counted():
    prov = CudaProvider(device="cpu")
    got = prov.batch_verify([VerifyItem("rsa-4096", b"k", b"s", b"m")] * 2)
    assert got.tolist() == [False, False]
    assert prov.stats["host_rejects"] == 2


def test_factory_kinds(monkeypatch):
    assert FactoryOpts().default == "CUDA"
    p = init_factories(FactoryOpts(default="SW"))
    assert p.name == "sw" and factory.get_default() is p
    p = init_factories(FactoryOpts(default="cuda", device="cpu"))
    assert isinstance(p, CudaProvider) and p.device.type == "cpu"
    # the degrading breaker only when asked for (fail-stop by default)
    p = init_factories(FactoryOpts(default="cuda", device="cpu",
                                   degrade=True))
    assert isinstance(p, DegradingProvider) and p.backend == "cuda"
    assert isinstance(p.primary, CudaProvider) and p.device.type == "cpu"
    with pytest.raises(ValueError):
        init_factories(FactoryOpts(default="JAXTPU"))
    with pytest.raises(ValueError):
        init_factories(FactoryOpts(default="HSM"))
    sw = SoftwareProvider()
    factory.set_default(sw)
    assert factory.get_default() is sw


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CudaProvider()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_factories(FactoryOpts())
    monkeypatch.setattr(factory, "_default", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        factory.get_default()


def test_sign_and_keys_delegate_to_sw():
    prov = CudaProvider(device="cpu")
    k = prov.key_gen(SCHEME_P256)
    digest = hashlib.sha256(b"x").digest()
    sig = prov.sign(k, digest)
    r, s = crypto.decode_dss_signature(sig)
    assert s <= HALF_N
    item = RefItem(REF_P256, k.public_bytes(), sig, digest)
    assert RefSW().batch_verify([item]).tolist() == [True]
    ek = prov.key_gen(SCHEME_ED25519)
    msg = b"hello"
    item = RefItem(REF_ED25519, ek.public_bytes(), prov.sign(ek, msg), msg)
    assert RefSW().batch_verify([item]).tolist() == [True]
    with pytest.raises(ValueError):
        prov.key_gen("rsa")


def test_pure_python_sw_matches_reference(corpora, monkeypatch):
    """The port's SW provider without `cryptography` (as on GPU hosts)
    gives the reference's verdicts, and its signatures verify there."""
    monkeypatch.setattr(crypto, "HAVE_CRYPTOGRAPHY", False)
    items = []
    for name in ("mixed", "malformed", "high_s", "adversarial", "swapped"):
        items += corpora[name][0]
    got = SoftwareProvider().batch_verify(port(items))
    np.testing.assert_array_equal(got, RefSW().batch_verify(items))
    sw = SoftwareProvider()
    k = sw.key_gen(SCHEME_P256)
    assert type(k.key).__name__ == "_P256Key"
    digest = hashlib.sha256(b"pure").digest()
    item = RefItem(REF_P256, k.public_bytes(), sw.sign(k, digest), digest)
    ek = sw.key_gen(SCHEME_ED25519)
    eitem = RefItem(REF_ED25519, ek.public_bytes(), sw.sign(ek, b"m"), b"m")
    assert RefSW().batch_verify([item, eitem]).tolist() == [True, True]


# ---------------------------------------------------------------------------
# The two P-256 lanes
# ---------------------------------------------------------------------------

TABLE_BYTES = p256_tables.ROWS * p256_tables.ROW_WORDS * 4


@pytest.fixture(scope="module")
def keypool():
    rng = random.Random(41)
    return [crypto.p256_key_from_scalar(rng.randrange(1, N))
            for _ in range(100)]


def signed(keys, per_key, seed):
    """per_key low-S signatures under each key, shuffled -> port items."""
    rng = random.Random(seed)
    items = []
    for key in keys:
        pub = crypto.p256_public_bytes(key)
        for _ in range(per_key):
            digest = hashlib.sha256(rng.randbytes(24)).digest()
            r, s = crypto.p256_sign_digest(key, digest)
            items.append(VerifyItem(SCHEME_P256, pub,
                                    crypto.encode_dss_signature(
                                        r, min(s, N - s)), digest))
    rng.shuffle(items)
    return items


def even_r(items):
    """What the stubbed kernels answer: r's low bit is 0."""
    return [crypto.decode_dss_signature(it.signature)[0] % 2 == 0
            for it in items]


@pytest.fixture
def stubbed(monkeypatch):
    """Stubs KP3, KP2, KE6, KE5 and both table builds.  Each kernel
    answers "r (R's y for Ed25519) is even" per signature, so a verdict
    scattered to the wrong item shows; -> the list of launches,
    ("kp3", slots), ("kp2", size), ("ke6", slots) or ("ke5", size)."""
    calls = []

    def ke6(ry, r_sign, s, k, slot, bank, table):
        assert bank.shape == (bank.shape[0], 2405, 24)
        calls.append(("ke6", slot.tolist()))
        return (ry[7].to(torch.int64) & 1) == 0

    def ke5(ay, a_sign, ry, r_sign, s, k, table):
        calls.append(("ke5", ry.shape[1]))
        return (ry[7].to(torch.int64) & 1) == 0

    def ed_table(pk):
        return (None if ed25519_tables.decompress_int(pk) is None
                else np.zeros((2405, 24), np.uint32))

    monkeypatch.setattr(cudaprov.ed25519, "ed25519_verify_rows", ke6)
    monkeypatch.setattr(cudaprov.ed25519, "ed25519_verify", ke5)
    monkeypatch.setattr(cudaprov.ed25519_tables, "table_for_pubkey",
                        ed_table)

    def kp3(r, s, e, slot, bank, table, require_low_s=True):
        assert bank.shape == (bank.shape[0], p256_tables.ROWS,
                              p256_tables.ROW_WORDS)
        calls.append(("kp3", slot.tolist()))
        return (r[7].to(torch.int64) & 1) == 0

    def kp2(qx, qy, r, s, e, table, require_low_s=True):
        calls.append(("kp2", r.shape[1]))
        return (r[7].to(torch.int64) & 1) == 0

    monkeypatch.setattr(cudaprov.p256_fixed, "p256_verify_rows", kp3)
    monkeypatch.setattr(cudaprov.p256mod, "p256_verify", kp2)
    monkeypatch.setattr(
        cudaprov.p256_tables, "table_for_pubkey",
        lambda pk: np.zeros((p256_tables.ROWS, p256_tables.ROW_WORDS),
                            np.uint32))
    return calls


def lanes(calls):
    kp3 = [s for kind, s in calls if kind == "kp3"]
    return sum(map(len, kp3)), sum(n for kind, n in calls if kind == "kp2")


@pytest.fixture(scope="module")
def many_keys():
    """tests/test_p256.py:129-174: 140 items in uneven groups under 7 of
    9 keys (key 0 has every third item; keys 3 and 6 sign none, as there),
    every fifth with a wrong digest
    and every thirteenth with a wrong r; plus the three providers'
    verdicts with fast_key_threshold=4."""
    sw = RefSW()
    rng = random.Random(17)
    keys = [sw.key_gen(REF_P256) for _ in range(9)]
    items = []
    for i in range(140):
        key = keys[i % 9 if i % 3 else 0]
        d = hashlib.sha256(rng.randbytes(33)).digest()
        r, s = ref_decode(sw.sign(key, d))
        sig = ref_encode(r, s)
        if i % 5 == 2:
            d = hashlib.sha256(b"wrong").digest()
        if i % 13 == 7:
            sig = ref_encode((r * 2) % N or 1, s)
        items.append(RefItem(REF_P256, key.public_bytes(), sig, d))
    prov = CudaProvider(device="cpu", fast_key_threshold=4)
    ref = JaxTpuProvider(fast_key_threshold=4)
    return {"port": prov.batch_verify(port(items)), "prov": prov,
            "sw": RefSW().batch_verify(items),
            "jax": np.asarray(ref.batch_verify(items)), "ref": ref,
            "n": len(items)}


def test_many_keys_differential_rides_kp3(many_keys):
    got = many_keys["port"]
    np.testing.assert_array_equal(got, many_keys["sw"])
    np.testing.assert_array_equal(got, many_keys["jax"])
    assert 0 < got.sum() < many_keys["n"]
    prov, ref = many_keys["prov"], many_keys["ref"]
    assert prov.stats["fast_key_sigs"] == many_keys["n"]
    assert ref.stats["fast_key_sigs"] == many_keys["n"]
    assert prov.stats["dispatches"] == 1 and prov.stats["fallbacks"] == 0
    assert prov.key_tables.stats["builds"] == 7
    # the batch's pins are released once KP3 is launched
    assert not prov.key_tables._pinned


def test_stats_snapshot_matches_reference_shape(many_keys):
    snap = many_keys["prov"].stats_snapshot()
    assert type(snap).__dataclass_fields__.keys() \
        == RefStats.__dataclass_fields__.keys()
    assert snap.fast_key_sigs == many_keys["n"]
    assert snap.p256_table_builds == 7 and snap.ed25519_table_builds == 0
    assert snap.tuning == {"fast_key_threshold": 4, "max_cached_keys": 256}


def test_overflow_and_rotation_real_arithmetic(keypool):
    """Two slots.  Batch A brings three hot keys: the two biggest groups
    win the slots and stay pinned, so the third key's build spills and
    its signatures take KP2.  Batch B, enqueued before A is resolved,
    brings two other keys, which evict both of A's slots.  Every verdict
    equals its label and SW's."""
    def batch(keys, sizes, seed):
        items = []
        for key, n in zip(keys, sizes):
            items += signed([key], n, seed + n)
        labels = [i % 4 != 1 for i in range(len(items))]
        for i, it in enumerate(items):
            if not labels[i]:
                items[i] = it._replace(payload=hashlib.sha256(
                    it.payload).digest())
        return items, labels

    a, want_a = batch(keypool[:3], (6, 5, 4), seed=1)
    b, want_b = batch(keypool[3:5], (4, 4), seed=2)
    prov = CudaProvider(device="cpu", fast_key_threshold=4,
                        max_cached_keys=2)
    res_a = prov.batch_verify_async(a)
    st = prov.key_tables.stats
    assert st["pinned_spills"] == 1 and prov.stats["fast_key_sigs"] == 11
    res_b = prov.batch_verify_async(b)
    assert st["evictions"] == 2 and st["builds"] == 4
    got_b, got_a = res_b(), res_a()
    assert got_a.tolist() == want_a and got_b.tolist() == want_b
    np.testing.assert_array_equal(got_a, SoftwareProvider().batch_verify(a))
    assert prov.stats["fast_key_sigs"] == 11 + 8
    assert prov.stats["device_sigs"] == len(a) + len(b)
    assert prov.stats["dispatches"] == 3


@pytest.mark.parametrize("n_keys", [3, 8, 64])
def test_hot_keys_ride_kp3(n_keys, keypool, stubbed):
    """Every key that brings >= threshold signatures earns a slot, however
    many keys there are; the KP3 batch is key-major."""
    items = signed(keypool[:n_keys], 5, seed=n_keys)
    prov = CudaProvider(device="cpu", fast_key_threshold=4,
                        max_cached_keys=64)
    got = prov.batch_verify(items)
    assert got.tolist() == even_r(items)
    assert lanes(stubbed) == (len(items), 0)
    assert prov.stats["fast_key_sigs"] == len(items)
    assert prov.key_tables.stats["builds"] == n_keys
    slots = stubbed[0][1]
    runs = [s for j, s in enumerate(slots) if j == 0 or s != slots[j - 1]]
    assert len(runs) == len(set(runs)) == n_keys


def test_cold_keys_ride_kp2(keypool, stubbed):
    """Groups below the threshold earn no build; a resident key rides KP3
    even for one signature."""
    prov = CudaProvider(device="cpu", fast_key_threshold=4)
    items = signed(keypool, 2, seed=3)
    assert prov.batch_verify(items).tolist() == even_r(items)
    assert lanes(stubbed) == (0, len(items))
    assert prov.stats["fast_key_sigs"] == 0
    assert prov.key_tables.stats["builds"] == 0
    warm = signed(keypool[:1], 4, seed=9)
    one = signed(keypool[:1], 1, seed=11) + signed(keypool[1:2], 1, seed=12)
    prov.batch_verify(warm)
    assert prov.batch_verify(one).tolist() == even_r(one)
    assert prov.stats["fast_key_sigs"] == len(warm) + 1
    assert stubbed[-2:] == [("kp3", [0]), ("kp2", 1)]


def test_table_uploaded_once_per_key(keypool, stubbed):
    """Tables cross to the device once per key; later batches ship only
    signature words and slots (tests/test_provider_perf.py:76-103)."""
    prov = CudaProvider(device="cpu", fast_key_threshold=4,
                        max_cached_keys=8)
    items = signed(keypool[:8], 10, seed=4)
    prov.batch_verify(items)
    assert prov.key_tables.stats["h2d_bytes"] == 8 * TABLE_BYTES
    base = prov.stats["h2d_bytes"]
    assert base == len(items) * (3 * 32 + 4)
    for _ in range(2):
        prov.batch_verify(items)
    assert prov.key_tables.stats["h2d_bytes"] == 8 * TABLE_BYTES
    assert prov.key_tables.stats["builds"] == 8
    assert prov.stats["h2d_bytes"] == 3 * base


def test_capacity_overflow_spills_to_kp2(keypool, stubbed):
    """More hot keys than slots: per batch the biggest groups win the
    slots, the rest take KP2 (tests/test_provider_perf.py:138-158)."""
    prov = CudaProvider(device="cpu", fast_key_threshold=4,
                        max_cached_keys=4)
    for rep in range(2):
        items = []
        for j, key in enumerate(keypool[:6]):
            items += signed([key], 5 + (j < 4), seed=20 + rep + j)
        assert prov.batch_verify(items).tolist() == even_r(items)
    st = prov.key_tables.stats
    assert st["builds"] == 4 and st["pinned_spills"] == 4
    assert prov.stats["fast_key_sigs"] == 2 * 4 * 6
    assert lanes(stubbed) == (2 * 4 * 6, 2 * 2 * 5)
    assert not prov.key_tables._pinned


def test_kp3_chunks_scatter_back(keypool, stubbed, monkeypatch):
    monkeypatch.setattr(cudaprov, "MAX_CHUNK", 7)
    items = signed(keypool[:3], 8, seed=6) + port(
        [RefItem(REF_P256, b"\x04" + b"\x00" * 10, b"\x30\x00", b"x")])
    prov = CudaProvider(device="cpu", fast_key_threshold=4)
    got = prov.batch_verify(items)
    assert got.tolist() == even_r(items[:-1]) + [False]
    sizes = [len(s) for kind, s in stubbed if kind == "kp3"]
    assert sizes == [7, 7, 7, 3]
    assert prov.stats["dispatches"] == 4 and prov.stats["host_rejects"] == 1


def test_failed_launch_releases_pins(keypool, stubbed, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("p256_verify_rows launch failed: CUDA error 700")

    monkeypatch.setattr(cudaprov.p256_fixed, "p256_verify_rows", broken)
    prov = CudaProvider(device="cpu", fast_key_threshold=4)
    with pytest.raises(RuntimeError, match="launch failed"):
        prov.batch_verify(signed(keypool[:2], 4, seed=8))
    assert len(prov.key_tables) == 2 and not prov.key_tables._pinned
    assert prov.stats["fallbacks"] == 0


# ---------------------------------------------------------------------------
# The two Ed25519 lanes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ed_keys():
    rng = random.Random(43)
    return [crypto.ed25519_key_from_seed(rng.randbytes(32))
            for _ in range(12)]


def ed_signed(keys, per_key, seed, bad_every=0):
    """per_key Ed25519 signatures under each key, every bad_every-th
    with a wrong message, shuffled -> (port items, labels)."""
    rng = random.Random(seed)
    items, labels = [], []
    for key in keys:
        pub = crypto.ed25519_public_bytes(key)
        for _ in range(per_key):
            msg = rng.randbytes(rng.randrange(0, 80))
            sig = crypto.ed25519_sign(key, msg)
            good = not bad_every or len(items) % bad_every != 1
            items.append(VerifyItem(SCHEME_ED25519, pub, sig,
                                    msg if good else msg + b"!"))
            labels.append(good)
    order = list(range(len(items)))
    rng.shuffle(order)
    return [items[i] for i in order], [labels[i] for i in order]


def even_ry(items):
    """What the stubbed Ed25519 kernels answer: R's y is even."""
    return [it.signature[0] % 2 == 0 for it in items]


def ed_lanes(calls):
    ke6 = [s for kind, s in calls if kind == "ke6"]
    return sum(map(len, ke6)), sum(n for kind, n in calls if kind == "ke5")


def test_mixed_curve_batch_real_arithmetic_matches_sw(keypool, ed_keys,
                                                      monkeypatch):
    """P-256 and Ed25519 items in one batch, each curve with a hot key
    (its fixed-key lane) and one-off keys (its generic lane), corrupted
    items and malformed lengths among them: every verdict equals its
    label and SW's, all four lanes launch once, and no item reaches the
    provider's software half."""
    p_items = signed(keypool[:1], 5, seed=31) + signed(keypool[1:3], 1,
                                                        seed=32)
    p_items[2] = p_items[2]._replace(payload=hashlib.sha256(b"x").digest())
    e_hot, e_hot_labels = ed_signed(ed_keys[:1], 5, seed=33, bad_every=3)
    e_cold, e_cold_labels = ed_signed(ed_keys[1:4], 1, seed=34, bad_every=2)
    bad_len = VerifyItem(SCHEME_ED25519, b"\x01" * 31, b"\x00" * 64, b"m")
    items = p_items + e_hot + [bad_len] + e_cold
    labels = ([i != 2 for i in range(len(p_items))] + e_hot_labels
              + [False] + e_cold_labels)
    prov = CudaProvider(device="cpu", fast_key_threshold=4)

    def no_sw(*args, **kwargs):
        raise AssertionError("an item reached the software provider")

    monkeypatch.setattr(prov.sw, "batch_verify", no_sw)
    monkeypatch.setattr(prov.sw, "_verify_one", no_sw)
    got = prov.batch_verify(items)
    assert got.tolist() == labels
    np.testing.assert_array_equal(got, SoftwareProvider().batch_verify(items))
    assert prov.stats["dispatches"] == 4 and prov.stats["fallbacks"] == 0
    assert prov.stats["fast_key_sigs"] == 5 + 5
    assert prov.stats["host_rejects"] == 1
    snap = prov.stats_snapshot()
    assert snap.p256_table_builds == 1 and snap.ed25519_table_builds == 1
    assert not prov.key_tables._pinned and not prov.ed_key_tables._pinned


def test_ed25519_lane_choice(ed_keys, stubbed):
    """Keys that bring >= threshold signatures ride KE6 key-major; the
    rest ride KE5; a key that does not decompress gets no table, however
    many signatures it brings; a resident key rides KE6 for one."""
    hot, _ = ed_signed(ed_keys[:3], 5, seed=41)
    cold, _ = ed_signed(ed_keys[3:9], 1, seed=42)
    bogus_pk = (2**255 - 19 + 1).to_bytes(32, "little")   # y >= p
    bogus = [VerifyItem(SCHEME_ED25519, bogus_pk, it.signature, it.payload)
             for it in cold[:5]]
    items = hot + cold + bogus
    prov = CudaProvider(device="cpu", fast_key_threshold=4)
    assert prov.batch_verify(items).tolist() == even_ry(items)
    assert ed_lanes(stubbed) == (15, 6 + 5)
    st = prov.ed_key_tables.stats
    assert st["builds"] == 3 and st["rejects"] == 1
    assert prov.stats_snapshot().ed25519_table_builds == 3
    assert prov.stats["fast_key_sigs"] == 15
    slots = stubbed[0][1]
    runs = [s for j, s in enumerate(slots) if j == 0 or s != slots[j - 1]]
    assert len(runs) == len(set(runs)) == 3
    one = ed_signed(ed_keys[:1], 1, seed=43)[0] + cold[:1]
    slot0 = prov.ed_key_tables._slots[one[0].pubkey]
    assert prov.batch_verify(one).tolist() == even_ry(one)
    assert stubbed[-2:] == [("ke6", [slot0]), ("ke5", 1)]
    assert st["builds"] == 3 and not prov.ed_key_tables._pinned
    # h2d: 104 bytes per KE6 signature (ry, r_sign, s, k, slot), 136 per
    # KE5 signature (ay, a_sign, ry, r_sign, s, k)
    assert prov.stats["h2d_bytes"] == (15 + 1) * 104 + (11 + 1) * 136
    assert prov.ed_key_tables.stats["h2d_bytes"] == 3 * 230_880


def test_ed25519_failed_launch_releases_pins(ed_keys, stubbed, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("ed25519_verify_rows launch failed: CUDA error 700")

    monkeypatch.setattr(cudaprov.ed25519, "ed25519_verify_rows", broken)
    prov = CudaProvider(device="cpu", fast_key_threshold=4)
    items, _ = ed_signed(ed_keys[:2], 4, seed=44)
    with pytest.raises(RuntimeError, match="launch failed"):
        prov.batch_verify(items)
    assert len(prov.ed_key_tables) == 2 and not prov.ed_key_tables._pinned
    assert prov.stats["fallbacks"] == 0


def test_ed25519_chunks_scatter_back(ed_keys, stubbed, monkeypatch):
    monkeypatch.setattr(cudaprov, "MAX_CHUNK", 4)
    hot, _ = ed_signed(ed_keys[:2], 5, seed=45)
    cold, _ = ed_signed(ed_keys[2:7], 1, seed=46)
    items = cold[:2] + hot + cold[2:]
    prov = CudaProvider(device="cpu", fast_key_threshold=4)
    assert prov.batch_verify(items).tolist() == even_ry(items)
    assert [len(s) for kind, s in stubbed if kind == "ke6"] == [4, 4, 2]
    assert [n for kind, n in stubbed if kind == "ke5"] == [4, 1]
    assert prov.stats["dispatches"] == 5


def test_ed25519_spill_when_slots_pinned(ed_keys, stubbed):
    """Two slots, three hot keys: the third key's build finds both slots
    pinned by this batch and its signatures ride KE5."""
    items = []
    for j, key in enumerate(ed_keys[:3]):
        items += ed_signed([key], 6 - j, seed=47 + j)[0]
    prov = CudaProvider(device="cpu", fast_key_threshold=4,
                        max_cached_keys=2)
    assert prov.batch_verify(items).tolist() == even_ry(items)
    assert ed_lanes(stubbed) == (6 + 5, 4)
    assert prov.ed_key_tables.stats["pinned_spills"] == 1
