"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU and nvcc and skips without
one.  This file imports neither JAX nor fabric_tpu, so it runs on GPU
hosts that have neither:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import hashlib
import json
import random

import numpy as np
import pytest
import torch

from fabric_tpu_torch import crypto
from fabric_tpu_torch import experiments as X
from fabric_tpu_torch.bccsp import (FactoryOpts, SCHEME_ED25519,
                                    SCHEME_P256, VerifyItem, init_factories)
from fabric_tpu_torch.bccsp.cuda import CudaProvider
from fabric_tpu_torch.bccsp.sw import SoftwareProvider
from fabric_tpu_torch.idemix import bn254 as HB
from fabric_tpu_torch.ops import bn254 as KB
from fabric_tpu_torch.experiments import proto_ilp, proto_pallas3
from fabric_tpu_torch.ops import field as F
from fabric_tpu_torch.ops import field_variants as FV
from fabric_tpu_torch.ops import isa_probe as IP
from fabric_tpu_torch.ops import ed25519 as E
from fabric_tpu_torch.ops import ed25519_tables as T
from fabric_tpu_torch.ops import p256, p256_fixed, p256_tables

import kv7_cases
from kv7_cases import kv7_heavy_lanes, kv7_lanes

R = 1 << 256


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def edge_values(m):
    return [0, 1, 2, m - 2, m - 1, m, m + 1, R - 1, (1 << 252) - 1,
            1 << 252, 0xFFF, int("FFF" * 21, 16), F.P, F.N]


@pytest.mark.cuda
@pytest.mark.parametrize("modulus", ["p", "n", "p25519", "bn254"])
def test_field_mul_chain_kernel_matches_plain_and_ints(modulus, cuda_device):
    rng = random.Random(9)
    m = F.MODS[modulus].m
    va = edge_values(m) + [rng.randrange(R) for _ in range(1000)]
    vb = [rng.randrange(R) for _ in range(1000)] + edge_values(m)[::-1]
    a = F.ints_to_words_le(va, cuda_device)
    b = F.ints_to_words_le(vb, cuda_device)
    rinv = pow(R, -1, m)
    for k in (0, 1, 7):
        before = F.field_mul_chain.launches
        got = F.field_mul_chain(a, b, k, modulus)
        torch.cuda.synchronize()
        assert F.field_mul_chain.launches == before + 1
        assert torch.equal(got, F.mul_chain_plain(a, b, k, modulus))
        assert F.words_le_to_ints(got) == [
            x * pow(y * rinv, k, m) % m for x, y in zip(va, vb)]


def corpus(n_good=24):
    """Signatures from the port's own signer, with the adversarial cases
    of tests/test_ecp256.py appended: rows (qx, qy, r, s, e, label)."""
    rng = random.Random(77)
    keys = [crypto.p256_key_from_scalar(rng.randrange(1, F.N))
            for _ in range(3)]
    rows = []
    for i in range(n_good):
        pub = crypto.p256_public_bytes(keys[i % 3])
        digest = hashlib.sha256(rng.randbytes(40)).digest()
        r, s = crypto.p256_sign_digest(keys[i % 3], digest)
        s = min(s, F.N - s)
        e = int.from_bytes(digest, "big")
        good = i % 3 != 2
        if not good:
            e = (e + 1) % R
        rows.append([int.from_bytes(pub[1:33], "big"),
                     int.from_bytes(pub[33:], "big"), r, s, e, good])
    x, y, r, s, e = rows[0][:5]
    rows += [[x, y, 0, s, e, False], [x, y, r, 0, e, False],
             [x, y, F.N, s, e, False], [x, y, r, F.N, e, False],
             [x, y, r, F.N - s, e, False], [x + 1, y, r, s, e, False],
             [x, y, F.N - 1, s, e, False], [0, 0, r, s, e, False],
             [x, y, 1, 1, 0, False]]
    return rows


@pytest.mark.cuda
def test_p256_verify_kernel_matches_plain(cuda_device):
    rows = corpus()
    args = [torch.from_numpy(p256.ints_to_words(list(v))).to(cuda_device)
            for v in list(zip(*rows))[:5]]
    table = p256_tables.g_table(cuda_device)
    for low_s in (True, False):
        got = p256.p256_verify(*args, table, require_low_s=low_s)
        torch.cuda.synchronize()
        want = p256.verify_words_plain(*args, table, require_low_s=low_s)
        assert torch.equal(got, want)
    assert got.cpu().tolist()[:24] == [r[5] for r in rows[:24]]


def probe_case(op, n, device, seed):
    """(va, vb, a, b) of the field probe: the op's edge values first,
    then seeded ones within its preconditions."""
    rng = random.Random(seed)
    m = p256.field_probe_modulus(op)
    ea, eb = p256.field_probe_edges(op)
    va = (ea + [rng.randrange(m if op == "sqr_p" else R)
                for _ in range(n)])[:n]
    vb = va if op == "sqr_p" else (eb + [rng.randrange(m)
                                         for _ in range(n)])[:n]
    a = F.ints_to_words_le(va, device)
    b = None if op == "sqr_p" else F.ints_to_words_le(vb, device)
    return va, vb, a, b


def probe_ints(op, va, vb):
    m = p256.field_probe_modulus(op)
    rinv = pow(R, -1, m)
    return [x * y * rinv % m for x, y in zip(va, vb)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 32, 33, 37, 127, 129, 4096, 4097,
                               65_536, 65_537, 270_336])
@pytest.mark.parametrize("op", p256.FIELD_PROBE_OPS)
def test_p256_field_probe_matches_plain_and_ints(op, n, cuda_device):
    """The field routines of field_ptx.cuh (mul_p, sqr_p, mont_mul_ptx
    mod n; mul_25519, KE5's and KE6's) through the probe in the plan's
    grid, bit for bit against the plain field and Python ints; the
    edge values first; ragged tails; one call, one launch."""
    va, vb, a, b = probe_case(op, n, cuda_device, 31 + n)
    before = p256.p256_field_probe.launches
    got = p256.p256_field_probe(op, a, b)
    torch.cuda.synchronize()
    assert p256.p256_field_probe.launches == before + 1
    assert torch.equal(got, p256.field_probe_plain(op, a, b))
    assert F.words_le_to_ints(got) == probe_ints(op, va, vb)


@pytest.mark.cuda
@pytest.mark.parametrize("op", p256.FIELD_PROBE_OPS)
def test_p256_field_probe_rejects_misaligned(op, cuda_device):
    """A view 4 bytes past a 16-byte boundary raises ValueError, for a
    and for b; nothing launches and nothing falls back."""
    n = 40
    _, _, a, b = probe_case(op, n, cuda_device, 5)
    buf = torch.zeros(n * 8 + 4, dtype=torch.uint32, device=cuda_device)
    off = buf[1:n * 8 + 1].view(n, 8)
    off.copy_(a)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    before = p256.p256_field_probe.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        p256.p256_field_probe(op, off, None if b is None else b)
    if b is not None:
        offb = buf[1:n * 8 + 1].view(n, 8)
        offb.copy_(b)
        with pytest.raises(ValueError, match="16-byte aligned"):
            p256.p256_field_probe(op, a, offb)
    assert p256.p256_field_probe.launches == before


def on_curve_rows(rows):
    return [r for r in rows if p256_tables.on_curve(r[0], r[1])]


def bank_for(rows, device):
    """-> (bank (K, 8192, 16) on device, slot per row) for rows' keys."""
    keys = {}
    for r in rows:
        keys.setdefault((r[0], r[1]), len(keys))
    bank = torch.stack([torch.from_numpy(p256_tables.comb_table_for_point(*k))
                        for k in keys]).to(device)
    return bank, np.asarray([keys[r[0], r[1]] for r in rows], np.int32)


@pytest.mark.cuda
def test_p256_verify_rows_kernel_matches_plain(cuda_device):
    rows = on_curve_rows(corpus())
    random.Random(3).shuffle(rows)              # not key-major: any order
    bank, slot = bank_for(rows, cuda_device)
    r, s, e = [torch.from_numpy(p256.ints_to_words(list(v))).to(cuda_device)
               for v in list(zip(*rows))[2:5]]
    table = p256_tables.g_table(cuda_device)
    slot_t = torch.from_numpy(slot)
    for low_s in (True, False):
        before = p256_fixed.p256_verify_rows.launches
        got = p256_fixed.p256_verify_rows(r, s, e, slot_t, bank, table,
                                          require_low_s=low_s)
        torch.cuda.synchronize()
        assert p256_fixed.p256_verify_rows.launches == before + 1
        want = p256_fixed.verify_words_rows_plain(r, s, e, slot_t, bank,
                                                  table, require_low_s=low_s)
        assert torch.equal(got, want)
    low = p256_fixed.p256_verify_rows(r, s, e, slot_t, bank, table)
    assert low.cpu().tolist() == [bool(row[5]) for row in rows]
    with pytest.raises(ValueError, match="slot"):
        p256_fixed.p256_verify_rows(r, s, e, slot_t + 3, bank, table)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 129, 39_500])
def test_kp3_batched_inverse_matches_plain(n, cuda_device):
    """KP3 takes s^-1 over each block of 128 threads at once: at batch
    sizes around a block and at the block's size of the main path, with
    refused s (0, n, above n, 2^256 - 1, high-S) scattered through one
    block of threads, the verdicts equal the plain version's and the
    labels."""
    base = on_curve_rows(corpus())
    rows = [list(base[i % len(base)]) for i in range(n)]
    lo = (n - 1) // 128 // 2 * 128             # one block, mid-batch
    bad = (0, F.N, F.N + 3, R - 1, F.N - base[0][3])
    for k, i in enumerate(range(lo + 1, min(n, lo + 128), 9)):
        rows[i][3], rows[i][5] = bad[k % len(bad)], False
    bank, slot = bank_for(rows, cuda_device)
    r, s, e = [torch.from_numpy(p256.ints_to_words(list(v))).to(cuda_device)
               for v in list(zip(*rows))[2:5]]
    table = p256_tables.g_table(cuda_device)
    slot_t = torch.from_numpy(slot)
    for low_s in (True, False):
        got = p256_fixed.p256_verify_rows(r, s, e, slot_t, bank, table,
                                          require_low_s=low_s)
        want = p256_fixed.verify_words_rows_plain(r, s, e, slot_t, bank,
                                                  table, require_low_s=low_s)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        if low_s:
            assert got.cpu().tolist() == [bool(row[5]) for row in rows]


def hot_key_items(n_keys, per_key, seed):
    """Signed P-256 items under n_keys keys, every fifth with a wrong
    digest -> (items, labels)."""
    rng = random.Random(seed)
    keys = [crypto.p256_key_from_scalar(rng.randrange(1, F.N))
            for _ in range(n_keys)]
    items, labels = [], []
    for i in range(n_keys * per_key):
        key = keys[i % n_keys]
        digest = hashlib.sha256(rng.randbytes(20)).digest()
        r, s = crypto.p256_sign_digest(key, digest)
        good = i % 5 != 2
        if not good:
            digest = hashlib.sha256(b"other").digest()
        items.append(VerifyItem(SCHEME_P256, crypto.p256_public_bytes(key),
                                crypto.encode_dss_signature(r, min(s, F.N - s)),
                                digest))
        labels.append(good)
    return items, labels


@pytest.mark.cuda
def test_cuda_provider_hot_keys_ride_kp3(cuda_device):
    items, labels = hot_key_items(3, 8, seed=5)
    prov = CudaProvider(fast_key_threshold=4)
    before = (p256_fixed.p256_verify_rows.launches,
              p256.p256_verify.launches)
    got = prov.batch_verify(items)
    assert (p256_fixed.p256_verify_rows.launches,
            p256.p256_verify.launches) == (before[0] + 1, before[1])
    assert got.tolist() == labels
    np.testing.assert_array_equal(got, SoftwareProvider().batch_verify(items))
    assert prov.stats["fast_key_sigs"] == len(items)
    assert prov.key_tables.stats["builds"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("b_stream", ["same", "other"])
def test_eviction_across_unresolved_batches(b_stream, cuda_device):
    """Two slots, two batches of two hot keys each: the second batch, on
    the first one's stream or on another, evicts and rewrites both slots
    the first batch's KP3 reads while that KP3 still waits behind a
    ~0.5 s spin on its stream.  The tables come ready-made, so the
    rewrites are enqueued at once; were they not ordered after the first
    KP3, it would read the second batch's keys and reject the first
    batch's good signatures."""
    a, want_a = hot_key_items(2, 6, seed=7)
    b, want_b = hot_key_items(2, 6, seed=8)
    tables = {it.pubkey: p256_tables.table_for_pubkey(it.pubkey)
              for it in a + b}
    # builds and loads the C parser and KP3 before the timed part
    assert CudaProvider(fast_key_threshold=4).batch_verify(a).tolist() \
        == want_a
    prov = CudaProvider(fast_key_threshold=4, max_cached_keys=2)
    prov.key_tables.build_fn = tables.get
    side = (torch.cuda.Stream() if b_stream == "other"
            else torch.cuda.current_stream())
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 30)
    res_a = prov.batch_verify_async(a)
    with torch.cuda.stream(side):
        res_b = prov.batch_verify_async(b)
    assert prov.key_tables.stats["evictions"] == 2
    assert res_b().tolist() == want_b
    assert res_a().tolist() == want_a
    assert prov.stats["fast_key_sigs"] == len(a) + len(b)


@pytest.mark.cuda
def test_empty_batch_counts_no_launch(cuda_device):
    table = p256_tables.g_table(cuda_device)
    w = torch.zeros((8, 0), dtype=torch.uint32, device=cuda_device)
    bank = torch.zeros((1, 8192, 16), dtype=torch.uint32, device=cuda_device)
    before = (p256.p256_verify.launches, p256_fixed.p256_verify_rows.launches,
              F.field_mul_chain.launches)
    assert p256.p256_verify(w, w, w, w, w, table).shape == (0,)
    assert p256_fixed.p256_verify_rows(
        w, w, w, torch.zeros(0, dtype=torch.int32), bank, table).shape == (0,)
    a = torch.zeros((0, 8), dtype=torch.uint32, device=cuda_device)
    assert F.field_mul_chain(a, a, 3).shape == (0, 8)
    assert (p256.p256_verify.launches, p256_fixed.p256_verify_rows.launches,
            F.field_mul_chain.launches) == before


@pytest.mark.cuda
def test_cuda_provider_matches_sw(cuda_device):
    rows = corpus()
    items = [VerifyItem(SCHEME_P256,
                        b"\x04" + qx.to_bytes(32, "big") + qy.to_bytes(32, "big"),
                        crypto.encode_dss_signature(r, s),
                        e.to_bytes(32, "big"))
             for qx, qy, r, s, e, _ in rows]
    items.append(VerifyItem(SCHEME_P256, items[0].pubkey[:33],
                            items[0].signature, items[0].payload))
    prov = init_factories(FactoryOpts(default="CUDA"))
    before = p256.p256_verify.launches
    got = prov.batch_verify(items)
    assert p256.p256_verify.launches == before + 1
    np.testing.assert_array_equal(got, SoftwareProvider().batch_verify(items))
    assert prov.stats["fallbacks"] == 0
    assert prov.stats["host_rejects"] == 3      # r = 0, s = 0, short point


# ---------------------------------------------------------------------------
# Ed25519: KE5 and KE6
# ---------------------------------------------------------------------------

ED_P = 2**255 - 19


def ed_corpus():
    """Ed25519 items under 4 keys with the corrupted kinds of
    tests/test_torch_ed25519.py (wrong message, flipped R bit, swapped
    key, S + L, non-canonical y in A and in R, y = 1 with sign 1) and
    their labels."""
    rng = random.Random(55)
    keys = [crypto.ed25519_key_from_seed(rng.randbytes(32)) for _ in range(4)]
    pubs = [crypto.ed25519_public_bytes(k) for k in keys]
    items, labels = [], []
    for i in range(40):
        j = i % 4
        msg = rng.randbytes(rng.randrange(0, 300))
        sig = crypto.ed25519_sign(keys[j], msg)
        pk, kind = pubs[j], i % 10
        if kind == 1:
            msg = msg + b"x"
        elif kind == 3:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        elif kind == 4:
            pk = pubs[(j + 1) % 4]
        elif kind == 6:
            s = int.from_bytes(sig[32:], "little") + E.L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif kind == 7:
            sig = (ED_P + 1).to_bytes(32, "little") + sig[32:]
        elif kind == 8:
            sig = (1 | 1 << 255).to_bytes(32, "little") + sig[32:]
        items.append(VerifyItem(SCHEME_ED25519, pk, sig, msg))
        labels.append(kind not in (1, 3, 4, 6, 7, 8))
    return items, labels


@pytest.mark.cuda
def test_ed25519_kernels_match_plain(cuda_device):
    items, labels = ed_corpus()
    bad_a = [VerifyItem(SCHEME_ED25519, (ED_P + 1).to_bytes(32, "little"),
                        items[0].signature, items[0].payload),
             VerifyItem(SCHEME_ED25519, (1 | 1 << 255).to_bytes(32, "little"),
                        items[0].signature, items[0].payload)]
    args = E.pack_verify_inputs(*zip(*[it[1:] for it in items + bad_a]))
    dev = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
           for a in args]
    table = T.b_table(cuda_device)
    before = E.ed25519_verify.launches
    got = E.ed25519_verify(*dev, table)
    torch.cuda.synchronize()
    assert E.ed25519_verify.launches == before + 1
    assert torch.equal(got, E.verify_words_plain(*dev, table))
    assert got.cpu().tolist() == labels + [False, False]
    # KE6 over the four keys' tables of -A, not key-major
    n = len(items)
    slots = {}
    for it in items:
        slots.setdefault(it.pubkey, len(slots))
    bank = torch.stack([torch.from_numpy(T.table_for_pubkey(pk))
                        for pk in slots]).to(cuda_device)
    slot = torch.tensor([slots[it.pubkey] for it in items], dtype=torch.int32)
    rows = [x[..., :n].contiguous() for x in dev[2:]]
    before = E.ed25519_verify_rows.launches
    got = E.ed25519_verify_rows(*rows, slot, bank, table)
    torch.cuda.synchronize()
    assert E.ed25519_verify_rows.launches == before + 1
    assert torch.equal(got, E.verify_words_rows_plain(*rows, slot, bank,
                                                      table))
    assert got.cpu().tolist() == labels
    with pytest.raises(ValueError, match="slot"):
        E.ed25519_verify_rows(*rows, slot + 4, bank, table)


RAGGED = (1, 7, 9, 33, 100, 129)


@pytest.fixture(scope="module")
def ed_ragged():
    """max(RAGGED) Ed25519 items under 5 keys, every third one bad in
    turn: wrong message, S + L, R.y = p + 1 (>= p), R = (y 1, sign 1)
    (x = 0 with sign 1), R.y with no x, and for KE5 A.y = p + 1 and A = (y
    1, sign 1), which do not decompress -> (items, labels, the fixed-key
    items' indices)."""
    rng = random.Random(77)
    keys = [crypto.ed25519_key_from_seed(rng.randbytes(32)) for _ in range(5)]
    pubs = [crypto.ed25519_public_bytes(k) for k in keys]
    bad = ("msg", "s_plus_l", "r_noncanon", "r_x0_sign1", "r_no_x",
           "a_noncanon", "a_x0_sign1")
    items, labels = [], []
    for i in range(max(RAGGED)):
        j = i % 5
        msg = rng.randbytes(rng.randrange(0, 120))
        sig, pk = crypto.ed25519_sign(keys[j], msg), pubs[j]
        kind = bad[(i // 3) % len(bad)] if i % 3 == 2 else None
        if kind == "msg":
            msg += b"!"
        elif kind == "s_plus_l":
            s = int.from_bytes(sig[32:], "little") + E.L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif kind == "r_noncanon":
            sig = (ED_P + 1).to_bytes(32, "little") + sig[32:]
        elif kind == "r_x0_sign1":
            sig = (1 | 1 << 255).to_bytes(32, "little") + sig[32:]
        elif kind == "r_no_x":                 # 2 is no y of the curve
            sig = (2).to_bytes(32, "little") + sig[32:]
        elif kind == "a_noncanon":
            pk = (ED_P + 1).to_bytes(32, "little")
        elif kind == "a_x0_sign1":
            pk = (1 | 1 << 255).to_bytes(32, "little")
        items.append(VerifyItem(SCHEME_ED25519, pk, sig, msg))
        labels.append(kind is None)
    fixed = [i for i, it in enumerate(items) if it.pubkey in pubs]
    return items, labels, fixed


@pytest.fixture(scope="module")
def ed_ragged_plain(ed_ragged):
    """The whole ragged corpus through both plain versions once (a
    verdict is each signature's own, so a prefix's are the prefix of
    these) -> (KE5 args, KE5 plain, KE6 args, KE6 plain), on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    items, labels, fixed = ed_ragged
    packed = E.pack_verify_inputs(*zip(*[it[1:] for it in items]))
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in packed]
    table = T.b_table(dev)
    plain5 = E.verify_words_plain(*args, table)
    slots = {}
    for i in fixed:
        slots.setdefault(items[i].pubkey, len(slots))
    bank = torch.stack([torch.from_numpy(T.table_for_pubkey(pk))
                        for pk in slots]).to(dev)
    slot = torch.tensor([slots[items[i].pubkey] for i in fixed],
                        dtype=torch.int32)
    rows = [torch.from_numpy(np.ascontiguousarray(a[..., fixed])).to(dev)
            for a in packed[2:]]
    plain6 = E.verify_words_rows_plain(*rows, slot, bank, table)
    return (args, plain5, (rows, slot, bank), plain6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", RAGGED)
def test_ed25519_kernels_ragged_sizes(n, ed_ragged, ed_ragged_plain,
                                      cuda_device):
    """KE5 and KE6 (four lanes a signature, 32 a block) on the first n
    signatures of a corpus whose bad lanes sit beside good ones in every
    quad's warp: equal to the plain versions and the labels; a bad lane
    leaks nothing into its neighbours, a quad past n writes nothing."""
    _, labels, fixed = ed_ragged
    args, plain5, (rows, slot, bank), plain6 = ed_ragged_plain
    table = T.b_table(cuda_device)
    got = E.ed25519_verify(*[a[..., :n].contiguous() for a in args], table)
    assert torch.equal(got, plain5[:n])
    assert got.cpu().tolist() == labels[:n]
    m = sum(1 for i in fixed if i < n)
    got = E.ed25519_verify_rows(*[r[..., :m].contiguous() for r in rows],
                                slot[:m].contiguous(), bank, table)
    assert torch.equal(got, plain6[:m])
    assert got.cpu().tolist() == [labels[i] for i in fixed[:m]]


@pytest.mark.cuda
def test_device_busy_two_sessions_in_a_row(ed_ragged_plain, cuda_device):
    """chip_smoke.device_busy twice in a row, each session over two
    labelled runs (KE6 launches, a copy, a matmul): every run of both
    sessions records device time, at most its wall time."""
    import chip_smoke
    _, _, (rows, slot, bank), _ = ed_ragged_plain
    table = T.b_table(cuda_device)
    x = torch.randn(512, 512, device=cuda_device)

    def ke6():
        E.ed25519_verify_rows(*rows, slot, bank, table).cpu()

    def dense():
        (x @ x).sum().item()

    for _ in range(2):
        out = chip_smoke.device_busy(torch, {"ke6": ke6, "dense": dense})
        assert set(out) == {"ke6", "dense"}
        for busy_ms, wall_ms, top in out.values():
            assert 0 < busy_ms <= wall_ms and top
        assert any("ed25519_verify_rows" in t for t in out["ke6"][2])


@pytest.mark.cuda
def test_ed25519_empty_batch_counts_no_launch(cuda_device):
    table = T.b_table(cuda_device)
    w = torch.zeros((8, 0), dtype=torch.uint32, device=cuda_device)
    sg = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    bank = torch.zeros((1, 2405, 24), dtype=torch.uint32, device=cuda_device)
    before = (E.ed25519_verify.launches, E.ed25519_verify_rows.launches)
    assert E.ed25519_verify(w, sg, w, sg, w, w, table).shape == (0,)
    assert E.ed25519_verify_rows(w, sg, w, w, sg.cpu(), bank,
                                 table).shape == (0,)
    assert (E.ed25519_verify.launches,
            E.ed25519_verify_rows.launches) == before


@pytest.mark.cuda
def test_cuda_provider_mixed_curves_match_sw(cuda_device):
    """P-256 and Ed25519 items in one batch: a hot key of each curve
    rides its fixed-key kernel, the rest the generic ones; every verdict
    equals SW's and all four kernels launch once."""
    p_items, p_labels = hot_key_items(2, 5, seed=12)
    rows = corpus()[:6]
    p_items += [VerifyItem(SCHEME_P256, b"\x04" + qx.to_bytes(32, "big")
                           + qy.to_bytes(32, "big"),
                           crypto.encode_dss_signature(r, s),
                           e.to_bytes(32, "big"))
                for qx, qy, r, s, e, _ in rows]
    e_items, e_labels = ed_corpus()
    items = p_items + e_items[:13] + [VerifyItem(
        SCHEME_ED25519, b"\x00" * 31, b"\x00" * 64, b"")]
    prov = CudaProvider(fast_key_threshold=4)
    fns = (p256_fixed.p256_verify_rows, p256.p256_verify,
           E.ed25519_verify_rows, E.ed25519_verify)
    before = [f.launches for f in fns]
    got = prov.batch_verify(items)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1, 1]
    np.testing.assert_array_equal(got, SoftwareProvider().batch_verify(items))
    assert got.tolist()[len(p_items):] == e_labels[:13] + [False]
    assert prov.stats["fallbacks"] == 0
    assert prov.stats_snapshot().ed25519_table_builds == 1


# -- KV7: the fused gate fold and MVCC (ops/block_validate.py) -----------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "block", "wide_keys",
                                   "unstaged"])
def test_kv7_matches_plain(shape, cuda_device):
    """KV7 against its plain version on seeded lanes, with the
    last-writer state in shared memory and, with more key slots than
    shared memory holds, in device memory; and with a window whose reads
    and writes do not fit its staging buffers, walked from device
    memory, where one tx writes many times to the same slots."""
    from fabric_tpu_torch.ops import block_validate as kv7
    shapes = ["small", "block", "wide_keys", "unstaged"]
    rng = np.random.default_rng(shapes.index(shape))
    T, K = {"small": (40, 16), "block": (10_000, 20_000),
            "wide_keys": (3_000, None), "unstaged": (600, 4_096)}[shape]
    if K is None:
        K = kv7.smem_slots() + 5_000
    if shape == "unstaged":
        ln = kv7_heavy_lanes(rng, T, K)
        T += 3
    else:
        ln = kv7_lanes(rng, T, K)
    buf, d = kv7.pack(ln)
    buf_d = kv7.upload(buf, cuda_device)
    before = kv7.block_validate_kernel.launches
    out = kv7.block_validate_kernel(buf_d, d, 3)
    torch.cuda.synchronize()
    assert kv7.block_validate_kernel.launches == before + 1
    gate, final = kv7.block_validate_plain(ln, 3)
    got = out.cpu()
    assert torch.equal(got[:T], gate) and torch.equal(got[T:], final)
    assert (final == 11).any() and (final == 0).any()
    if shape == "unstaged":
        assert final[:3].tolist() == [0, 0, 0]
    g2, f2 = kv7.block_validate(ln, 3, device=cuda_device)
    assert np.array_equal(g2, gate.numpy())
    assert np.array_equal(f2, final.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(kv7_cases.DIRECTED))
def test_kv7_directed_cases_match_plain(case, cuda_device):
    """KV7 on each directed case of tests/kv7_cases.py (chains inside a
    group, a delete then a read, a dependence across a group's end,
    gate-failed writers, txs too wide for a lane, T = 1, 31 and 33, a
    hot slot): equal to the plain version and the case's codes."""
    from fabric_tpu_torch.ops import block_validate as kv7
    spec, want = kv7_cases.DIRECTED[case]
    ln = kv7_cases.lanes(**spec)
    gate, final = kv7.block_validate(ln, kv7_cases.BLK, device=cuda_device)
    pg, pf = kv7.block_validate_plain(ln, kv7_cases.BLK)
    assert np.array_equal(gate, pg.numpy())
    assert np.array_equal(final, pf.numpy())
    assert final.tolist() == want


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["shared", "device"])
def test_kv7_colliding_stamps_match_plain(state, cuda_device):
    """10,000 txs over slots that share stamp buckets (0, 8192, 16384,
    ... of 40 buckets), every 7th tx too wide for a lane, with the
    last-writer state in shared memory and, with more slots than shared
    memory holds, in device memory: equal to the plain version."""
    from fabric_tpu_torch.ops import block_validate as kv7
    K = 3 * 8192 + 17 if state == "shared" else kv7.smem_slots() + 5_000
    slots = np.asarray([b + k * 8192 for b in range(40)
                        for k in range(K // 8192)])
    ln = kv7_cases.big_lanes(np.random.default_rng(11), 10_000, K, slots,
                             wide_every=7)
    assert (K <= kv7.smem_slots()) == (state == "shared")
    gate, final = kv7.block_validate(ln, kv7_cases.BLK, device=cuda_device)
    pg, pf = kv7.block_validate_plain(ln, kv7_cases.BLK)
    assert np.array_equal(gate, pg.numpy())
    assert np.array_equal(final, pf.numpy())
    assert (final == 11).any() and (final == 0).any()


def kv7_sharded_case(shape):
    """(lanes, blk_num) of a sharded KV7 case: seeded lanes at a small
    and at a block's size, the heavy txs of `kv7_heavy_lanes`, and a
    directed case with one sig lane and no read lane."""
    rng = np.random.default_rng(20 + ["small", "block", "heavy",
                                      "one_sig"].index(shape))
    if shape == "small":
        return kv7_lanes(rng, 40, 16), 3
    if shape == "block":
        return kv7_lanes(rng, 10_000, 20_000), 3
    if shape == "heavy":
        return kv7_heavy_lanes(rng, 600, 4_096), 3
    spec, _ = kv7_cases.DIRECTED["no_plan_keeps_pre"]
    return kv7_cases.lanes(**spec), kv7_cases.BLK


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("shape", ["small", "block", "heavy", "one_sig"])
def test_kv7_sharded_entry_points_match_plain(shape, k, cuda_device):
    """The multi-device branch's entry points over k shards on one card:
    each shard's fold (its partial mask and read codes) against
    block_validate_fold_plain, the finish over the stacked masks and the
    gathered codes against block_validate_finish_plain and
    block_validate_plain, and block_validate_sharded on a mesh of k
    shards of cuda:0: equal, one fold launch a non-empty shard, one KV7
    launch a call."""
    from fabric_tpu_torch.ops import block_validate as kv7
    from fabric_tpu_torch.parallel.mesh import make_mesh, shard_bounds
    ln, blk = kv7_sharded_case(shape)
    buf, d = kv7.pack(ln)
    buf_d = kv7.upload(buf, cuda_device)
    masks, rcodes = [], []
    for s_r, r_r in zip(shard_bounds(d["S"], k), shard_bounds(d["R"], k)):
        m, rc = kv7.block_validate_fold_kernel(buf_d, d, blk, s_r, r_r)
        pm, prc = kv7.block_validate_fold_plain(ln, blk, s_r, r_r)
        torch.cuda.synchronize()
        assert torch.equal(m.cpu(), pm) and torch.equal(rc.cpu(), prc)
        masks.append(m)
        rcodes.append(rc)
    stacked, gathered = torch.stack(masks), torch.cat(rcodes)
    out = kv7.block_validate_finish_kernel(buf_d, d, blk, stacked, gathered)
    torch.cuda.synchronize()
    gate, final = kv7.block_validate_finish_plain(ln, blk, stacked.cpu(),
                                                  gathered.cpu())
    pg, pf = kv7.block_validate_plain(ln, blk)
    assert torch.equal(gate, pg) and torch.equal(final, pf)
    T = d["T"]
    assert torch.equal(out.cpu()[:T], gate)
    assert torch.equal(out.cpu()[T:], final)
    live = sum(s_r[1] > s_r[0] or r_r[1] > r_r[0] for s_r, r_r in zip(
        shard_bounds(d["S"], k), shard_bounds(d["R"], k)))
    before = (kv7.block_validate_kernel.launches,
              kv7.block_validate_fold_kernel.launches)
    timings = {}
    g2, f2 = kv7.block_validate_sharded(ln, blk, make_mesh(["cuda:0"] * k),
                                        timings)
    assert np.array_equal(g2, pg.numpy()) and np.array_equal(f2, pf.numpy())
    assert (kv7.block_validate_kernel.launches,
            kv7.block_validate_fold_kernel.launches) == (before[0] + 1,
                                                         before[1] + live)
    assert timings["shards"] == k and sum(timings["fold_launches"]) == live
    assert timings["finish_ms"] > 0
    if shape == "one_sig":
        assert live == 1


@pytest.mark.cuda
def test_kv7_sharded_across_cards(cuda_device):
    """block_validate_sharded over every card of the host (the partial
    masks and read codes of shards past the first copied between cards)
    and over them twice each: equal to the plain version.  Skips on a
    host with one card."""
    from fabric_tpu_torch.ops import block_validate as kv7
    from fabric_tpu_torch.parallel.mesh import make_mesh
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices or more")
    ln, blk = kv7_sharded_case("block")
    pg, pf = kv7.block_validate_plain(ln, blk)
    cards = [f"cuda:{i}" for i in range(n)]
    for devices in (cards, cards * 2):
        timings = {}
        g, f = kv7.block_validate_sharded(ln, blk, make_mesh(devices),
                                          timings)
        assert np.array_equal(g, pg.numpy()) and np.array_equal(f, pf.numpy())
        assert timings["shards"] == len(devices)


def port_stack(device_validate, provider, orgs, device):
    from fabric_tpu_torch.committer import (Committer, PolicyRegistry,
                                            TxValidator)
    from fabric_tpu_torch.committer.device_validate import DeviceValidator
    from fabric_tpu_torch.ledger import KVLedger, LedgerConfig
    from fabric_tpu_torch.msp import CachedMSP
    from fabric_tpu_torch.policy import parse_policy
    msps = {o.mspid: CachedMSP(o.msp()) for o in orgs}
    pol = PolicyRegistry()
    pol.set_policy("cc", parse_policy("AND('Org1.member', 'Org2.member')"))
    lg = KVLedger("ch", LedgerConfig(device_validate=device_validate))
    dv = None
    if device_validate:
        dv = DeviceValidator(lg.statedb, "ch", device=device)
        lg.set_prepared_source(dv.take_prepared)
    return Committer(lg, TxValidator("ch", msps, provider, pol,
                                     device_validate=dv)), dv


def chained(env_blocks):
    from fabric_tpu_torch.protocol import block_header_hash, build
    raws, prev = [], b"\x00" * 32
    for num, envs in enumerate(env_blocks):
        block = build.new_block(num, prev, envs)
        prev = block_header_hash(block.header)
        raws.append(block.serialize())
    return raws


@pytest.fixture(scope="module")
def dev_orgs():
    from fabric_tpu_torch.msp.ca import DevOrg
    init_factories(FactoryOpts(default="SW"))
    return DevOrg("Org1"), DevOrg("Org2")


def endorsed(orgs, reads=(), writes=()):
    from fabric_tpu_torch.protocol import NsRwSet, TxRwSet, build
    rws = TxRwSet((NsRwSet("cc", reads=tuple(reads), writes=tuple(writes),
                           range_queries=()),))
    return build.endorser_tx("ch", "cc", "1.0", rws,
                             orgs[0].new_identity("c"),
                             [orgs[0].new_identity("e1"),
                              orgs[1].new_identity("e2")])


@pytest.mark.cuda
def test_two_block_stream_device_on_and_off(cuda_device, dev_orgs):
    """A two-block stream through port stacks with KV7 on and off: the
    same flags, state and commit hash, one launch per block."""
    from fabric_tpu_torch.ops import block_validate as kv7
    from fabric_tpu_torch.protocol import KVRead, KVWrite, Version, wire
    b0 = [endorsed(dev_orgs, writes=[KVWrite(f"k{i}", b"v")])
          for i in range(6)]
    b1 = [endorsed(dev_orgs, reads=[KVRead("k0", Version(0, 0))],
                   writes=[KVWrite("k0", b"a")]),
          endorsed(dev_orgs, reads=[KVRead("k0", Version(0, 0))]),
          endorsed(dev_orgs, reads=[KVRead("k1", Version(0, 1))],
                   writes=[KVWrite("k1", b"", True)]),
          endorsed(dev_orgs, reads=[KVRead("k1", None)])]
    raws = chained([b0, b1])
    sw = SoftwareProvider()
    out = {}
    for on in (False, True):
        committer, dv = port_stack(on, sw, dev_orgs, cuda_device)
        before = kv7.block_validate_kernel.launches
        codes = [committer.store_block(wire.parse_block(r)).final_flags
                 .codes() for r in raws]
        out[on] = (codes, committer.ledger.commit_hash,
                   sorted(committer.ledger.statedb._data.items()))
        if on:
            assert kv7.block_validate_kernel.launches == before + 2
            assert dv.stats["validator_device_blocks_total"] == 2
    assert out[False] == out[True]
    assert out[True][0] == [[0] * 6, [0, 11, 0, 0]]


def tree_bytes(root) -> dict:
    import os
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.cuda
def test_durable_stream_kv7_reopen(cuda_device, dev_orgs, tmp_path):
    """A durable ledger (root, 4 state shards, a checkpoint every block)
    with KV7 on the card: two blocks, a reopen (the DeviceValidator of
    the reopened ledger reads its recovered savepoint), a third block
    through KV7; flags, state, commit hash and the whole directory equal
    a durable host-MVCC stack's."""
    from fabric_tpu_torch.committer import (Committer, PolicyRegistry,
                                            TxValidator)
    from fabric_tpu_torch.committer.device_validate import DeviceValidator
    from fabric_tpu_torch.ledger import KVLedger, LedgerConfig
    from fabric_tpu_torch.msp import CachedMSP
    from fabric_tpu_torch.ops import block_validate as kv7
    from fabric_tpu_torch.policy import parse_policy
    from fabric_tpu_torch.protocol import KVRead, KVWrite, Version, wire
    b0 = [endorsed(dev_orgs, writes=[KVWrite(f"k{i}", b"v")])
          for i in range(6)]
    b1 = [endorsed(dev_orgs, reads=[KVRead("k0", Version(0, 0))],
                   writes=[KVWrite("k0", b"a")]),
          endorsed(dev_orgs, reads=[KVRead("k0", Version(0, 0))])]
    b2 = [endorsed(dev_orgs, reads=[KVRead("k0", Version(1, 0))],
                   writes=[KVWrite("k0", b"b"), KVWrite("k2", b"", True)])]
    raws = chained([b0, b1, b2])
    sw = SoftwareProvider()

    def stack(root, on):
        pol = PolicyRegistry()
        pol.set_policy("cc", parse_policy(
            "AND('Org1.member', 'Org2.member')"))
        lg = KVLedger("ch", LedgerConfig(root=str(root), device_validate=on,
                                         state_shards=4, snapshot_every=1))
        dv = None
        if on:
            dv = DeviceValidator(lg.statedb, "ch", device=cuda_device)
            lg.set_prepared_source(dv.take_prepared)
        msps = {o.mspid: CachedMSP(o.msp()) for o in dev_orgs}
        return Committer(lg, TxValidator("ch", msps, sw, pol,
                                         device_validate=dv)), dv

    out = {}
    for on in (False, True):
        root = tmp_path / ("kv7" if on else "host")
        before = kv7.block_validate_kernel.launches
        committer, dv = stack(root, on)
        codes = [committer.store_block(wire.parse_block(r)).final_flags
                 .codes() for r in raws[:2]]
        committer, dv = stack(root, on)
        assert committer.ledger.height == 2
        assert committer.ledger.last_recovery["replayed_blocks"] == 0
        codes.append(committer.store_block(wire.parse_block(raws[2]))
                     .final_flags.codes())
        lg = committer.ledger
        out[on] = (codes, lg.commit_hash,
                   sorted(lg.statedb._data.items()), tree_bytes(root))
        if on:
            assert kv7.block_validate_kernel.launches == before + 3
            assert dv.stats["validator_device_blocks_total"] == 1
            assert dv.stats["validator_device_stash_misses_total"] == 0
    assert out[False] == out[True]
    assert out[True][0] == [[0] * 6, [0, 11], [0]]


@pytest.mark.cuda
def test_config_block_on_card(cuda_device, dev_orgs, tmp_path):
    """A config update adding Org3, signed by the Admins of Org1 and
    Org2, committed on a durable ledger through the CUDA provider: the
    creator's and the admins' signatures launch the P-256 lanes, the
    bundle moves to sequence 1, a tx endorsed by Org3 is refused before
    and valid after, a non-admin update is INVALID_CONFIG_TRANSACTION,
    and the config history survives a reopen."""
    from fabric_tpu_torch import config as C
    from fabric_tpu_torch.committer import (Committer, PolicyRegistry,
                                            TxValidator)
    from fabric_tpu_torch.ledger import ConfigHistory, KVLedger, LedgerConfig
    from fabric_tpu_torch.msp.ca import DevOrg
    from fabric_tpu_torch.policy import parse_policy
    from fabric_tpu_torch.protocol import KVWrite, NsRwSet, TxRwSet, build
    from fabric_tpu_torch.protocol import wire
    o1, o2 = dev_orgs
    o3 = DevOrg("Org3")

    def org(d):
        mc = d.msp_config()
        return C.OrgConfig(d.mspid, tuple(mc.root_certs_pem),
                           tuple(mc.admin_certs_pem))

    def config(devs, seq):
        return C.ChannelConfig("ch", seq, tuple(org(d) for d in devs),
                               C.default_policies([d.mspid for d in devs]))

    def tx(key):
        rws = TxRwSet((NsRwSet("cc", writes=(KVWrite(key, b"v"),)),))
        return build.endorser_tx("ch", "cc", "1.0", rws,
                                 o1.new_identity("c"),
                                 [o3.new_identity("peer0")])

    raws = chained([
        [tx("before")],
        [C.build_config_envelope(config([o1, o2, o3], 1),
                                 [o1.admin, o2.admin])],
        [tx("after")],
        [C.build_config_envelope(config([o1, o2], 2),
                                 [o1.new_identity("m"),
                                  o2.new_identity("m2")])]])
    prov = CudaProvider(device=cuda_device)
    src = C.BundleSource(C.Bundle(config([o1, o2], 0)))

    def stack():
        lg = KVLedger("ch", LedgerConfig(root=str(tmp_path)))
        ch = ConfigHistory(str(tmp_path / "ch" / "confighistory"))
        pol = PolicyRegistry(parse_policy("OR('Org3.member')"))
        return Committer(lg, TxValidator("ch", None, prov, pol,
                                         bundle_source=src),
                         bundle_source=src, provider=prov, confighistory=ch)

    committer = stack()
    codes = []
    for i, raw in enumerate(raws):
        before = p256.p256_verify.launches
        codes.append(committer.store_block(wire.parse_block(raw))
                     .final_flags.codes())
        if i == 1:
            assert p256.p256_verify.launches >= before + 2
    assert codes == [[10], [0], [0], [6]]
    assert src.current().sequence == 1
    assert prov.stats["fallbacks"] == 0
    reopened = stack()
    assert reopened.confighistory.entries() == \
        committer.confighistory.entries()
    assert reopened.confighistory.latest_height() == 1
    assert reopened.ledger.commit_hash == committer.ledger.commit_hash


@pytest.mark.cuda
def test_kv7_launch_error_propagates(cuda_device, dev_orgs, monkeypatch):
    """A KV7 launch the card refuses (here: more shared memory than a
    block may have) raises out of DeviceValidator.run; nothing falls
    back to the host path or the plain version."""
    from fabric_tpu_torch.ops import block_validate as kv7
    from fabric_tpu_torch.protocol import KVWrite, wire
    slots = kv7.smem_slots()
    writes = [KVWrite(f"w{i:06d}", b"") for i in range(slots + 1_000)]
    raws = chained([[endorsed(dev_orgs, writes=writes)]])
    committer, dv = port_stack(True, SoftwareProvider(), dev_orgs,
                               cuda_device)
    monkeypatch.setattr(kv7, "smem_slots", lambda: 1 << 30)
    before = kv7.block_validate_kernel.launches
    with pytest.raises(RuntimeError, match="block_validate launch failed"):
        committer.store_block(wire.parse_block(raws[0]))
    assert kv7.block_validate_kernel.launches == before
    assert dv.stats["validator_device_demotions_total"]["error"] == 0
    assert committer.ledger.height == 0


# ---------------------------------------------------------------------------
# KB8: the BN254 pairing check of the idemix lane
# ---------------------------------------------------------------------------

def pairing_load(n, seed):
    """n checks e(P1, w_j) * e(P2, g2) == 1 under two issuers (slots 1
    and 2, w_j = x_j g2), with A'_i chained by additions of G1 and
    P2 = -x_j A'_i; every 11th from the 3rd has Abar made with x_j + 1,
    from the 7th names the other issuer's slot, from the 9th swaps P1
    and P2; check 5 carries x1 + p where that fits in 256 bits.  ->
    (flags, lines, slot, [x1, y1, x2, y2] ints, labels)."""
    rng = random.Random(seed)
    xs = [rng.randrange(2, HB.R) for _ in range(2)]
    flags, lines = KB.stack_lines(
        [KB.pack_steps(HB.ate_precompute(q)) for q in
         [HB.G2_GEN] + [HB.g2_mul(x, HB.G2_GEN) for x in xs]])
    a = HB.g1_mul(rng.randrange(1, HB.R), HB.G1_GEN)
    steps = [HB.g1_mul(x, HB.G1_GEN) for x in xs]
    abar = [HB.g1_mul(x, a) for x in xs]
    slot, cols, labels = [], [[], [], [], []], []
    for i in range(n):
        j = i % 2
        p1, p2, s, ok = a, HB.g1_neg(abar[j]), j + 1, True
        if i % 11 == 3:
            p2, ok = HB.g1_neg(HB.g1_add(abar[j], a)), False
        elif i % 11 == 7:
            s, ok = 2 - j, False
        elif i % 11 == 9:
            p1, p2, ok = p2, p1, False
        x1 = p1[0] + HB.P if i == 5 and p1[0] + HB.P < R else p1[0]
        for c, v in zip(cols, (x1, p1[1], p2[0], p2[1])):
            c.append(v)
        slot.append(s)
        labels.append(ok)
        a = HB.g1_add(a, HB.G1_GEN)
        abar = [HB.g1_add(b, st) for b, st in zip(abar, steps)]
    return flags, lines, np.asarray(slot, np.int32), cols, labels


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 1024])
def test_bn254_pairing_kernel_matches_plain(n, cuda_device):
    """KB8 against its plain version and the labels, two issuer slots,
    corrupted lanes and a coordinate in [p, 2^256)."""
    flags, lines, slot, cols, labels = pairing_load(n, 50 + n)
    fl = torch.from_numpy(flags).to(cuda_device)
    ln = torch.from_numpy(lines).to(cuda_device)
    sl = torch.from_numpy(slot)
    words = [torch.from_numpy(KB.ints_to_words(c)).to(cuda_device)
             for c in cols]
    before = KB.bn254_pairing_check.launches
    got = KB.bn254_pairing_check(fl, ln, sl, *words)
    torch.cuda.synchronize()
    assert KB.bn254_pairing_check.launches == before + 1
    assert got.cpu().tolist() == labels
    assert torch.equal(got, KB.pairing_check_batch(fl, ln, sl, *words))


def tower_words(n, seed, device, cyclotomic=False):
    """n seeded Fp12 values as the tower probe's (6, 2, 8, n) words; with
    cyclotomic, each taken through the easy part of the final
    exponentiation (plain, on the device)."""
    rng = random.Random(seed)
    vals = [tuple((rng.randrange(HB.P), rng.randrange(HB.P))
                  for _ in range(6)) for _ in range(n)]
    f = KB.f12_from_ints(vals, device)
    return KB.f12_to_words(KB.final_exp_easy(f) if cyclotomic else f)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 1024])
@pytest.mark.parametrize("op", KB.PROBE_OPS)
def test_bn254_tower_probe_matches_plain(op, n, cuda_device):
    """Each of KB8's tower routines through the probe, bit for bit
    against its plain version; cyc_sqr and pow_u on cyclotomic inputs."""
    a = tower_words(n, 70 + n, cuda_device, op in ("cyc_sqr", "pow_u"))
    b = tower_words(n, 71 + n, cuda_device) if op in KB.BINARY_OPS else None
    before = KB.bn254_tower_probe.launches
    got = KB.bn254_tower_probe(op, a, b)
    torch.cuda.synchronize()
    assert KB.bn254_tower_probe.launches == before + 1
    assert torch.equal(got, KB.tower_probe_plain(op, a, b))


def idemix_items():
    """Two issuers' presentations (valid), a forged credential that
    passes every host check, a presentation over another payload, a
    cross-issuer swap and garbage -> (items, labels)."""
    import tempfile
    from fabric_tpu_torch.idemix import gen
    from fabric_tpu_torch.idemix.msp import IdemixSigningIdentity
    signers = []
    for org, user in (("IdemixOrg", "alice"), ("OtherOrg", "carol")):
        d = tempfile.mkdtemp()
        gen.generate(d, org, [f"{user}:eng:member"])
        signers.append(gen.load_signer(f"{d}/{user}.signer",
                                       f"{d}/msp_config.bin"))
    alice, carol = signers
    items = [s.verify_item(b"m%d" % i, s.sign(b"m%d" % i))
             for i, s in enumerate(signers)]
    c = alice._cred
    forged = IdemixSigningIdentity(
        "IdemixOrg", alice._config,
        type(c)(HB.g1_mul(12345, HB.G1_GEN), c.e, c.s, list(c.attrs)),
        alice.ou, alice.role, handle_sig=alice._handle_sig)
    items += [forged.verify_item(b"f", forged.sign(b"f")),
              alice.verify_item(b"other", alice.sign(b"x")),
              VerifyItem(items[1].scheme, items[1].pubkey,
                         items[0].signature, items[1].payload),
              VerifyItem(items[0].scheme, items[0].pubkey, b"\x01\x02",
                         items[0].payload)]
    return items, [True, True, False, False, False, False]


@pytest.mark.cuda
def test_cuda_provider_idemix_matches_sw(cuda_device):
    items, labels = idemix_items()
    prov = CudaProvider()
    before = KB.bn254_pairing_check.launches
    got = prov.batch_verify(items)
    assert KB.bn254_pairing_check.launches == before + 1
    assert got.tolist() == labels
    assert SoftwareProvider().batch_verify(items).tolist() == labels
    # the two valid presentations and the forged credential reach the
    # card; the other payload, the swap (its non-revocation proof is
    # bound to the other issuer's epoch key) and garbage stop at the host
    # checks
    from fabric_tpu_torch.idemix.msp import collect_item_parts
    reach = [True] * 3 + [False] * 3
    assert [collect_item_parts(it)[0] for it in items] == reach
    assert prov.stats["device_sigs"] == reach.count(True)
    assert prov.stats["fallbacks"] == 0
    fn, green, red = prov.idemix_pair_probe(128)
    assert fn(*green).all() and not fn(*red).any()


@pytest.mark.cuda
def test_idemix_launch_error_propagates(cuda_device, monkeypatch):
    """A KB8 launch the card refuses (here: more threads per block than
    a block may have) raises out of batch_verify; nothing falls back to
    the host verifier or the plain version."""
    items, _ = idemix_items()
    prov = CudaProvider()
    monkeypatch.setattr(KB, "THREADS", 2048)
    before = KB.bn254_pairing_check.launches
    with pytest.raises(RuntimeError, match="bn254_pairing launch failed"):
        prov.batch_verify(items[:2])
    assert KB.bn254_pairing_check.launches == before
    assert prov.stats["fallbacks"] == 0


# ---------------------------------------------------------------------------
# KP1 at the reference's R, KF2 and KI3 (the experiments' counterparts)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kp1_at_reference_r_matches_ints_and_plain(cuda_device):
    """KP1 at r_log2=264 on the scripts' data (default_rng(0)) computes
    experiments/proto_pallas.py's function, a Mont chain with R = 2^264."""
    B = 4096
    a, b = X.operands(B, cuda_device)
    for k in (0, 1, 192):
        before = F.field_mul_chain.launches
        got = F.field_mul_chain(a, b, k, "p", r_log2=264)
        torch.cuda.synchronize()
        assert F.field_mul_chain.launches == before + 1
        assert torch.equal(got, F.mul_chain_plain(a, b, k, "p", r_log2=264))
        assert tuple(F.words_le_to_ints(got[:256])) == X.chain_ints(B, k, 256)


PRESET_KS = [(p, k) for p, (_, ks) in FV.PRESETS.items() for k in ks]


@pytest.mark.cuda
@pytest.mark.parametrize("preset,k", PRESET_KS)
def test_field_chain_variant_kernel_matches_plain(preset, k, cuda_device):
    """Every KF2 variant against its plain version and Python ints, at
    every block size it takes, on a ragged batch with edge values; its
    clock64 build computes the same and reports cycles."""
    rng = random.Random(17)
    v = FV.variant_of(preset, k)
    B = 8 * 257
    va = edge_values(F.P) + [rng.randrange(R) for _ in range(B - 14)]
    vb = [rng.randrange(R) for _ in range(B - 14)] + edge_values(F.P)[::-1]
    a = F.ints_to_words_le(va, cuda_device)
    b = F.ints_to_words_le(vb, cuda_device)
    if v.planes:
        a, b = FV.to_planes(a), FV.to_planes(b)
    rinv = pow(1 << 264, -1, F.P)
    for threads in [t for t in FV.THREADS if t <= v.max_threads]:
        for n in (0, 1, 37):
            before = FV.field_chain_variant.launches
            got = FV.field_chain_variant(a, b, n, preset, k, threads)
            torch.cuda.synchronize()
            assert FV.field_chain_variant.launches == before + 1
            assert torch.equal(got, FV.variant_plain(a, b, n, preset, k))
            lanes = FV.from_planes(got) if v.planes else got
            assert F.words_le_to_ints(lanes[:300]) == [
                x * pow(y % F.P * rinv, n, F.P) % F.P
                for x, y in zip(va[:300], vb[:300])]
    clk = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    got = FV.field_chain_variant(a, b, 37, preset, k, clock=clk)
    assert torch.equal(got, FV.variant_plain(a, b, 37, preset, k))
    cycles, ns = clk.tolist()
    assert cycles > 0 and ns > 0
    attrs = FV.kernel_attrs(preset, k)
    assert attrs["regs"] > 0 and attrs["max_threads"] >= v.max_threads


@pytest.mark.cuda
def test_field_chain_variant_launch_error_propagates(cuda_device,
                                                     monkeypatch):
    """A launch the card refuses (more threads a block than the kernel's
    launch bounds) raises; nothing falls back to the plain version."""
    a = F.ints_to_words_le(list(range(1, 2049)), cuda_device)
    wide = tuple(FV.Variant(x.name, x.lazy, x.k, x.planes, x.min, 1024)
                 for x in FV.VARIANTS)
    monkeypatch.setattr(FV, "VARIANTS", wide)
    monkeypatch.setattr(FV, "THREADS", (128, 256, 512, 1024))
    before = FV.field_chain_variant.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        FV.field_chain_variant(a, a, 5, "relaxed", threads=1024)
    assert FV.field_chain_variant.launches == before


# -- KP1 and KF2 on the group multiply (field_group.cuh) ---------------------

def group_lane_counts(device, k=1):
    """1, 31, 16,383 and 16,384 lanes and a card-filling count (SMs x
    2,048, where the plan takes one thread a lane), each rounded down to
    a multiple of K (a preset with K chains a thread takes B % K == 0)."""
    fill = F.sm_count(device) * F.FILL_THREADS_PER_SM * k
    return sorted({max(k, c - c % k) for c in (1, 31, 16383, 16384, fill)})


def chain_operands(lanes, m, seed, device):
    """(B, 8) uint32 operands from numpy's generator, the edge values in
    the first lanes -> (a's first 64 ints, b's, a, b)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (2, lanes, 8), dtype=np.uint64)
    edge = F.ints_to_words_le(edge_values(m)).numpy().astype(np.uint64)
    c = min(lanes, len(edge))
    words[0, :c] = edge[:c]
    words[1, :c] = edge[::-1][:c]
    a, b = (torch.from_numpy(w.astype(np.uint32).view(np.int32)).view(
        torch.uint32).to(device) for w in words)
    return F.words_le_to_ints(a[:64]), F.words_le_to_ints(b[:64]), a, b


@pytest.mark.cuda
@pytest.mark.parametrize("modulus", ["p", "n", "p25519", "bn254"])
def test_kp1_every_tpi_at_edge_lane_counts(modulus, cuda_device):
    """KP1 at the plan's TPI and at each forced TPI (1, 4), both R,
    bit for bit against its plain version (and Python ints on 64 lanes),
    at lane counts that fill no group or block and at a card-filling one:
    both sides of the rule."""
    m = F.MODS[modulus].m
    sms = F.sm_count(cuda_device)
    seen = set()
    for lanes in group_lane_counts(cuda_device):
        va, vb, a, b = chain_operands(lanes, m, lanes, cuda_device)
        seen.add(F.kp1_plan(lanes, cuda_device)[0])
        for r_log2 in F.R_LOG2S:
            rinv = pow(1 << r_log2, -1, m)
            k = 5
            plain = F.mul_chain_plain(a, b, k, modulus, r_log2)
            want = [x * pow(y * rinv, k, m) % m for x, y in zip(va, vb)]
            assert F.words_le_to_ints(plain[:64]) == want
            for tpi in (None, *F.TPIS):
                before = F.field_mul_chain.launches
                got = F.field_mul_chain(a, b, k, modulus, r_log2, tpi=tpi)
                torch.cuda.synchronize()
                assert F.field_mul_chain.launches == before + 1
                assert torch.equal(got, plain), (lanes, r_log2, tpi)
    assert seen == {1, F.GROUP_TPI} and sms > 0


@pytest.mark.cuda
@pytest.mark.parametrize("preset,k", PRESET_KS)
def test_kf2_group_presets_at_edge_lane_counts(preset, k, cuda_device):
    """Every KF2 preset in its own layout at the plan's TPI and at each
    forced TPI, bit for bit against variant_plain, at ragged and
    card-filling lane counts; its clock build on the group computes the
    same."""
    v = FV.variant_of(preset, k)
    seen = set()
    for lanes in group_lane_counts(cuda_device, v.k):
        va, vb, a, b = chain_operands(lanes, F.P, 7 + lanes, cuda_device)
        if v.planes:
            a, b = FV.to_planes(a), FV.to_planes(b)
        n = 9
        plain = FV.variant_plain(a, b, n, preset, k)
        seen.add(FV.variant_plan(preset, k, lanes, cuda_device)[0])
        for tpi in (None, *F.TPIS):
            got = FV.field_chain_variant(a, b, n, preset, k, tpi=tpi)
            torch.cuda.synchronize()
            assert torch.equal(got, plain), (lanes, tpi)
        clk = torch.zeros(2, dtype=torch.int64, device=cuda_device)
        got = FV.field_chain_variant(a, b, n, preset, k, clock=clk,
                                     tpi=F.GROUP_TPI)
        assert torch.equal(got, plain) and clk[0].item() > 0
    assert seen == {1, F.GROUP_TPI}


@pytest.mark.cuda
def test_chain_kernels_build_with_no_frame_or_spills(cuda_device):
    """ptxas' figures from the build log: every KP1 and KF2 instantiation,
    one thread or a group, keeps frame 0 and spills 0."""
    from fabric_tpu_torch.ops import _build
    logs = {name: _build._finish(name, *_build._start(name))
            for name in ("field_chain", "field_chain_variants")}
    frags = [("field_chain", F.kp1_symbol(mod, tpi))
             for mod in F.MODS for tpi in F.TPIS]
    frags += [("field_chain_variants", FV.kernel_symbol(p, kk, clock, tpi))
              for p, kk in PRESET_KS for clock in (False, True)
              for tpi in F.TPIS]
    for lib, frag in frags:
        res = _build.kernel_resources(logs[lib], frag)
        assert res["frame_bytes"] == 0, (frag, res)
        assert res["spill_store_bytes"] == res["spill_load_bytes"] == 0, (
            frag, res)
        assert 0 < res["regs"] <= 255


def probe_tile(probe, B, device, seed=0):
    rng = np.random.default_rng(seed)
    if probe == "f32":
        x = rng.random((IP.L, B)).astype(np.float32)
    elif seed == 0:
        x = rng.integers(0, 4096, (IP.L, B)).astype(np.int32)
    else:
        x = rng.integers(-2**31, 2**31, (IP.L, B), dtype=np.int64).astype(
            np.int32)
        x[0, :4] = [2**31 - 1, 2**31 - 40, 100, -2**31]
    return torch.from_numpy(x).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("probe", IP.PROBES)
def test_isa_probe_kernel_matches_plain(probe, cuda_device):
    """Every KI3 probe bit for bit against its plain version, on a ragged
    batch, at 0, 1 and the script's 4 passes (f32: normal values after
    one, flushed zeros after four)."""
    for seed in ((0,) if probe == "f32" else (0, 1)):
        x = probe_tile(probe, 1000, cuda_device, seed)
        for iters in (0, 1, IP.ITERS):
            before = IP.isa_probe.launches
            got = IP.isa_probe(x, probe, iters)
            torch.cuda.synchronize()
            assert IP.isa_probe.launches == before + 1
            want = IP.probe_plain(x, probe, iters)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert IP.kernel_attrs(probe)["regs"] > 0


@pytest.mark.cuda
def test_isa_probe_launch_error_propagates(cuda_device, monkeypatch):
    x = probe_tile("mul", 256, cuda_device)
    monkeypatch.setitem(IP.PROBE_ID, "mul", 99)      # no such kernel
    before = IP.isa_probe.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        IP.isa_probe(x, "mul")
    assert IP.isa_probe.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("probe", IP.PROBES)
def test_isa_probe_every_layout_matches_plain(probe, cuda_device):
    """Every KI3 probe at the plan's layout and at each of its layouts
    forced (one thread a column, and each spread layout), bit for bit
    against its plain version on ragged B at 0, 1 and 4 passes; the int32
    probes on the script's values, full-range values and odd ones (whose
    row_mul products never reach 0)."""
    for B in (1, 31, 1000):
        for seed in ((0,) if probe == "f32" else (0, 1, 2)):
            # probe_tile puts 4 edge values in row 0: cut a wider tile
            x = probe_tile(probe, max(B, 4), cuda_device,
                           min(seed, 1))[:, :B].contiguous()
            if seed == 2:
                x = x | 1
            for iters in (0, 1, IP.ITERS):
                want = IP.probe_plain(x, probe, iters).view(torch.int32)
                for layout in (None, *IP.PROBE_LAYOUTS[probe]):
                    before = IP.isa_probe.launches
                    got = IP.isa_probe(x, probe, iters, layout)
                    torch.cuda.synchronize()
                    assert IP.isa_probe.launches == before + 1
                    assert torch.equal(got.view(torch.int32), want), (
                        B, seed, iters, layout)
    for layout in IP.PROBE_LAYOUTS[probe]:
        assert IP.kernel_attrs(probe, layout)["regs"] > 0


@pytest.mark.cuda
def test_isa_probe_plan_on_the_card(cuda_device):
    """The reference's 16,384 columns take each probe's spread layout on
    an H100's 132 SMs, SMs x 2,048 columns one thread a column; both
    outputs equal the plain version."""
    sms = F.sm_count(cuda_device)
    for B in (16384, sms * F.FILL_THREADS_PER_SM):
        for probe in ("row_mul", "mul", "where"):
            x = probe_tile(probe, B, cuda_device, 1) | 1
            want = IP.probe_plain(x, probe, 1)
            assert torch.equal(IP.isa_probe(x, probe, 1), want)
            layout = IP.probe_plan(probe, B, sms)[0]
            assert (layout == "column") == (B >= sms * F.FILL_THREADS_PER_SM)


@pytest.mark.cuda
def test_isa_probe_kernels_build_with_no_frame_or_spills(cuda_device):
    """ptxas' figures from the build log: every KI3 instantiation keeps
    frame 0 and spills 0."""
    from fabric_tpu_torch.ops import _build
    log = _build._finish("isa_probe", *_build._start("isa_probe"))
    for probe in IP.PROBES:
        for layout in IP.PROBE_LAYOUTS[probe]:
            res = _build.kernel_resources(log, IP.kernel_symbol(probe,
                                                                layout))
            assert res["frame_bytes"] == 0, (probe, layout, res)
            assert res["spill_store_bytes"] == res["spill_load_bytes"] == 0
            assert 0 < res["regs"] <= 255


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["row_mul", "rotate", "f32"])
def test_launch_ms_gives_one_launchs_output(probe, cuda_device):
    """The per-launch timer (launches captured in a CUDA graph, replayed)
    leaves the output of one launch: a copy captured after each launch
    holds the last replay's, equal to one wrapper call's and the plain
    version's; the wrapper's launch count is left as it was."""
    x = probe_tile(probe, 1000, cuda_device, 0 if probe == "f32" else 1)
    once = IP.isa_probe(x, probe)
    out = torch.full_like(x, 7)
    before = IP.isa_probe.launches
    ms = X.launch_ms(lambda: out.copy_(IP.isa_probe(x, probe)), launches=8,
                     trials=2)
    torch.cuda.synchronize()
    assert ms > 0
    assert IP.isa_probe.launches == before      # timing launches not counted
    assert torch.equal(out.view(torch.int32), once.view(torch.int32))
    assert torch.equal(once.view(torch.int32),
                       IP.probe_plain(x, probe).view(torch.int32))
    roll = torch.full_like(x, 7)
    if probe == "rotate":
        X.launch_ms(lambda: roll.copy_(torch.roll(x, -IP.REP * IP.ITERS, 0)),
                    launches=4, trials=1)
        assert torch.equal(roll, once)


@pytest.mark.cuda
def test_experiments_on_the_card(cuda_device):
    """Two counterparts end to end at a small B: every configuration
    checked, timed, and reported with its clock64 and SASS figures."""
    res = proto_ilp.run(trials=1, B=2048)
    assert res["card"]["sms"] > 0
    for row in res["configs"]:
        assert row["ms"] > 0 and row["sm_cycles_per_mul"] > 0
        assert row["clock_cycles_per_mul_alone"] > 0
        assert row["regs"] > 0
    res = proto_pallas3.run(trials=1, B=2048)
    assert all(r["ms"] > 0 and r["lane_ops_per_s"] > 0
               for r in res["probes"])


# -- the mesh (parallel/mesh.py), entry and trace capture ---------------------

@pytest.mark.cuda
def test_two_shard_mesh_matches_plain_provider_on_mixed_block(cuda_device):
    """The mixed block of test_cuda_provider_mixed_curves_match_sw through
    a 2-shard mesh on cuda:0: verdicts equal the plain provider's and SW's,
    every kernel launches once a shard on its shard's stream, one table
    build a key and one bank replica."""
    from fabric_tpu_torch.parallel import mesh as M
    p_items, _ = hot_key_items(2, 5, seed=12)
    rows = corpus()[:6]
    p_items += [VerifyItem(SCHEME_P256, b"\x04" + qx.to_bytes(32, "big")
                           + qy.to_bytes(32, "big"),
                           crypto.encode_dss_signature(r, s),
                           e.to_bytes(32, "big"))
                for qx, qy, r, s, e, _ in rows]
    e_items, _ = ed_corpus()
    items = p_items + e_items[:13]
    plain = CudaProvider(fast_key_threshold=4)
    mesh = M.make_mesh(["cuda:0"] * 2)
    assert mesh.distinct_devices == (torch.device("cuda", 0),)
    prov = CudaProvider(fast_key_threshold=4, mesh=mesh)
    want = plain.batch_verify(items)
    fns = (p256_fixed.p256_verify_rows, p256.p256_verify,
           E.ed25519_verify_rows, E.ed25519_verify)
    before = [f.launches for f in fns]
    got = prov.batch_verify(items)
    assert [f.launches - b for f, b in zip(fns, before)] == [2, 2, 2, 2]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, SoftwareProvider().batch_verify(items))
    assert prov.stats == plain.stats and prov.stats["fallbacks"] == 0
    assert prov.key_tables.stats == plain.key_tables.stats
    assert len(prov.key_tables.replicas()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3])
def test_sharded_lanes_one_signature_and_empty_shards(n, cuda_device):
    """KP3 sharded over 4 streams of cuda:0 at 1-3 signatures (a shard
    of one, empty shards) equals the unsharded kernel."""
    from fabric_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh(["cuda:0"] * 4)
    items, labels = hot_key_items(2, 2, seed=31)
    prov = CudaProvider(fast_key_threshold=1)
    batch = prov.pass_p256(items[:n], range(n))
    prov.key_tables.unpin(batch.pinned)
    keep, arrays, slot = batch.fast
    table = p256_tables.g_table(cuda_device)
    words = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    bank = prov.key_tables.array()
    want = p256_fixed.p256_verify_rows(*[w.to(cuda_device) for w in words],
                                       torch.from_numpy(slot), bank, table)
    fn = M.sharded_p256_rows_verify(mesh)
    got, count = fn(*words, slot, bank, table)
    assert torch.equal(got, want) and int(count) == int(want.sum())
    assert got.cpu().tolist() == [labels[i] for i in keep]
    # one KP3 launch a non-empty shard, none on an empty one
    assert fn.shard_launches == [int(hi > lo) for lo, hi in
                                 M.shard_bounds(len(keep), 4)]


@pytest.mark.cuda
def test_replicated_bank_rebuild_waits_for_both_shard_streams(cuda_device):
    """Two slots, a 2-shard mesh.  Batch a's KP3 on shard 1's stream
    waits behind a ~0.5 s spin there; batch b, on the current stream,
    evicts and rewrites both slots.  Were the rewrite not ordered after
    the reads of both shard streams, shard 1's KP3 would read b's keys
    and reject a's good signatures."""
    from fabric_tpu_torch.parallel import mesh as M
    a, want_a = hot_key_items(2, 6, seed=7)
    b, want_b = hot_key_items(2, 6, seed=8)
    tables = {it.pubkey: p256_tables.table_for_pubkey(it.pubkey)
              for it in a + b}
    mesh = M.make_mesh(["cuda:0"] * 2)
    # builds and loads the C parser and KP3 before the timed part
    assert CudaProvider(fast_key_threshold=4, mesh=mesh).batch_verify(
        a).tolist() == want_a
    prov = CudaProvider(fast_key_threshold=4, max_cached_keys=2, mesh=mesh)
    prov.key_tables.build_fn = tables.get
    torch.cuda.synchronize()
    with torch.cuda.stream(mesh.streams[1]):
        torch.cuda._sleep(1 << 30)
    res_a = prov.batch_verify_async(a)
    res_b = prov.batch_verify_async(b)
    assert prov.key_tables.stats["evictions"] == 2
    assert res_b().tolist() == want_b
    assert res_a().tolist() == want_a


@pytest.mark.cuda
def test_dryrun_multichip_two_shards_on_the_card(cuda_device, capsys):
    from fabric_tpu_torch import entry
    rec = entry.dryrun_multichip(2)
    assert rec["shards"] == 2
    assert rec["shards_per_device"] == {"cuda:0": 2}
    assert rec["card"] and rec["sharded_sigs_per_sec"] > 0
    fn, args = entry.entry()
    assert bool(fn(*args).all())


@pytest.mark.cuda
def test_capture_device_trace_holds_kernel_events(cuda_device, tmp_path):
    """A trace captured around a block's verify holds the marker and
    KP2's and KE5's kernel events."""
    from fabric_tpu_torch.ops_plane import profiling
    items = [VerifyItem(SCHEME_P256, b"\x04" + qx.to_bytes(32, "big")
                        + qy.to_bytes(32, "big"),
                        crypto.encode_dss_signature(r, s),
                        e.to_bytes(32, "big"))
             for qx, qy, r, s, e, _ in corpus()[:8]] + ed_corpus()[0][:4]
    prov = CudaProvider()
    prov.batch_verify(items)
    done = []
    out = profiling.capture_device_trace(
        0.05, str(tmp_path),
        work=lambda: done.append(prov.batch_verify(items).tolist()))
    assert len(done) == 1
    assert out["device_events"] > 0
    assert any("p256_verify_kernel" in k for k in out["kernels"])
    assert any("ed25519_verify_kernel" in k for k in out["kernels"])
    with open(out["trace"]) as f:
        assert "traceEvents" in json.load(f)


# -- the default peer's commit tail (classic tail, SBE, verify-once cache,
# early abort) on the card ---------------------------------------------------


class _InProcess:
    """chip_smoke's signing jobs run in this process (a pool's map)."""

    @staticmethod
    def map(fn, jobs):
        return [fn(j) for j in jobs]


@pytest.fixture(scope="module")
def stream500():
    """chip_smoke's commit stream at 500 txs (150, 150, 150, 50), its
    labels and the host stack's rows after each block (the deep tail on
    the software provider): (orgs, raws, labels, rows)."""
    import chip_smoke as cs
    init_factories(FactoryOpts(default="SW"))
    orgs, signers, endorsers, clients = cs.commit_identities()
    env_blocks, labels, _ = cs.build_stream(150, 50, signers, endorsers,
                                            clients, _InProcess)
    raws = cs.chain_blocks(env_blocks)
    host, _ = cs.commit_stack(SoftwareProvider(), orgs, False, "cpu")
    rows = [(r.final_flags.codes(), meta, after) for r, meta, _s, after in
            cs.commit_stream(host, raws, rows=True)]
    assert [codes for codes, _m, _r in rows] == labels
    return orgs, raws, labels, rows


def _classic(cs, provider, orgs, device, **kw):
    from fabric_tpu_torch.verify_plane import VerdictCache
    cache = VerdictCache(cs.CACHE_CAPACITY)
    prov = cs._Dispatches(provider)
    c, dv = cs.commit_stack(prov, orgs, False, device, classic=True,
                            cache=cache, **kw)
    return c, cache, prov


@pytest.mark.cuda
def test_classic_tail_on_card_matches_host_stack(cuda_device, stream500):
    """The default peer's stack (classic tail, key policies from the
    ledger's state, the verify-once cache) on the CUDA provider: after
    every block the flags, metadata flags, state, history and commit
    hash of the host stack, flags equal to the labels, KP3 launched."""
    import chip_smoke as cs
    orgs, raws, labels, rows = stream500
    from fabric_tpu_torch.verify_plane.cache import _m
    provider = CudaProvider(device=cuda_device)
    c, cache, prov = _classic(cs, provider, orgs, cuda_device)
    before = p256_fixed.p256_verify_rows.launches
    verified = _m()["device"].value(site="commit")
    got = [(r.final_flags.codes(), meta, after) for r, meta, _s, after in
           cs.commit_stream(c, raws, rows=True)]
    assert got == rows
    assert p256_fixed.p256_verify_rows.launches > before
    assert prov.items == _m()["device"].value(site="commit") - verified > 0
    assert provider.stats["fallbacks"] == 0


@pytest.mark.cuda
def test_speculatively_filled_block_launches_no_kp3_kp2(cuda_device,
                                                         stream500):
    """Block 2 after a speculative fill of its items commits with no item
    dispatched and no KP3/KP2 launch, with the host stack's flags and
    commit hash."""
    import chip_smoke as cs
    orgs, raws, labels, rows = stream500
    provider = CudaProvider(device=cuda_device)
    c, cache, prov = _classic(cs, provider, orgs, cuda_device)
    cs.at_height(c, raws, rows, 2)
    filled = cs.spec_fill(cache, provider, c.validator.msps, raws[2])
    assert filled["dispatched"] > 0 and filled["dropped"] == 0
    counts = (p256_fixed.p256_verify_rows.launches, p256.p256_verify.launches)
    res = cs.commit_stream(c, raws[2:3], rows=True)[0]
    assert (p256_fixed.p256_verify_rows.launches,
            p256.p256_verify.launches) == counts
    assert prov.items == 0
    assert res[0].final_flags.codes() == rows[2][0]
    assert res[3] == rows[2][2]


@pytest.mark.cuda
@pytest.mark.parametrize("tail", ["classic", "kv7"])
def test_early_abort_on_card_dispatches_fewer_items(cuda_device, stream500,
                                                   tail):
    """Blocks 2 and 3 on one tail with early abort and without: fewer
    items dispatched with it; each doomed tx invalid without it and MVCC
    or phantom with it; every other flag, the state and the history
    equal; the commit hash equal unless a doomed tx's code differs."""
    import chip_smoke as cs
    orgs, raws, labels, rows = stream500
    provider = CudaProvider(device=cuda_device)
    runs, seen = {}, []
    for early in (False, True):
        if tail == "classic":
            c, _cache, prov = _classic(cs, provider, orgs, cuda_device,
                                       early_abort=early)
        else:
            prov = cs._Dispatches(provider)
            c, _ = cs.commit_stack(prov, orgs, True, cuda_device,
                                   early_abort=early)
        cs.at_height(c, raws, rows, 2)
        if early:
            real = c.validator.early_abort.doomed
            c.validator.early_abort.doomed = lambda block, overlay=None: (
                seen.append(real(block, overlay=overlay)) or seen[-1])
        out = cs.commit_stream(c, raws[2:], rows=True)
        runs[early] = ([r.final_flags.codes() for r, _m, _s, _a in out],
                       [a for _r, _m, _s, a in out], prov.items)
    (base, base_rows, n_off), (codes, after, n_on) = runs[False], runs[True]
    assert base == [r[0] for r in rows[2:]]
    assert sum(map(len, seen)) > 0 and n_on < n_off
    for blk, doomed in enumerate(seen):
        for t, (got, want) in enumerate(zip(codes[blk], base[blk])):
            if t in doomed:
                assert want != 0 and got in (11, 12)
            else:
                assert got == want
        assert after[blk][:2] == base_rows[blk][:2]
        assert (after[blk][2] == base_rows[blk][2]) == (
            codes[blk] == base[blk])


# ---------------------------------------------------------------------------
# the cross-block commit window and the ACL gate on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kv7", [False, True], ids=["host", "kv7"])
def test_pipelined_stream_on_card_matches_serial(cuda_device, stream500,
                                                 kv7):
    """chip_smoke's stream at 500 txs through PipelinedCommitter on a
    windowed ledger (W=2, early abort on the window's overlay) on the
    CUDA provider: after every block the serial host stack's flags (a
    doomed tx's MVCC or phantom), metadata flags, state, history and
    commit hash; KP3 launched every block; KV7 demoted only as the
    reference does."""
    import chip_smoke as cs
    from fabric_tpu_torch.ops import block_validate
    orgs, raws, labels, rows = stream500
    provider = CudaProvider(device=cuda_device)
    c, dv = cs.commit_stack(provider, orgs, kv7, cuda_device,
                            early_abort=True, commit_window=2)
    doomed = cs.spy_doomed(c)
    counted = {"p256_verify_rows": p256_fixed.p256_verify_rows,
               "p256_verify": p256.p256_verify,
               "block_validate": block_validate.block_validate_kernel}
    out, _secs = cs.pipeline_stream(c, raws, rows=True, counted=counted)
    cs.hold_to_phase6("card", out, rows, doomed)
    assert all(n["p256_verify_rows"] == 1 for *_x, n in out)
    if kv7:
        dem = {k for k, v in
               dv.stats["validator_device_demotions_total"].items() if v}
        assert dem <= set(cs.WINDOW_DEMOTIONS)
        assert dv.stats["validator_device_blocks_total"] == sum(
            n["block_validate"] for *_x, n in out) >= 1
    assert c.ledger._commit_window.stats()["retired"] == len(raws)
    assert provider.stats["fallbacks"] == 0


@pytest.mark.cuda
def test_check_acl_on_card_through_kp3_kp2(cuda_device):
    """ACLProvider on the CUDA provider: a member's proposal allowed, the
    same with a flipped signature byte denied, each decision the
    software provider's, the signature checks launched on the card."""
    from fabric_tpu_torch import config as C
    from fabric_tpu_torch.msp.ca import DevOrg
    from fabric_tpu_torch.policy import ACLError, ACLProvider, SignedData
    org = DevOrg("Org1")
    mc = org.msp_config()
    src = C.BundleSource(C.Bundle(C.ChannelConfig(
        "ch", 0, (C.OrgConfig("Org1", tuple(mc.root_certs_pem),
                              tuple(mc.admin_certs_pem)),),
        C.default_policies(["Org1"]))))
    member = org.new_identity("m")
    sig = member.sign(b"p")
    cases = [SignedData(b"p", member.serialize(), sig),
             SignedData(b"p", member.serialize(),
                        sig[:-1] + bytes([sig[-1] ^ 1]))]

    def decide(acl, sd):
        try:
            acl.check_acl("peer/Propose", sd)
            return True
        except ACLError:
            return False

    provider = CudaProvider(device=cuda_device)
    before = p256_fixed.p256_verify_rows.launches + p256.p256_verify.launches
    got = [decide(ACLProvider(src, provider), sd) for sd in cases]
    launched = (p256_fixed.p256_verify_rows.launches
                + p256.p256_verify.launches - before)
    want = [decide(ACLProvider(src, SoftwareProvider()), sd) for sd in cases]
    assert got == want == [True, False]
    assert launched == 2 and provider.stats["fallbacks"] == 0


# -- the ops plane on the card ------------------------------------------------

def _lane_moves(fn):
    """fn() -> (its result, {(lane, device): (items, slots)} that the
    provider's lane series gained, the device-sigs counter's gain, the
    dispatch queue's depth after)."""
    from fabric_tpu_torch.ops_plane import registry
    slots_c = registry.counter("provider_lane_slots_total")
    pads_c = registry.counter("provider_pad_slots_total")
    sigs_c = registry.counter("provider_device_sigs_total")

    def read():
        return ({tuple(sorted(dict(k).items())): v
                 for k, v in dict(slots_c._values).items()},
                {tuple(sorted(dict(k).items())): v
                 for k, v in dict(pads_c._values).items()},
                sigs_c.total())
    s0, p0, n0 = read()
    out = fn()
    s1, p1, n1 = read()
    moves = {}
    for k, v in s1.items():
        slots = v - s0.get(k, 0.0)
        if slots:
            pads = p1.get(k, 0.0) - p0.get(k, 0.0)
            d = dict(k)
            moves[(d["lane"], d["device"])] = (int(slots - pads), int(slots))
    depth = registry.gauge("provider_dispatch_queue_depth").value()
    return out, moves, n1 - n0, depth


@pytest.mark.cuda
def test_lane_series_on_cuda0_for_kp3_kp2_ke6_ke5(cuda_device):
    """A P-256 batch, then an Ed25519 one, each with a hot key: each of
    the four lanes' launch charges its grid's slots (128 items a block
    for KP3 and KP2, 32 signatures for KE6 and KE5) to cuda:0 under the
    reference's lane names, its items among them; every item counted;
    the queue drained."""
    from fabric_tpu_torch.bccsp.cuda import grid_slots
    from fabric_tpu_torch.device import with_index
    p_items, _ = hot_key_items(2, 5, seed=12)
    p_items += [VerifyItem(SCHEME_P256, b"\x04" + qx.to_bytes(32, "big")
                           + qy.to_bytes(32, "big"),
                           crypto.encode_dss_signature(r, s),
                           e.to_bytes(32, "big"))
                for qx, qy, r, s, e, _ in corpus()[:6]]
    e_items = ed_corpus()[0][:13]
    prov = CudaProvider(fast_key_threshold=4)
    card = str(with_index(cuda_device))
    assert card == "cuda:0"
    for kinds, batch in ((("p256-rows", "p256"), p_items),
                         (("ed25519-rows", "ed25519"), e_items)):
        st0 = dict(prov.stats)
        _, moves, sigs, depth = _lane_moves(
            lambda: prov.batch_verify(batch))
        assert set(moves) == {("rows", card), ("generic", card)}
        for lane, kind in zip(("rows", "generic"), kinds):
            n, slots = moves[(lane, card)]
            assert slots == grid_slots(kind, n, cuda_device) >= n > 0
        assert sum(n for n, _s in moves.values()) == \
            prov.stats["device_sigs"] - st0["device_sigs"]
        assert sigs == len(batch) and depth == 0.0


@pytest.mark.cuda
def test_lane_series_on_cuda0_for_kb8(cuda_device):
    """The idemix lane: KB8's launch charges a 128-check block's slots to
    cuda:0 under the lane name `idemix`, with the checks that reached
    the card as its items."""
    items, _ = idemix_items()
    prov = CudaProvider()
    _, moves, sigs, depth = _lane_moves(lambda: prov.batch_verify(items))
    assert moves == {("idemix", "cuda:0"): (3, 128)}
    assert sigs == len(items) and depth == 0.0


@pytest.mark.cuda
def test_cuda_allocated_bytes_reads_memory_allocated(cuda_device):
    """With CUDA in use the resource collector's device gauge is
    torch.cuda.memory_allocated summed over the devices, and
    provenance() names the card."""
    from fabric_tpu_torch.ops_plane import (MetricsRegistry,
                                            ResourceCollector, provenance)
    keep = torch.ones(1 << 20, device=cuda_device)
    torch.cuda.synchronize()
    reg = MetricsRegistry()
    snap = ResourceCollector({}, registry=reg).collect()
    want = sum(torch.cuda.memory_allocated(d)
               for d in range(torch.cuda.device_count()))
    assert snap["cuda_allocated_bytes"] == float(want) >= keep.nbytes
    assert f"cuda_allocated_bytes {float(want)}" in reg.expose_text()
    prov = provenance()
    assert prov["platform"] == "gpu"
    assert prov["device_kind"] == torch.cuda.get_device_name(0)
    assert prov["n_devices"] == torch.cuda.device_count()


@pytest.mark.cuda
def test_debug_profile_route_captures_a_cuda_trace(cuda_device):
    """POST /debug/profile on the port's ops server returns a
    torch.profiler capture of the card (the marker recorded, device
    events counted); /debug/pprof the host profile."""
    import urllib.request
    from fabric_tpu_torch.ops_plane import OperationsServer
    from fabric_tpu_torch.ops_plane.profiling import register_routes
    srv = OperationsServer("127.0.0.1", 0)
    register_routes(srv, enabled=True)
    srv.start()
    try:
        url = "http://%s:%d" % srv.addr
        req = urllib.request.Request(url + "/debug/profile?seconds=0.2",
                                     method="POST")
        body = json.loads(urllib.request.urlopen(req, timeout=300).read())
        assert body["device"].startswith("cuda")
        assert body["device_events"] > 0
        with open(body["trace"]) as f:
            assert "traceEvents" in json.load(f)
        req = urllib.request.Request(url + "/debug/pprof?seconds=0.2",
                                     method="POST")
        body = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert "cumulative" in body["pstats"]
    finally:
        srv.stop()


# -- the peer's block intake: the secure channel and the degrading wrapper
# on the card -------------------------------------------------------------


@pytest.mark.cuda
def test_secure_handshake_verifies_on_the_cuda_default(cuda_device):
    """A handshake whose default provider is the factory's (the CUDA
    provider, fail-stop): each side's transcript signature is a one-item
    batch on the generic lane, so a connection costs two KP2 launches in
    one process, and no batch left the card."""
    from fabric_tpu_torch.comm.rpc import RpcServer, connect
    from fabric_tpu_torch.msp import CachedMSP
    from fabric_tpu_torch.msp.ca import DevOrg
    prov = init_factories(FactoryOpts(default="CUDA"))
    assert isinstance(prov, CudaProvider)
    try:
        o1, o2 = DevOrg("Org1"), DevOrg("Org2")
        msps = {o.mspid: CachedMSP(o.msp()) for o in (o1, o2)}
        srv = RpcServer("127.0.0.1", 0, o1.new_identity("server"), msps)
        srv.serve("echo", lambda body, ident: {"who": ident.mspid})
        srv.start()
        try:
            before = (p256.p256_verify.launches,
                      p256_fixed.p256_verify_rows.launches)
            conn = connect(srv.addr, o2.new_identity("client"), msps,
                           timeout=30.0)
            try:
                assert conn.channel.peer_identity.mspid == "Org1"
                assert conn.call("echo", {}, timeout=30.0)["who"] == "Org2"
            finally:
                conn.close()
            assert (p256.p256_verify.launches,
                    p256_fixed.p256_verify_rows.launches) == (
                        before[0] + 2, before[1])
        finally:
            srv.stop()
        assert prov.stats["fallbacks"] == 0
    finally:
        init_factories(FactoryOpts(default="SW"))


@pytest.mark.cuda
def test_degrading_wrapper_stays_healthy_on_phase4_block(cuda_device):
    """chip_smoke's phase 4 block (500 txs: 2,000 P-256 items with every
    corruption kind, and the 64 Ed25519 items) through the factory's
    provider asked to degrade, cold and warm: verdicts equal the labels,
    the wrapper never leaves HEALTHY, no breaker transition, its SW
    fallback verified nothing, `fallbacks` 0, and the CUDA provider's
    lanes took every well-formed item."""
    import chip_smoke as cs
    from fabric_tpu_torch.bccsp.degrade import DegradingProvider
    from fabric_tpu_torch.ops_plane import registry
    items, labels, kinds = cs.build_block(500, _InProcess)
    prov = init_factories(FactoryOpts(default="CUDA", degrade=True))
    try:
        assert isinstance(prov, DegradingProvider)
        trans = registry.counter("bccsp_breaker_transitions_total", "")
        t0 = trans.breakdown("to")
        for _run in ("cold", "warm"):
            got = prov.batch_verify(items)
            np.testing.assert_array_equal(got, np.asarray(labels))
            assert not prov.degraded and prov.backend == "cuda"
            assert (prov.fallback_batches, prov.fallback_items) == (0, 0)
        st = prov.primary.stats
        assert st["fallbacks"] == 0
        assert st["device_sigs"] + st["host_rejects"] == 2 * len(items)
        assert trans.breakdown("to") == t0
    finally:
        init_factories(FactoryOpts(default="SW"))


@pytest.mark.cuda
def test_peer_node_on_its_default_provider_commits_a_block(cuda_device,
                                                            tmp_path):
    """The port's PeerNode from a provisioned config with no `bccsp`
    key: the factory's CUDA provider, fail-stop.  Its /healthz reports
    the CUDA backend, not degraded; one block ordered by the port's
    OrdererNode (on SW, so this process's default stays the peer's) is
    delivered and commits VALID, its orderer signature checked by one
    KP2 launch (a one-item batch)."""
    import json as _json
    import time as _time
    import urllib.request
    import chip_smoke as cs
    from fabric_tpu_torch.comm.rpc import connect
    from fabric_tpu_torch.config import BatchConfig
    from fabric_tpu_torch.node.orderer import (OrdererNode,
                                               load_signing_identity)
    from fabric_tpu_torch.node.peer import PeerNode
    from fabric_tpu_torch.node.provision import provision_network

    def load(path):
        with open(path) as f:
            return _json.load(f)

    def ident(c):
        return load_signing_identity(c["mspid"], c["cert_pem"].encode(),
                                     c["key_pem"].encode())
    paths = provision_network(str(tmp_path), n_orderers=1,
                              peer_orgs=("Org1",), peers_per_org=1,
                              batch=BatchConfig(timeout_s=0.5))
    ocfg, cfg = load(paths["orderers"][0]), load(paths["peers"][0])
    assert "bccsp" not in cfg and "bccsp" not in ocfg
    cfg["ops_port"] = cs.free_port()
    client = ident(load(paths["clients"]["Org1"]))
    orderer = OrdererNode(dict(ocfg, bccsp="SW"),
                          data_dir=ocfg["data_dir"]).start()
    node = None
    try:
        node = PeerNode(cfg, data_dir=cfg["data_dir"])
        assert isinstance(node.provider, CudaProvider)
        url = "http://127.0.0.1:%d/healthz" % cfg["ops_port"]
        before = (p256.p256_verify.launches,
                  p256_fixed.p256_verify_rows.launches)
        node.start()
        deadline = _time.monotonic() + 60
        while orderer.support.chain.node.role != "leader":
            assert _time.monotonic() < deadline, "no raft leader"
            _time.sleep(0.05)
        conn = connect(orderer.rpc.addr, client, node.msps, timeout=30.0)
        try:
            out = conn.call("broadcast_batch", {"envelopes": cs.node_seed(
                (client, client), [ident(cfg)], 8)}, timeout=60.0)
        finally:
            conn.close()
        assert out["statuses"] == [200] * 8
        ledger = node.channels["ch"].ledger
        deadline = _time.monotonic() + 120
        while ledger.height < 1:
            assert _time.monotonic() < deadline, "block 0 not committed"
            _time.sleep(0.05)
        flags = ledger.blockstore.get_by_number(0).metadata.items["txflags"]
        assert bytes(flags) == bytes(8)
        with urllib.request.urlopen(url, timeout=30) as r:
            health = _json.loads(r.read())
        assert health["status"] == "OK"
        assert health["bccsp"] == {"name": "cuda", "backend": "cuda",
                                   "degraded": False}
        # the orderer signature (one KP2 item); the block's 8 creators
        # and 8 endorsements ride the generic lane too (below the fast
        # lane's 64), so KP2 ran at least once and KP3 not at all
        assert p256.p256_verify.launches > before[0]
        assert p256_fixed.p256_verify_rows.launches == before[1]
        assert node.provider.stats["fallbacks"] == 0
    finally:
        if node is not None:
            node.stop()
        orderer.stop()
        init_factories(FactoryOpts(default="SW"))


@pytest.mark.cuda
def test_entry_verifier_on_the_cuda_default(cuda_device):
    """The cluster's EntryVerifier on the factory's CUDA provider (the
    orderer's default): a signed Raft entry is accepted with one KP2
    launch, its retransmit answered from the slot cache with none, and
    the entry with a spliced payload rejected as `bad_entry_sig` by the
    card's verdict (one more launch)."""
    from fabric_tpu_torch.msp import CachedMSP
    from fabric_tpu_torch.msp.ca import DevOrg
    from fabric_tpu_torch.orderer.cluster import (EntryVerifier,
                                                  cert_fingerprint)
    from fabric_tpu_torch.orderer.consensus import make_entry_signer
    from fabric_tpu_torch.orderer.raft import Entry
    prov = init_factories(FactoryOpts(default="CUDA"))
    try:
        org = DevOrg("OrdererOrg")
        osn = org.new_identity("osn1")
        ver = EntryVerifier("ch", {"OrdererOrg": CachedMSP(org.msp())},
                            {1: (osn.mspid, cert_fingerprint(osn.cert))})
        proposer, sig = make_entry_signer(osn)(3, 7, b"batch", "normal")
        good = Entry(3, 7, b"batch", "normal", proposer, sig)
        spliced = Entry(3, 8, b"batch+spliced", "normal", proposer, sig)
        n0 = p256.p256_verify.launches + p256_fixed.p256_verify_rows.launches

        def launched():
            return (p256.p256_verify.launches
                    + p256_fixed.p256_verify_rows.launches - n0)
        assert ver.check([good]) == (True, None, [])
        assert launched() == 1
        assert ver.check([good]) == (True, None, [])
        assert launched() == 1
        ok, reason, crimes = ver.check([spliced])
        assert (ok, reason, crimes) == (False, "bad_entry_sig", [])
        assert launched() == 2
        assert prov.stats["fallbacks"] == 0
    finally:
        init_factories(FactoryOpts(default="SW"))


@pytest.mark.cuda
def test_sig_filter_on_cuda_matches_sw(cuda_device):
    """The orderer's SigFilter (StandardChannelProcessor.process) on the
    CUDA provider and on SW over one corpus: good envelopes of an Org1
    P-256 and an Org2 Ed25519 client, each with its creator signature
    forged (one bit of the signature flipped): the same admit/reject,
    case by case, and the CUDA provider launched for each good envelope
    at least."""
    from fabric_tpu_torch.bccsp import SCHEME_ED25519 as ED
    from fabric_tpu_torch.config import (BatchConfig, Bundle, BundleSource,
                                         ChannelConfig, OrgConfig,
                                         default_policies)
    from fabric_tpu_torch.msp.ca import DevOrg
    from fabric_tpu_torch.orderer import (MsgProcessorError,
                                          StandardChannelProcessor)
    from fabric_tpu_torch.protocol import (Envelope, KVWrite, NsRwSet,
                                           TxRwSet, build)
    init_factories(FactoryOpts(default="SW"))
    orgs = (DevOrg("Org1"), DevOrg("Org2", scheme=ED))
    cfg = ChannelConfig(
        channel_id="ch", sequence=0,
        orgs=tuple(OrgConfig(o.mspid, tuple(o.msp_config().root_certs_pem),
                             tuple(o.msp_config().admin_certs_pem))
                   for o in orgs),
        policies=default_policies([o.mspid for o in orgs]),
        batch=BatchConfig())
    source = BundleSource(Bundle(cfg))
    envs, labels = [], []
    for i in range(8):
        who = orgs[i % 2].new_identity(f"client{i}")
        rw = TxRwSet((NsRwSet("cc", writes=(KVWrite(f"k{i}", b"v"),)),))
        env = build.endorser_tx("ch", "cc", "1.0", rw, who, [who])
        if i % 4 >= 2:       # P-256: the DER's last byte (s); Ed25519: R
            sig = bytearray(env.signature)
            sig[-1 if i % 2 == 0 else 5] ^= 1
            env = Envelope(env.payload, bytes(sig))
        envs.append(env)
        labels.append(i % 4 < 2)
    verdicts = {}
    for name, prov in (("sw", SoftwareProvider()),
                       ("cuda", CudaProvider())):
        proc = StandardChannelProcessor(
            "ch", source.current().msps, prov, writers_policy=None,
            absolute_max_bytes=cfg.batch.absolute_max_bytes,
            bundle_source=source)
        n0 = sum(f.launches for f in (p256.p256_verify,
                                      p256_fixed.p256_verify_rows,
                                      E.ed25519_verify,
                                      E.ed25519_verify_rows))
        out = []
        for env in envs:
            try:
                proc.process(env, raw_size=len(env.serialize()))
                out.append(True)
            except MsgProcessorError as exc:
                assert "SigFilter" in str(exc)
                out.append(False)
        verdicts[name] = out
        if name == "cuda":
            n = sum(f.launches for f in (
                p256.p256_verify, p256_fixed.p256_verify_rows,
                E.ed25519_verify, E.ed25519_verify_rows)) - n0
            assert sum(labels) <= n <= len(envs)
            assert prov.stats["fallbacks"] == 0
    assert verdicts["cuda"] == verdicts["sw"] == labels


@pytest.mark.cuda
def test_threaded_busy_matches_the_event_tree(cuda_device):
    """chip_smoke's threaded device-busy reading (the raw kineto events
    after the marker) against the same sum over `prof.events()`, the
    session's event tree, on kernels launched from another thread;
    tolerance 1% + 0.01 ms (the tree holds times in us)."""
    import threading
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fabric_tpu_torch.ops_plane.profiling import MARKER, marker_warmup
    x = torch.ones(1 << 22, device=cuda_device)

    def work():
        for _ in range(200):
            x.mul_(1.0001)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        marker_warmup("busy:" + MARKER)
        t = threading.Thread(target=work)
        t.start()
        t.join(60)
    assert not t.is_alive()
    busy, wall, top = cs._threaded_busy(prof, 1.0)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    end = [e.time_range.end for e in device if e.name == "busy:" + MARKER]
    want = sum(e.time_range.end - e.time_range.start for e in device
               if not e.name.startswith("busy:")
               and e.time_range.start >= end[0]) / 1e3
    assert want > 0 and wall == 1.0 and len(top) >= 1
    assert abs(busy - want) <= 0.01 * want + 0.01


@pytest.mark.cuda
def test_workload_cli_on_its_default_provider(cuda_device, capsys,
                                              monkeypatch):
    """`python -m fabric_tpu_torch.workload --scenario poisson --rate 5
    --duration 2` with no `--bccsp`: the factory's CUDA provider and every
    booted node's, fail-stop.  It returns 0, offers load, and no node's
    provider fell back; the nodes' P-256 checks launched on the card."""
    import fabric_tpu_torch.workload.__main__ as cli
    nodes = []

    def recording(cls):
        class Recorded(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                nodes.append(self)
        return Recorded
    monkeypatch.setattr(cli, "PeerNode", recording(cli.PeerNode))
    monkeypatch.setattr(cli, "OrdererNode", recording(cli.OrdererNode))
    before = (p256.p256_verify.launches, p256_fixed.p256_verify_rows.launches)
    try:
        rc = cli.main(["--scenario", "poisson", "--rate", "5",
                       "--duration", "2"])
        report = json.loads(capsys.readouterr().out)
    finally:
        init_factories(FactoryOpts(default="SW"))
    assert rc == 0
    assert report["totals"]["offered"] > 0
    assert len(nodes) == 2
    for node in nodes:
        assert isinstance(node.provider, CudaProvider)
        assert node.provider.stats["fallbacks"] == 0
    assert (p256.p256_verify.launches - before[0]
            + p256_fixed.p256_verify_rows.launches - before[1]) > 0
