"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU and nvcc and skips without
one.  This file imports neither JAX nor fabric_tpu, so it runs on GPU
hosts that have neither:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import hashlib
import random

import numpy as np
import pytest
import torch

from fabric_tpu_torch import crypto
from fabric_tpu_torch.bccsp import (FactoryOpts, SCHEME_ED25519,
                                    SCHEME_P256, VerifyItem, init_factories)
from fabric_tpu_torch.bccsp.cuda import CudaProvider
from fabric_tpu_torch.bccsp.sw import SoftwareProvider
from fabric_tpu_torch.ops import field as F
from fabric_tpu_torch.ops import ed25519 as E
from fabric_tpu_torch.ops import ed25519_tables as T
from fabric_tpu_torch.ops import p256, p256_fixed, p256_tables

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
@pytest.mark.parametrize("modulus", ["p", "n", "p25519"])
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
