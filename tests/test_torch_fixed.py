"""The port's fixed-key lane (fabric_tpu_torch.ops.p256_fixed, K3)
against the JAX package on the CPU: the plain version of KP3 must give
bit-identical verdicts to fabric_tpu.ops.p256_fixed.verify_words_rows
and to the port's generic lane (verify_words_plain) on the on-curve
cases of the tests/test_ecp256.py corpus, over three keys with uneven
groups.  Also: the low-S flag, the wrapper's checks, the entry point and
the work count behind KP3's bound."""
import hashlib
import random

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)

from fabric_tpu.crypto import decode_dss_signature
from fabric_tpu.crypto import ec as cec
from fabric_tpu.crypto import hashes
from fabric_tpu.ops import p256_fixed as ref_fixed
from fabric_tpu.ops import p256_tables as ref_tables
from fabric_tpu_torch.ops import p256, p256_fixed, p256_tables


@pytest.fixture(scope="module")
def cases():
    """The on-curve cases of tests/test_ecp256.py's corpus: 12 signatures
    under 3 keys (every third with a wrong digest) and 7 adversarial
    cases under the first key, so the groups are 11, 4 and 4."""
    rng = random.Random(77)
    keys = [cec.generate_private_key(cec.SECP256R1()) for _ in range(3)]
    out = []
    for i in range(12):
        key = keys[i % 3]
        pub = key.public_key().public_numbers()
        msg = rng.randbytes(40)
        digest = int.from_bytes(hashlib.sha256(msg).digest(), "big")
        r, s = decode_dss_signature(key.sign(msg, cec.ECDSA(hashes.SHA256())))
        if s > p256.HALF_N:
            s = p256.N - s
        good = i % 3 != 2
        if not good:
            digest = (digest + 1) % (1 << 256)
        out.append([pub.x, pub.y, r, s, digest, good])
    x, y, r, s, e = out[0][:5]
    out += [
        [x, y, 0, s, e, False],                 # r = 0
        [x, y, r, 0, e, False],                 # s = 0
        [x, y, p256.N, s, e, False],            # r = n
        [x, y, r, p256.N, e, False],            # s = n
        [x, y, r, p256.N - s, e, False],        # high-S rejected
        [x, y, p256.N - 1, s, e, False],        # in-range wrong r
        [x, y, 1, 1, 0, False],                 # degenerate-ish values
    ]
    random.Random(5).shuffle(out)               # not key-major
    return out


@pytest.fixture(scope="module")
def keys(cases):
    out = {}
    for c in cases:
        out.setdefault((c[0], c[1]), len(out))
    return out


@pytest.fixture(scope="module")
def bank(keys):
    return torch.stack([torch.from_numpy(p256_tables.comb_table_for_point(*k))
                        for k in keys])


@pytest.fixture(scope="module")
def g_table():
    return p256_tables.g_table("cpu")


def words(rows, cols):
    return [torch.from_numpy(p256.ints_to_words([row[c] for row in rows]))
            for c in cols]


def slots(rows, keys):
    return torch.tensor([keys[row[0], row[1]] for row in rows],
                        dtype=torch.int32)


def jax_rows(rows, keys, C=4):
    """fabric_tpu.ops.p256_fixed.verify_words_rows over a key-major
    (R, C) grid padded with repeated signatures, as the reference's
    provider packs it (tests/test_ecp256.py:211-245)."""
    ref_bank = np.stack([ref_tables.comb_table_for_point(*k)
                         for k in keys]).astype(np.float32)
    groups = {}
    for i, row in enumerate(rows):
        groups.setdefault(keys[row[0], row[1]], []).append(i)
    row_key, flat, where = [], [], []
    for slot, g in groups.items():
        n_rows = -(-len(g) // C)
        flat += g + [g[0]] * (n_rows * C - len(g))
        where += g + [-1] * (n_rows * C - len(g))
        row_key += [slot] * n_rows
    R = len(row_key)
    r, s, e = [np.asarray(p256.ints_to_words([rows[i][c] for i in flat]))
               .reshape(8, R, C) for c in (2, 3, 4)]
    out = np.asarray(ref_fixed.verify_words_rows(
        ref_bank, np.asarray(row_key, np.int32), r, s, e)).reshape(-1)
    got = [None] * len(rows)
    for pos, i in enumerate(where):
        if i >= 0:
            got[i] = bool(out[pos])
    return got


def test_rows_plain_matches_jax_rows_and_generic_plain(cases, keys, bank,
                                                       g_table):
    want = [bool(c[5]) for c in cases]
    port = p256_fixed.verify_words_rows_plain(
        *words(cases, (2, 3, 4)), slots(cases, keys), bank, g_table).tolist()
    assert port == want
    assert port == jax_rows(cases, keys)
    generic = p256.verify_words_plain(*words(cases, range(5)), g_table)
    assert port == generic.tolist()


def test_low_s_flag_both_ways(cases, keys, bank, g_table):
    good = next(c for c in cases if c[5])
    x, y, r, s, e, _ = good
    rows = [[x, y, r, p256.N - s, e], [x, y, r, s, e]]
    for low_s, want in ((True, [False, True]), (False, [True, True])):
        got = p256_fixed.p256_verify_rows(
            *words(rows, (2, 3, 4)), slots(rows, keys), bank, g_table,
            require_low_s=low_s)
        assert got.dtype == torch.bool and got.tolist() == want


def test_entry_point_cpu_and_default_device(cases, keys, bank, monkeypatch):
    rows = [c for c in cases if c[5]][:2]
    np_words = [p256.ints_to_words([row[c] for row in rows])
                for c in (2, 3, 4)]
    slot = np.asarray([keys[row[0], row[1]] for row in rows], np.int32)
    out = p256_fixed.verify_words_rows(*np_words, slot, bank.numpy(),
                                       device="cpu")
    assert out.dtype == torch.bool and out.tolist() == [True, True]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        p256_fixed.verify_words_rows(*np_words, slot, bank)


def test_wrapper_rejects_bad_inputs(bank, g_table):
    w = torch.zeros((8, 3), dtype=torch.uint32)
    slot = torch.zeros(3, dtype=torch.int32)
    call = p256_fixed.p256_verify_rows
    with pytest.raises(TypeError):
        call(w.to(torch.int64), w, w, slot, bank, g_table)
    with pytest.raises(ValueError):
        call(w, w[:, :2].contiguous(), w, slot, bank, g_table)
    with pytest.raises(ValueError):
        call(w, w, w, slot, bank[:, :100], g_table)
    with pytest.raises(ValueError):
        call(w, w, w, slot, bank[0], g_table)
    with pytest.raises(ValueError):
        call(w, w, w, slot, bank, g_table[:100])
    with pytest.raises(TypeError):
        call(w, w, w, slot.to(torch.int64), bank, g_table)
    with pytest.raises(ValueError):
        call(w, w, w, slot[:2], bank, g_table)
    with pytest.raises(ValueError):
        call(w, w, w, slot.to("meta"), bank, g_table)
    for bad in (-1, bank.shape[0]):
        with pytest.raises(ValueError, match="slot out of range"):
            call(w, w, w, torch.full((3,), bad, dtype=torch.int32), bank,
                 g_table)


def _ops(u1, u2):
    c = p256_fixed.field_ops_per_verify_rows(u1, u2)
    return (c["p", "mul"], c["p", "sqr"], c["n", "mul"], c["n", "sqr"])


def test_work_count_model():
    base = _ops(0, 0)
    # u1 = u2 = 0: both combs stay at infinity, no combine; mod p only
    # the x check; mod n: to_mont s, s^-1 batched (3 multiplies), u1, u2
    assert base == (4, 1, 1 + 3 + 2, 0)
    # one digit per comb is a copy; the combine is a full add
    assert _ops(1, 0) == base
    assert _ops(1, 1) == (4 + 12, 1 + 4) + base[2:]
    # each further digit costs one mixed add (8 multiplies, 3 squares)
    assert _ops(0x0101, 0) == (4 + 8, 1 + 3) + base[2:]
    assert _ops(0x0101, 0x010101) == (4 + 3 * 8 + 12, 1 + 3 * 3 + 4) \
        + base[2:]
    assert p256_fixed.imads_per_verify_rows(0, 0) == (
        128 * 4 + 72 + 264 * base[2])


def test_rows_lane_needs_under_half_the_generic_work():
    """Random scalars: KP3's least work is about 0.21 of KP2's."""
    rng = random.Random(8)
    rows = gen = 0
    for _ in range(300):
        u1, u2 = rng.randrange(p256.N), rng.randrange(p256.N)
        rows += p256_fixed.imads_per_verify_rows(u1, u2)
        gen += p256.imads_per_verify(u1, u2)
    assert 0.19 < rows / gen < 0.24
