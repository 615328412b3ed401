"""The port's Ed25519 lanes (fabric_tpu_torch.ops.ed25519, edwards,
ed25519_tables: K5 and K6) against the JAX package on the CPU.

The plain versions of KE5 and KE6 must give bit-identical verdicts to
fabric_tpu.ops.ed25519.verify_words and verify_words_rows, run eagerly,
on one adversarial corpus: valid signatures, the mutations of
tests/test_ed25519.py:57-93 (wrong message, flipped R bit, swapped key,
S + L, non-canonical y in A and in R, empty and 5,000-byte messages),
y = 1 with sign 1, identity and small-order A and R, and points with no
x.  An eager JAX call costs seconds whatever the batch, so each lane's
corpus rides one batched call in a module fixture.  Also: the tables
and the decompression against the reference's, the host packing, the
signed digits, the point formulas against Python ints, the wrappers,
the CUDA header's constants and the work count behind the kernels'
bounds.  Bulk corpora are held against the port's SoftwareProvider."""
import hashlib
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import jax.numpy as jnp

from fabric_tpu.ops import bignum as bn
from fabric_tpu.ops import ed25519 as ref_ed
from fabric_tpu.ops import ed25519_tables as ref_tables
from fabric_tpu.ops import edwards as ref_edwards
from fabric_tpu_torch import crypto
from fabric_tpu_torch.bccsp import SCHEME_ED25519, VerifyItem
from fabric_tpu_torch.bccsp.sw import SoftwareProvider
from fabric_tpu_torch.ops import ed25519 as E
from fabric_tpu_torch.ops import ed25519_tables as T
from fabric_tpu_torch.ops import edwards as ed
from fabric_tpu_torch.ops import field as F

P, L = ed.P, ed.L
R256 = 1 << 256
IDENTITY = (0, 1, 1, 0)
B_EXT = (ed.BX, ed.BY, 1, ed.BX * ed.BY % P)


# -- python-int reference points ---------------------------------------------

def mul_int(k, pt):
    acc = IDENTITY
    for bit in bin(k)[2:] if k else "":
        acc = T._ext_add(acc, acc)
        if bit == "1":
            acc = T._ext_add(acc, pt)
    return acc


def affine(pt):
    zi = pow(pt[2], P - 2, P)
    return pt[0] * zi % P, pt[1] * zi % P


def encode(pt) -> bytes:
    x, y = affine(pt)
    return (y | (x & 1) << 255).to_bytes(32, "little")


def enc_y(y: int, sign: int = 0) -> bytes:
    return (y | sign << 255).to_bytes(32, "little")


def small_order_points():
    """Encodings of points of order 2, 4 and 8 (the orders checked
    here): (0, -1), (sqrt(-1), 0) and a published order-8 point."""
    out = {"order2": enc_y(P - 1), "order4": enc_y(0),
           "order8": bytes.fromhex("26e8958fc2b227b045c3f489f2ef98f0"
                                   "d5dfac05d3c63339b13802886d53fc05")}
    for name, enc in out.items():
        order = int(name[5:])
        x, y = T.decompress_int(enc)
        pt = (x, y, 1, x * y % P)
        assert affine(mul_int(order, pt)) == (0, 1)
        assert affine(mul_int(order // 2, pt)) != (0, 1)
    return out


def corpus():
    """-> [(name, pubkey, signature, message, label)].  The labels are
    the cofactorless equation's verdicts: a small-order A passes when
    [k]A is the identity."""
    rng = random.Random(2525)
    keys = [crypto.ed25519_key_from_seed(rng.randbytes(32)) for _ in range(3)]
    pubs = [crypto.ed25519_public_bytes(k) for k in keys]

    def signed(j, msg=None):
        msg = rng.randbytes(rng.randrange(1, 200)) if msg is None else msg
        return pubs[j], crypto.ed25519_sign(keys[j], msg), msg

    def forged(pk, order, holds):
        """R = [S]B, so the signature holds iff [k]A is the identity, i.e.
        iff k = 0 mod A's order: the message is searched for that."""
        s = rng.randrange(L)
        sig = encode(mul_int(s, B_EXT)) + s.to_bytes(32, "little")
        while True:
            msg = rng.randbytes(12)
            k = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(),
                               "little") % L
            if (k % order == 0) == holds:
                return pk, sig, msg

    out = []
    for j in (0, 0, 1, 2):
        out.append(("valid", *signed(j), True))
    pk, sig, msg = signed(0, b"")
    out.append(("empty_msg", pk, sig, msg, True))
    pk, sig, msg = signed(1, rng.randbytes(5000))
    out.append(("long_msg", pk, sig, msg, True))
    pk, sig, msg = signed(1)
    out.append(("flip_msg", pk, sig, msg + b"x", False))
    pk, sig, msg = signed(2)
    out.append(("flip_r_bit", pk, bytes([sig[0] ^ 1]) + sig[1:], msg, False))
    pk, sig, msg = signed(0)
    out.append(("swap_key", pubs[1], sig, msg, False))
    pk, sig, msg = signed(2)
    s_int = int.from_bytes(sig[32:], "little")
    out.append(("s_plus_l", pk, sig[:32] + (s_int + L).to_bytes(32, "little"),
                msg, False))
    out.append(("s_eq_l", pk, sig[:32] + L.to_bytes(32, "little"), msg,
                False))
    out.append(("s_max", pk, sig[:32] + b"\xff" * 32, msg, False))
    pk, sig, msg = signed(0)
    out.append(("a_noncanon_y", enc_y(P + 1), sig, msg, False))
    out.append(("r_noncanon_y", pk, enc_y(P + 1) + sig[32:], msg, False))
    out.append(("a_y1_sign1", enc_y(1, 1), sig, msg, False))
    out.append(("r_y1_sign1", pk, enc_y(1, 1) + sig[32:], msg, False))
    no_x = next(y for y in range(2, 100) if T.decompress_int(enc_y(y)) is None)
    out.append(("a_no_x", enc_y(no_x), sig, msg, False))
    out.append(("r_no_x", pk, enc_y(no_x) + sig[32:], msg, False))
    out.append(("a_identity", *forged(enc_y(1), 1, True), True))
    out.append(("all_identity", enc_y(1), enc_y(1) + bytes(32), b"m", True))
    for name, enc in small_order_points().items():
        for holds in (True, False):
            out.append((f"a_{name}", *forged(enc, int(name[5:]), holds),
                        holds))
        pk, sig, msg = signed(2)
        out.append((f"r_{name}", pk, enc + sig[32:], msg, False))
    out.append(("a_max_y_sign1", b"\xff" * 32, sig, msg, False))
    return out


def triples(rows):
    return [r[1] for r in rows], [r[2] for r in rows], [r[3] for r in rows]


@pytest.fixture(scope="module")
def cases():
    return corpus()


@pytest.fixture(scope="module")
def packed(cases):
    return E.pack_verify_inputs(*triples(cases))


@pytest.fixture(scope="module")
def b_table():
    return T.b_table("cpu")


@pytest.fixture(scope="module")
def generic(cases, packed, b_table):
    """{"port": KE5's plain version, "jax": the reference's eager
    verify_words, "sw": the port's SoftwareProvider} over the whole
    corpus, one call each."""
    port = E.ed25519_verify(*[torch.from_numpy(np.ascontiguousarray(a))
                              for a in packed], b_table)
    ref = ref_ed.verify_words(*[jnp.asarray(a) for a in packed])
    sw = SoftwareProvider().batch_verify(
        [VerifyItem(SCHEME_ED25519, *r[1:4]) for r in cases])
    return {"port": port.numpy(), "jax": np.asarray(ref), "sw": sw}


@pytest.fixture(scope="module")
def rows_lane(cases, packed, b_table):
    """The corpus items whose key decompresses, through KE6's plain
    version and the reference's eager verify_words_rows, over banks of
    the same keys' tables of -A (one row of C = 1 per signature)."""
    keep = [i for i, r in enumerate(cases)
            if T.decompress_int(r[1]) is not None]
    slots = {}
    for i in keep:
        slots.setdefault(cases[i][1], len(slots))
    port_bank = torch.stack([torch.from_numpy(T.table_for_pubkey(pk))
                             for pk in slots])

    def ref_table(pk):
        x, y = ref_tables.decompress_int(pk)
        return ref_tables.comb_table_for_point((-x) % P, y)

    ref_bank = np.stack([ref_table(pk) for pk in slots])
    slot = np.asarray([slots[cases[i][1]] for i in keep], np.int32)
    _, _, ry, r_sign, s, k = (a[..., keep] for a in packed)
    words = [torch.from_numpy(np.ascontiguousarray(a)) for a in (ry, s, k)]
    port = E.ed25519_verify_rows(
        words[0], torch.from_numpy(np.ascontiguousarray(r_sign)), words[1],
        words[2], torch.from_numpy(slot), port_bank, b_table)
    n = len(keep)
    ref = ref_ed.verify_words_rows(
        jnp.asarray(ref_bank), jnp.asarray(slot),
        jnp.asarray(ry.reshape(8, n, 1)), jnp.asarray(r_sign.reshape(n, 1)),
        jnp.asarray(s.reshape(8, n, 1)), jnp.asarray(k.reshape(8, n, 1)))
    return {"keep": keep, "port": port.numpy(),
            "jax": np.asarray(ref).reshape(n), "bank": port_bank,
            "ref_bank": ref_bank, "slots": slots}


# -- the lanes against the reference ------------------------------------------

def test_ke5_plain_equals_reference_bit_for_bit(cases, generic):
    got = generic["port"]
    assert got.dtype == bool and got.shape == (len(cases),)
    np.testing.assert_array_equal(got, generic["jax"])
    assert [(r[0], bool(v)) for r, v in zip(cases, got)] == [
        (r[0], r[4]) for r in cases]


def test_ke6_plain_equals_reference_bit_for_bit(cases, generic, rows_lane):
    keep = rows_lane["keep"]
    assert len(keep) >= 20 and len(rows_lane["slots"]) == 7
    np.testing.assert_array_equal(rows_lane["port"], rows_lane["jax"])
    np.testing.assert_array_equal(rows_lane["port"], generic["port"][keep])


def test_lanes_against_software_provider(cases, generic, monkeypatch):
    """The software provider, on OpenSSL and on the pure-Python engine
    that GPU hosts run, gives the reference's verdicts on the whole
    adversarial corpus: small-order keys included, both are
    cofactorless."""
    np.testing.assert_array_equal(generic["sw"], generic["jax"])
    monkeypatch.setattr(crypto, "HAVE_CRYPTOGRAPHY", False)
    pure = SoftwareProvider().batch_verify(
        [VerifyItem(SCHEME_ED25519, *r[1:4]) for r in cases])
    np.testing.assert_array_equal(pure, generic["jax"])


def test_bulk_corpus_against_software_provider(b_table):
    """48 signatures under 4 keys, a third of them mutated: KE5's and
    KE6's plain versions give the software provider's verdicts."""
    rng = random.Random(8)
    keys = [crypto.ed25519_key_from_seed(rng.randbytes(32)) for _ in range(4)]
    items = []
    for i in range(48):
        key = keys[i % 4]
        msg = rng.randbytes(rng.randrange(0, 300))
        sig = crypto.ed25519_sign(key, msg)
        if i % 3 == 1:
            msg = msg + b"!"
        elif i % 9 == 5:
            sig = sig[:40] + bytes([sig[40] ^ 4]) + sig[41:]
        items.append(VerifyItem(SCHEME_ED25519,
                                crypto.ed25519_public_bytes(key), sig, msg))
    want = SoftwareProvider().batch_verify(items)
    assert 0 < want.sum() < len(items)
    args = E.pack_verify_inputs(*zip(*[it[1:] for it in items]))
    np.testing.assert_array_equal(E.verify_words(*args, device="cpu").numpy(),
                                  want)
    bank = torch.stack([torch.from_numpy(T.table_for_pubkey(
        crypto.ed25519_public_bytes(k))) for k in keys])
    slot = np.arange(48, dtype=np.int32) % 4
    got = E.verify_words_rows(*args[2:], slot, bank, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


# -- tables, decompression and packing against the reference -------------------

def test_decompress_int_equals_reference(cases):
    pks = {r[1] for r in cases} | {r[2][:32] for r in cases}
    for pk in sorted(pks):
        assert T.decompress_int(pk) == ref_tables.decompress_int(pk), pk.hex()
    assert T.decompress_int(b"\x01" * 31) is None


def test_comb_tables_equal_reference(rows_lane, b_table):
    conv = T.from_jax_comb_table(ref_tables.basepoint_table())
    assert conv.dtype == torch.uint32 and conv.shape == (2405, 24)
    assert torch.equal(conv, b_table)
    for j, ref in enumerate(rows_lane["ref_bank"]):
        assert torch.equal(T.from_jax_comb_table(ref),
                           rows_lane["bank"][j])
    # row j*65 + m is niels(m * 2^(7j) * B); row j*65 the identity
    for j, m in ((0, 1), (0, 64), (11, 3), (36, 17)):
        x, y = affine(mul_int(m << (7 * j), B_EXT))
        words = b_table[j * 65 + m].to(torch.int64).tolist()
        vals = [sum(w << (32 * i) for i, w in enumerate(words[8 * c:8 * c + 8]))
                for c in range(3)]
        assert vals == [(y - x) * R256 % P, (y + x) * R256 % P,
                        2 * ed.D * x * y * R256 % P]
    one = [R256 % P, 0, 0, 0, 0, 0, 0, 0]
    assert b_table[5 * 65].tolist() == one + one + [0] * 8


def test_table_for_pubkey_is_minus_a_or_none():
    assert T.table_for_pubkey(enc_y(P + 1)) is None
    assert T.table_for_pubkey(enc_y(1, 1)) is None
    key = crypto.ed25519_key_from_seed(bytes(range(32)))
    pk = crypto.ed25519_public_bytes(key)
    x, y = T.decompress_int(pk)
    tab = T.table_for_pubkey(pk)
    assert tab.shape == (2405, 24) and tab.dtype == np.uint32
    np.testing.assert_array_equal(tab, T.comb_table_for_point((-x) % P, y))
    with pytest.raises(ValueError):
        T.comb_table_for_point(x, (y + 1) % P)
    assert T.TABLE_BYTES == tab.nbytes == 230_880


def test_pack_verify_inputs_equals_reference(cases, packed):
    ref = ref_ed.pack_verify_inputs(*triples(cases))
    assert len(packed) == len(ref) == 6
    for got, want in zip(packed, ref):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    empty = E.pack_verify_inputs([], [], [])
    assert [a.shape for a in empty] == [(8, 0), (0,), (8, 0), (0,), (8, 0),
                                        (8, 0)]
    with pytest.raises(ValueError):
        E.pack_verify_inputs([b"\x00" * 31], [b"\x00" * 64], [b""])


# -- the plain point code against Python ints and the reference ---------------

def _limbs(vals):
    return F.ints_to_limbs(vals)


def _to_mont(vals):
    return F.f25519.to_mont(_limbs(vals))


def _affine_of(pt):
    """Plain (X, Y, Z, T) Montgomery limbs -> list of affine (x, y)."""
    X, Y, Z, _ = (F.limbs_to_ints(F.f25519.from_mont(c)) for c in pt)
    return [affine((x, y, z, 0)) for x, y, z in zip(X, Y, Z)]


def _points(n, seed):
    rng = random.Random(seed)
    return [mul_int(rng.randrange(1, L), B_EXT) for _ in range(n)] + [
        IDENTITY, B_EXT]


def _plain(pts):
    return tuple(_to_mont([pt[c] for pt in pts]) for c in range(4))


def test_point_formulas_match_ints():
    ps, qs = _points(6, 1), _points(6, 2)[::-1]
    got = _affine_of(ed.add(_plain(ps), _plain(qs)))
    assert got == [affine(T._ext_add(p, q)) for p, q in zip(ps, qs)]
    assert _affine_of(ed.dbl(_plain(ps))) == [affine(T._ext_dbl(p))
                                              for p in ps]
    assert _affine_of(ed.add(_plain(ps), _plain(ps))) == \
        _affine_of(ed.dbl(_plain(ps)))
    assert _affine_of(ed.neg(_plain(ps))) == [((-x) % P, y) for x, y in
                                               map(affine, ps)]
    # a niels entry of q, and its negation by the digit's sign
    aff = [affine(q) for q in qs]
    e = [_to_mont([(y - x) % P for x, y in aff]),
         _to_mont([(y + x) % P for x, y in aff]),
         _to_mont([2 * ed.D * x * y % P for x, y in aff])]
    got = _affine_of(ed.add_niels(_plain(ps), *e))
    assert got == [affine(T._ext_add(p, q)) for p, q in zip(ps, qs)]


def test_signed_digits_match_reference():
    rng = random.Random(4)
    vals = [0, 1, 63, 64, 127, 128, L - 1, (1 << 253) - 1, R256 - 1] + [
        rng.randrange(L) for _ in range(8)]
    got = torch.stack(ed.comb_digits_signed(_limbs(vals))).numpy()
    want = np.asarray(ref_edwards.comb_digits_signed(
        jnp.asarray(bn.ints_to_limbs(vals))))
    np.testing.assert_array_equal(got, want)
    assert (np.abs(got) <= 64).all()
    for v, col in zip(vals[:8], got.T):
        assert sum(int(d) << (7 * j) for j, d in enumerate(col)) == v
    lad = torch.stack(ed.ladder_digits(_limbs(vals))).numpy()
    np.testing.assert_array_equal(lad, np.asarray(ref_edwards.ladder_digits(
        jnp.asarray(bn.ints_to_limbs(vals)))))


def test_comb_and_ladder_match_ints(b_table):
    rng = random.Random(6)
    us = [0, 1, L - 1, 64, (1 << 252) + 63] + [rng.randrange(L)
                                                for _ in range(3)]
    want = [affine(mul_int(u, B_EXT)) for u in us]
    assert _affine_of(ed.comb_accumulate(b_table, _limbs(us))) == want
    q = _plain([B_EXT] * len(us))
    assert _affine_of(ed.windowed_mul(_limbs(us), q)) == want


def test_decompress_plain_matches_ints(cases):
    encs = sorted({r[1] for r in cases} | {r[2][:32] for r in cases})
    vals = [int.from_bytes(e, "little") for e in encs]
    (x, y), ok = ed.decompress(_limbs([v & ((1 << 255) - 1) for v in vals]),
                               torch.tensor([v >> 255 for v in vals]))
    xs = F.limbs_to_ints(F.f25519.from_mont(x))
    ys = F.limbs_to_ints(F.f25519.from_mont(y))
    for e, k, xv, yv in zip(encs, ok.tolist(), xs, ys):
        want = T.decompress_int(e)
        assert k == (want is not None), e.hex()
        if k:
            assert (xv, yv) == want


def test_chains_and_zinv():
    z = [0, 1, 2, P - 1, 12345678987654321]
    assert ed.chain_ops(ed.inv_chain) == {"mul": 11, "sqr": 254}
    assert ed.chain_ops(ed.pow22523_chain) == {"mul": 11, "sqr": 251}
    got = F.limbs_to_ints(F.f25519.from_mont(ed.zinv(_to_mont(z))))
    assert got == [pow(v, P - 2, P) for v in z]        # zinv(0) = 0
    pw = F.limbs_to_ints(F.f25519.from_mont(ed.pow22523_chain(
        F.f25519.mul, F.f25519.sqr, _to_mont(z))))
    assert pw == [pow(v, (P - 5) // 8, P) for v in z]


# -- wrappers, entry points, constants, work counts ---------------------------

def test_wrappers_reject_bad_inputs(b_table):
    w = torch.zeros((8, 3), dtype=torch.uint32)
    sg = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        E.ed25519_verify(w, sg.to(torch.int64), w, sg, w, w, b_table)
    with pytest.raises(ValueError):
        E.ed25519_verify(w, sg, w[:, :2].contiguous(), sg, w, w, b_table)
    with pytest.raises(ValueError):
        E.ed25519_verify(w, sg, w, sg, w, w, b_table[:100])
    bank = torch.zeros((2, 2405, 24), dtype=torch.uint32)
    with pytest.raises(ValueError, match="slot"):
        E.ed25519_verify_rows(w, sg, w, w, sg + 2, bank, b_table)
    with pytest.raises(ValueError):
        E.ed25519_verify_rows(w, sg, w, w, sg, bank[:, :10], b_table)
    out = E.ed25519_verify(w[:, :0], sg[:0], w[:, :0], sg[:0], w[:, :0],
                           w[:, :0], b_table)
    assert out.shape == (0,) and out.dtype == torch.bool


def test_entry_points_default_to_cuda(packed, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        E.verify_words(*packed)
    with pytest.raises(RuntimeError, match="CUDA"):
        E.verify_words_rows(*packed[2:], np.zeros(packed[0].shape[1]),
                            torch.zeros((1, 2405, 24), dtype=torch.uint32))


def test_cuda_header_constants():
    src = (Path(E.__file__).parent / "csrc" / "edwards_point.cuh").read_text()
    arrays = {}
    for name, body in re.findall(
            r"static __constant__ uint32_t (\w+)\[8\] = \{([^}]*)\}", src):
        words = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        arrays[name] = sum(w << (32 * i) for i, w in enumerate(words))
    assert arrays == {"C_ED_L": L, "C_ED_D_MONT": ed.D * R256 % P,
                      "C_ED_D2_MONT": 2 * ed.D * R256 % P,
                      "C_ED_SQRTM1_MONT": ed.SQRT_M1 * R256 % P}
    assert (ed.L, ed.D, ed.SQRT_M1, ed.BX, ed.BY) == (
        ref_edwards.L, ref_edwards.D, ref_edwards.SQRT_M1, ref_edwards.BX,
        ref_edwards.BY)


def _ops(c):
    return c["p25519", "mul"], c["p25519", "sqr"]


def test_work_count_model():
    assert F.IMADS["p25519", "mul"] == 146 and F.IMADS["p25519", "sqr"] == 90
    # s = k = 0: no comb add, the ladder never starts; decompression
    # (9 + 11 multiplies, 4 + 251 squares), T of -A, Q's table (1 dbl +
    # 13 adds), the combine, batched Z^-1 (3) and the compare (4)
    base = _ops(E.field_ops_per_verify(0, 0))
    assert base == (9 + 11 + 1 + 4 + 13 * 9 + 9 + 3 + 4, 4 + 251 + 4)
    assert _ops(E.field_ops_per_verify(0, 0, root_neg=True)) == (
        base[0] + 1, base[1])
    # one comb digit costs one niels add; s = 64 is the digits -64, 1
    assert _ops(E.field_ops_per_verify(1, 0)) == (base[0] + 7, base[1])
    assert _ops(E.field_ops_per_verify(64, 0)) == (base[0] + 14, base[1])
    # k = 0x11: the first digit is a copy, then 4 dbl and one add
    assert _ops(E.field_ops_per_verify(0, 0x11)) == (
        base[0] + 4 * 4 + 9, base[1] + 4 * 4)
    rows = _ops(E.field_ops_per_verify_rows(1, 1))
    assert rows == (2 * 7 + 9 + 3 + 4, 0)
    s, k = L - 1, L - 2
    assert E.imads_per_verify(s, k) == sum(
        F.IMADS[key] * c for key, c in E.field_ops_per_verify(s, k).items())
    assert E.imads_per_verify_rows(s, k) == 146 * _ops(
        E.field_ops_per_verify_rows(s, k))[0]
    assert E.imads_per_launch() == 146 * 11 + 90 * 254
