"""The port's C DER parser (fabric_tpu_torch.native.parse_der_sigs)
against the port's pure-Python parse (bccsp/cuda.py:parse_p256:
crypto.decode_dss_signature plus the range gate 0 < r, s < 2^256) and
against the reference's C parser
(fabric_tpu.native.load("_fastcollect").parse_der_sigs), on a seeded
corpus of well-formed signatures and every malformation the strict-DER
rules reject."""
import random

import numpy as np
import pytest

from fabric_tpu import native as ref_native
from fabric_tpu_torch import crypto, native
from fabric_tpu_torch.bccsp import SCHEME_P256, VerifyItem
from fabric_tpu_torch.bccsp import cuda as cudaprov

R_MAX = 1 << 256
PUBKEY = crypto.p256_public_bytes(crypto.p256_key_from_scalar(3))


def der_int(body: bytes) -> bytes:
    return b"\x02" + bytes([len(body)]) + body


def seq(body: bytes) -> bytes:
    return b"\x30" + bytes([len(body)]) + body


def be(v: int, n: int) -> bytes:
    return v.to_bytes(n, "big")


def corpus():
    """-> list of (name, signature bytes)."""
    rng = random.Random(20)
    out = []
    # well-formed: values of every byte length, with and without the 0 pad
    for k in range(80):
        bits_r, bits_s = rng.randrange(1, 257), rng.randrange(1, 257)
        r = rng.getrandbits(bits_r) | 1 << (bits_r - 1)
        s = rng.getrandbits(bits_s) | 1 << (bits_s - 1)
        out.append((f"valid{k}", crypto.encode_dss_signature(r, s)))
    for r, s in ((1, 1), (R_MAX - 1, 1), (1, R_MAX - 1), (0x80, 0x7F),
                 (R_MAX - 1, R_MAX - 1), (1 << 255, 0xFF)):
        out.append((f"edge{r.bit_length()}_{s.bit_length()}",
                    crypto.encode_dss_signature(r, s)))
    key = crypto.p256_key_from_scalar(12345)
    for k in range(4):
        r, s = crypto.p256_sign_digest(key, bytes([k]) * 32)
        out.append((f"signed{k}", crypto.encode_dss_signature(r, s)))

    good_r = der_int(b"\x01\x23")
    good_s = der_int(b"\x45")
    r32 = bytes([0x11] * 32)
    bad = {
        "long_form_seq": b"\x30\x81\x07" + good_r + good_s,
        "long_form_seq_big": (b"\x30\x81\x80" + good_r + good_s
                              + b"\x00" * (0x80 - 7)),
        "long_form_int": seq(b"\x02\x81\x20" + r32 + good_s),
        "indefinite_seq": b"\x30\x80" + good_r + good_s + b"\x00\x00",
        "non_minimal_int": seq(der_int(b"\x00\x05") + good_s),
        "non_minimal_33": seq(der_int(b"\x00" + r32) + good_s),
        "non_minimal_s": seq(good_r + der_int(b"\x00\x00\x45")),
        "negative_r": seq(der_int(b"\x85") + good_s),
        "negative_s": seq(good_r + der_int(b"\xff\x01")),
        "int_33_no_pad": seq(der_int(b"\x01" + r32) + good_s),
        "int_34": seq(der_int(b"\x00\x80" + r32) + good_s),
        "r_zero": seq(der_int(b"\x00") + good_s),
        "s_zero": seq(good_r + der_int(b"\x00")),
        "zero_len_int": seq(b"\x02\x00" + good_s),
        "trailing_after_seq": seq(good_r + good_s) + b"\x00",
        "trailing_inside_seq": seq(good_r + good_s + b"\x00"),
        "three_ints": seq(good_r + good_s + der_int(b"\x01")),
        "one_int": seq(der_int(bytes(range(1, 8)))),
        "short_seq": b"\x30\x05\x02\x01\x01\x02\x01",
        "short_seq_2": b"\x30\x00",
        "empty": b"",
        "one_byte": b"\x30",
        "wrong_outer_tag": b"\x31" + seq(good_r + good_s)[1:],
        "wrong_inner_tag": seq(b"\x03" + good_r[1:] + good_s),
        "truncated": crypto.encode_dss_signature(R_MAX - 1, 7)[:-1],
        "seq_len_too_long": b"\x30\x09" + good_r + good_s,
        "seq_len_too_short": b"\x30\x06" + good_r + good_s,
        "int_len_past_end": seq(good_r + b"\x02\x05\x45"),
    }
    out += sorted(bad.items())
    return out


def py_parse(sig):
    """The port's pure-Python parse of one item -> (ok, r, s)."""
    item = VerifyItem(SCHEME_P256, PUBKEY, sig, bytes(32))
    recs, _ = cudaprov.parse_p256([item], [0])
    if not recs:
        return False, 0, 0
    return (True, int.from_bytes(recs[0][2], "big"),
            int.from_bytes(recs[0][3], "big"))


def ref_parse(sigs):
    ok, rs = ref_native.load("_fastcollect").parse_der_sigs(sigs)
    return (np.frombuffer(ok, np.uint8).astype(bool),
            np.frombuffer(rs, np.uint8).reshape(len(sigs), 64))


def test_c_parser_matches_python_and_reference_parsers():
    entries = corpus()
    sigs = [s for _, s in entries]
    ok, rs = native.parse_der_sigs(sigs)
    assert ok.dtype == bool and ok.shape == (len(sigs),)
    assert rs.dtype == np.uint8 and rs.shape == (len(sigs), 64)
    ref_ok, ref_rs = ref_parse(sigs)
    for j, (name, sig) in enumerate(entries):
        want, r, s = py_parse(sig)
        assert ok[j] == want, name
        assert ref_ok[j] == want, name
        if want:
            assert rs[j].tobytes() == be(r, 32) + be(s, 32), name
            assert rs[j].tobytes() == ref_rs[j].tobytes(), name
        else:
            assert not rs[j].any(), name
    assert ok[:90].all()                      # every valid entry accepted
    assert not ok[90:].any()                  # every malformation rejected


def test_c_parser_seeded_mutations():
    """Random byte flips, cuts and insertions around valid signatures:
    all three parsers agree on every one."""
    rng = random.Random(21)
    sigs = []
    for _ in range(600):
        r = rng.getrandbits(rng.choice((8, 200, 255, 256))) or 1
        s = rng.getrandbits(rng.choice((8, 200, 255, 256))) or 1
        sig = bytearray(crypto.encode_dss_signature(r, s))
        op = rng.randrange(4)
        if op == 0:
            sig[rng.randrange(len(sig))] ^= 1 << rng.randrange(8)
        elif op == 1:
            del sig[rng.randrange(len(sig)):]
        elif op == 2:
            sig.insert(rng.randrange(len(sig) + 1), rng.randrange(256))
        sigs.append(bytes(sig))
    ok, rs = native.parse_der_sigs(sigs)
    ref_ok, ref_rs = ref_parse(sigs)
    np.testing.assert_array_equal(ok, ref_ok)
    np.testing.assert_array_equal(rs[ok], ref_rs[ok])
    for j, sig in enumerate(sigs):
        want, r, s = py_parse(sig)
        assert ok[j] == want
        if want:
            assert rs[j].tobytes() == be(r, 32) + be(s, 32)
    assert 100 < ok.sum() < 550               # both outcomes well covered


def test_non_bytes_entries_are_rejected():
    good = crypto.encode_dss_signature(5, 7)
    sigs = [good, bytearray(good), memoryview(good), good.hex(), None, 7,
            [good], good]
    ok, rs = native.parse_der_sigs(sigs)
    assert ok.tolist() == [True] + [False] * 6 + [True]
    ref_ok, _ = ref_parse(sigs)
    np.testing.assert_array_equal(ok, ref_ok)
    assert not rs[1:7].any()
    assert rs[7].tobytes() == be(5, 32) + be(7, 32)


def test_empty_batch():
    ok, rs = native.parse_der_sigs([])
    assert ok.shape == (0,) and ok.dtype == bool
    assert rs.shape == (0, 64) and rs.dtype == np.uint8


def test_offsets_are_checked():
    lib = native.load("der")
    buf = np.zeros(8, np.uint8)
    ok = np.zeros(2, np.uint8)
    rs = np.zeros((2, 64), np.uint8)
    for offs in ([0, 5, 3], [1, 4, 8]):
        offs = np.asarray(offs, np.int64)
        assert lib.parse_der_sigs(buf.ctypes.data, offs.ctypes.data, 2,
                                  ok.ctypes.data, rs.ctypes.data) == -1


def test_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "find_cc", lambda: "/bin/false")
    with pytest.raises(RuntimeError, match="cc failed"):
        native.build("der")
    assert not list(tmp_path.iterdir())
    monkeypatch.undo()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        native.find_cc()
