"""The port's P-256 verify (fabric_tpu_torch.ops.p256) against the JAX
package on the CPU: the plain version of KP2 must give bit-identical
verdicts to fabric_tpu.ops.ecp256.verify_words_xla (K2) and to the
round-1 ladder fabric_tpu.ops.p256.verify_words (K2'), on the 21-case
corpus of tests/test_ecp256.py.  Also: the comb-table converter, the
wrapper's checks, and that the port imports neither JAX nor fabric_tpu."""
import ast
import hashlib
import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)

from fabric_tpu.crypto import decode_dss_signature
from fabric_tpu.crypto import ec as cec
from fabric_tpu.crypto import hashes
from fabric_tpu.ops import ecp256 as ec
from fabric_tpu.ops import p256 as ref_p256
from fabric_tpu_torch.ops import p256, p256_tables

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cases():
    """The corpus of tests/test_ecp256.py: 12 signatures (every third with
    a wrong digest) and 9 adversarial cases."""
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
        [x + 1, y, r, s, e, False],             # off-curve Q
        [x, y, p256.N - 1, s, e, False],        # in-range wrong r
        [0, 0, r, s, e, False],                 # Q = (0,0) off-curve
        [x, y, 1, 1, 0, False],                 # degenerate-ish values
    ]
    return out


def np_args(rows):
    qx, qy, r, s, e = list(zip(*rows))[:5]
    return [p256.ints_to_words(list(v)) for v in (qx, qy, r, s, e)]


def torch_args(rows):
    return [torch.from_numpy(a) for a in np_args(rows)]


@pytest.fixture(scope="module")
def g_table():
    return p256_tables.g_table("cpu")


def test_plain_matches_k2_and_k2_prime(cases, g_table):
    want = [bool(c[5]) for c in cases]
    port = p256.verify_words_plain(*torch_args(cases), g_table).tolist()
    assert port == want
    k2 = np.asarray(ec.verify_words_xla(*np_args(cases))).tolist()
    k2p = np.asarray(ref_p256.verify_words(*np_args(cases))).tolist()
    assert port == k2
    assert port == k2p


def test_low_s_flag_parity(cases, g_table):
    x, y, r, s, e, _ = cases[0]
    rows = [[x, y, r, p256.N - s, e], [x, y, r, s, e]]
    for low_s in (True, False):
        port = p256.verify_words_plain(*torch_args(rows), g_table,
                                       require_low_s=low_s).tolist()
        ref = np.asarray(ec.verify_words_xla(
            *np_args(rows), require_low_s=low_s)).tolist()
        assert port == ref == [not low_s, True]


def test_entry_point_cpu_and_default_device(cases, monkeypatch):
    rows = cases[:2]
    out = p256.verify_words(*np_args(rows), device="cpu")
    assert out.dtype == torch.bool and out.tolist() == [True, True]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        p256.verify_words(*np_args(rows))


def test_wrapper_rejects_bad_inputs(g_table):
    w = torch.zeros((8, 3), dtype=torch.uint32)
    with pytest.raises(TypeError):
        p256.p256_verify(w.to(torch.int64), w, w, w, w, g_table)
    with pytest.raises(ValueError):
        p256.p256_verify(w, w[:, :2].contiguous(), w, w, w, g_table)
    with pytest.raises(ValueError):
        p256.p256_verify(w, w, w, w, w, g_table[:100])
    with pytest.raises(ValueError):
        p256.p256_verify(w.T.contiguous().T, w, w, w, w, g_table)


def test_comb_table_from_jax_equals_port_builder(g_table):
    conv = p256_tables.from_jax_comb_table(ec.comb_table_f32())
    assert conv.dtype == torch.uint32 and conv.shape == (8192, 16)
    assert torch.equal(conv, g_table)
    # spot-check rows against Python ints: row j*256 + d is d * 2^(8j) * G
    R = 1 << 256
    for j, d in ((0, 1), (0, 255), (17, 3), (31, 200)):
        pt = ec._aff_mul(d << (8 * j), (ec.GX, ec.GY))
        words = conv[j * 256 + d].to(torch.int64).tolist()
        x = sum(w << (32 * i) for i, w in enumerate(words[:8]))
        y = sum(w << (32 * i) for i, w in enumerate(words[8:]))
        assert (x, y) == (pt[0] * R % ec.P, pt[1] * R % ec.P)
    assert not conv[256 * 5].any()               # digit-0 rows are zero


def _ops(u1, u2):
    c = p256.field_ops_per_verify(u1, u2)
    return (c["p", "mul"], c["p", "sqr"], c["n", "mul"], c["n", "sqr"])


def _plus(ops, pm=0, ps=0):
    return (ops[0] + pm, ops[1] + ps, ops[2], ops[3])


def test_mont_mul_count_model():
    base = _ops(0, 0)
    # u1 = u2 = 0: no comb add, ladder never leaves infinity, no combine;
    # mod p: to_mont Q, the curve check, Q's table (1 dbl + 13 adds), the
    # x check; mod n: to_mont s, s^-1 batched (3 multiplies), u1 and u2
    assert base == (2 + 1 + 4 + 13 * 12 + 4, 2 + 4 + 13 * 4 + 1,
                    1 + 3 + 2, 0)
    # one comb digit is a copy; a second costs one mixed add
    assert _ops(0x0101, 0) == _plus(base, 8, 3)
    # u2 = 1: the last window copies T[1]; u2 = 0x11 adds 4 dbl + 1 add
    assert _ops(0, 1) == base
    assert _ops(0, 0x11) == _plus(base, 4 * 4 + 12, 4 * 4 + 4)
    assert _ops(1, 1) == _plus(base, 12, 4)


@pytest.mark.parametrize("u1,u2", [(0, 0), (0x0101, 0x11), (1, 1),
                                   (p256.N - 1, p256.N - 2)])
def test_imads_per_verify_weighs_each_op(u1, u2):
    """Mod p a multiply needs 64 products and a square 36, with no
    reduction products; mod n the reduction adds 64 + 8 low ones."""
    c = p256.field_ops_per_verify(u1, u2)
    assert {k: v for k, v in p256.IMADS.items() if k[0] in ("p", "n")} \
        == {("p", "mul"): 128, ("p", "sqr"): 72,
            ("n", "mul"): 264, ("n", "sqr"): 208}
    assert p256.imads_per_verify(u1, u2) == (
        128 * c["p", "mul"] + 72 * c["p", "sqr"]
        + 264 * c["n", "mul"] + 208 * c["n", "sqr"])


def test_batched_inversion_chain_per_launch():
    """One Fermat chain s^(n-2) per launch: 255 squares and a multiply
    for each set bit of n - 2 after the first."""
    assert p256.INV_N_CHAIN == {("n", "mul"): bin(p256.N - 2).count("1") - 1,
                                ("n", "sqr"): 255}
    assert p256.imads_per_launch() == (
        264 * p256.INV_N_CHAIN["n", "mul"] + 208 * 255)


_BANNED = ("jax", "jaxlib", "fabric_tpu")


def _banned(mod: str) -> bool:
    root = mod.split(".")[0]
    return root in _BANNED


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "fabric_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _banned(n)]
            assert not bad, f"{path.relative_to(REPO)} imports {bad}"
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(
            ".__init__", "") for p in files[:-1])
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "fabric_tpu_torch.bccsp.cuda" in loaded
    assert not [m for m in loaded if _banned(m)]
