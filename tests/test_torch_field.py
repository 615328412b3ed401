"""The port's field layer (fabric_tpu_torch.ops.field) against Python ints
and against the reference's FlatMod, on the adversarial values of
tests/test_ecp256.py, mod P-256's p and n, mod p25519 and mod BN254's p,
plus the KP1
plain version, the limb codecs and the constants the CUDA header
hard-codes."""
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)

from fabric_tpu.ops import bignum as bn
from fabric_tpu.ops import bn254_batch as bb
from fabric_tpu.ops import ecp256 as ec
from fabric_tpu.ops import edwards as ed
from fabric_tpu.ops import flatfield as ff
from fabric_tpu_torch.ops import field as F

R = 1 << 256
MODS = [("p", F.P, F.fp, ec.fp), ("n", F.N, F.fn, ec.fn),
        ("p25519", F.P25519, F.f25519, ed.fp),
        ("bn254", F.BN254, F.fbn, bb.fpb)]
IDS = [m[0] for m in MODS]


def adversarial(m, seed):
    rng = random.Random(seed)
    return ([rng.randrange(m) for _ in range(12)]
            + [0, 1, 2, m - 1, m - 2, m, m + 1, R - 1, (1 << 252) - 1,
               1 << 252, 0xFFF, int("FFF" * 21, 16), F.P, F.N])


def jl(vals):
    """Reference (22, B) 12-bit limbs."""
    return np.asarray(bn.ints_to_limbs(vals), np.int32)


def jints(a, m):
    """Reference limbs (relaxed, < a few m) -> canonical ints mod m."""
    return [v % m for v in bn.limbs_to_ints(np.asarray(a))]


@pytest.mark.parametrize("name,m,port,ref", MODS, ids=IDS)
def test_mul_sqr_match_ints_and_flatmod(name, m, port, ref):
    va = adversarial(m, 11)
    vb = list(reversed(va))
    a, b = F.ints_to_limbs(va), F.ints_to_limbs(vb)
    # Montgomery product in the port's own radix
    got = F.limbs_to_ints(port.mul(a, b))
    assert got == [x * y * pow(R, -1, m) % m for x, y in zip(va, vb)]
    assert all(0 <= g < m for g in got)
    # the plain product a*b mod m through each side's Montgomery domain
    prod = F.limbs_to_ints(port.from_mont(
        port.mul(port.to_mont(a), port.to_mont(b))))
    sq = F.limbs_to_ints(port.from_mont(port.sqr(port.to_mont(a))))
    ja, jb = ref.to_mont(jl(va)), ref.to_mont(jl(vb))
    assert prod == [x * y % m for x, y in zip(va, vb)]
    assert prod == jints(ref.from_mont(ref.mul(ja, jb)), m)
    assert sq == [x * x % m for x in va]
    assert sq == jints(ref.from_mont(ref.sqr(ja)), m)


@pytest.mark.parametrize("name,m,port,ref", MODS, ids=IDS)
def test_add_sub_canon_match_ints_and_flatmod(name, m, port, ref):
    va = [v % m for v in adversarial(m, 5)]
    vb = list(reversed(va))
    a, b = F.ints_to_limbs(va), F.ints_to_limbs(vb)
    add = F.limbs_to_ints(port.add(a, b))
    sub = F.limbs_to_ints(port.sub(a, b))
    assert add == [(x + y) % m for x, y in zip(va, vb)]
    assert sub == [(x - y) % m for x, y in zip(va, vb)]
    assert add == jints(ref.canon(ref.mod_add(jl(va), jl(vb))), m)
    assert sub == jints(ref.canon(ref.mod_sub(jl(va), jl(vb))), m)
    raw = adversarial(m, 6)                      # any 256-bit value
    canon = F.limbs_to_ints(port.canon(F.ints_to_limbs(raw)))
    assert canon == [v % m for v in raw]
    assert canon == jints(ref.canon(jl(raw)), m)


@pytest.mark.parametrize("name,m,port,ref", MODS, ids=IDS)
def test_inv_matches_ints_and_flatmod(name, m, port, ref):
    va = [v % m for v in adversarial(m, 7)]
    got = F.limbs_to_ints(port.from_mont(port.inv(port.to_mont(
        F.ints_to_limbs(va)))))
    want = [pow(x, m - 2, m) for x in va]       # inv(0) = 0
    assert got == want
    jref = jints(ref.from_mont(ref.inv(ref.to_mont(jl(va)))), m)
    assert got == jref


@pytest.mark.parametrize("name,m,port,ref", MODS, ids=IDS)
def test_predicates_match_flatfield(name, m, port, ref):
    vals = [0, 1, m - 1, m, m + 1, F.P - 1, F.P, R - 1, 1 << 255]
    x = F.ints_to_limbs(vals)
    for c in (m, F.N, F.P, (F.N - 1) // 2 + 1):
        got = F.lt_const(x, c).tolist()
        assert got == [v < c for v in vals]
        assert got == np.asarray(ff.lt_const(jl(vals), c)).tolist()
    zero = F.is_zero_limbs(x).tolist()
    assert zero == [v == 0 for v in vals]
    assert zero == np.asarray(ff.is_zero_limbs(jl(vals))).tolist()
    red = port.canon(x)
    assert port.is_zero(red).tolist() == [v % m == 0 for v in vals]
    assert port.eq(red, port.canon(F.ints_to_limbs(
        [v + m if v < R - m else v for v in vals]))).tolist() == \
        [True] * len(vals)


def test_add_const_carry():
    vals = [0, F.P, R - 1, R - F.N, R - F.N - 1]
    s, carry = F.add_const(F.ints_to_limbs(vals), F.N)
    assert F.limbs_to_ints(s) == [(v + F.N) % R for v in vals]
    assert carry.tolist() == [v + F.N >= R for v in vals]


@pytest.mark.parametrize("modulus", IDS)
@pytest.mark.parametrize("k", [0, 1, 5])
def test_mul_chain_plain_matches_ints(modulus, k):
    m = F.MODS[modulus].m
    va = adversarial(m, 21)
    vb = adversarial(m, 22)[::-1]
    a, b = F.ints_to_words_le(va), F.ints_to_words_le(vb)
    out = F.mul_chain_plain(a, b, k, modulus)
    assert out.dtype == torch.uint32 and out.shape == a.shape
    rinv = pow(R, -1, m)
    assert F.words_le_to_ints(out) == [
        x * pow(y * rinv, k, m) % m for x, y in zip(va, vb)]
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(F.field_mul_chain(a, b, k, modulus), out)


def test_field_mul_chain_rejects_bad_inputs():
    a = F.ints_to_words_le([1, 2])
    with pytest.raises(TypeError):
        F.field_mul_chain(a.to(torch.int64), a, 1)
    with pytest.raises(ValueError):
        F.field_mul_chain(a, a[:1], 1)
    with pytest.raises(ValueError):
        F.field_mul_chain(a, a, 1, modulus="q")


def test_limb_codecs_match_bignum():
    rng = random.Random(3)
    vals = [0, 1, F.P, R - 1] + [rng.randrange(R) for _ in range(12)]
    words = np.stack([np.frombuffer(v.to_bytes(32, "big"), ">u4")
                      for v in vals], 1).astype(np.uint32)      # (8, B)
    port = F.limbs_to_ints(F.words_be_to_limbs(torch.from_numpy(words)))
    ref = bn.limbs_to_ints(np.asarray(bn.words_be_to_limbs(words)))
    assert port == vals == ref
    assert F.limbs_to_ints(F.ints_to_limbs(vals)) == vals
    assert F.int_to_limbs(F.P) == [(F.P >> (16 * i)) & 0xFFFF
                                   for i in range(16)]
    assert F.words_le_to_ints(F.ints_to_words_le(vals)) == vals
    le = F.ints_to_words_le(vals)
    assert F.limbs_to_ints(F.words_le_to_limbs(le)) == vals
    assert torch.equal(F.limbs_to_words_le(F.words_le_to_limbs(le)), le)
    with pytest.raises(ValueError):
        F.int_to_limbs(R)


def _cuh_constants():
    src = (Path(F.__file__).parent / "csrc" / "p256_field.cuh").read_text()
    arrays = {}
    for name, body in re.findall(
            r"static __constant__ uint32_t (\w+)\[8\] = \{([^}]*)\}", src):
        words = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        arrays[name] = sum(w << (32 * i) for i, w in enumerate(words))
    defines = {k: int(v, 16) for k, v in re.findall(
        r"#define (\w+_MINV) (0x[0-9A-Fa-f]+)u", src)}
    return arrays, defines


def test_cuda_header_constants():
    """The kernels' hard-coded constants equal the values computed here."""
    arrays, defines = _cuh_constants()
    P, N = F.P, F.N
    Q = F.P25519
    B = F.BN254
    assert arrays == {
        "C_P": P, "C_N": N, "C_F25519": Q, "C_BN254": B,
        "C_P_R2": R * R % P, "C_N_R2": R * R % N, "C_F25519_R2": R * R % Q,
        "C_BN254_R2": R * R % B,
        "C_P_ONE": R % P, "C_F25519_ONE": R % Q, "C_BN254_ONE": R % B,
        "C_A_MONT": (P - 3) * R % P,
        "C_B_MONT": ec.B * R % P,
        "C_HALF_N_PLUS_1": (N - 1) // 2 + 1,
    }
    assert defines == {"P256_P_MINV": F.fp.n0inv32,
                       "P256_N_MINV": F.fn.n0inv32,
                       "F25519_MINV": F.f25519.n0inv32,
                       "BN254_MINV": F.fbn.n0inv32}
    assert F.MOD_INDEX == {"p": 0, "n": 1, "p25519": 2, "bn254": 3}
    from fabric_tpu.idemix import bn254 as hb
    assert B == hb.P
