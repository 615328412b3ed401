"""A CPU model of KP3's block-batched s^-1 mod n
(fabric_tpu_torch/ops/csrc/p256_verify_rows.cu, block_inv_n), step for
step as a block of threads runs it, in Python ints against pow(s, n - 2,
n), exactly (no tolerance: integers).

Per block of THREADS threads: each thread brings s in Montgomery form
mod n (R = 2^256), or Montgomery one where s is refused (0, >= n, or
high-S under the low-S rule) or the thread lies past the batch; each warp
takes inclusive prefix and suffix products by shuffles (offsets 1, 2, 4,
8, 16); one thread takes the warps' exclusive products and the Fermat
chain of mont_inv_ptx on the block's product; each thread multiplies the
products before and after it and the inverse.  The block size and the
constant Montgomery one are read from the kernel's source."""
import random
import re
from pathlib import Path

import pytest

from fabric_tpu_torch.ops import field as F

SRC = (Path(F.__file__).parent / "csrc" / "p256_verify_rows.cu").read_text()
THREADS = int(re.search(r"constexpr int THREADS = (\d+);", SRC).group(1))
N = F.N
R = 1 << 256
RINV = pow(R, -1, N)
HALF_N_PLUS_1 = (N - 1) // 2 + 1


def mont(a, b):
    """mont_mul_ptx<MOD_N>: a b 2^-256 mod n."""
    return a * b * RINV % N


def n_one():
    """C_N_ONE's limbs, little-endian, from the source."""
    body = re.search(r"C_N_ONE\[8\] = \{([^}]*)\}", SRC).group(1)
    limbs = [int(x.strip().rstrip("u"), 16) for x in body.split(",")]
    return sum(v << (32 * i) for i, v in enumerate(limbs))


def mont_inv(a):
    """mont_inv_ptx<MOD_N>: the Fermat chain over the bits of n - 2."""
    acc, e = a, N - 2
    for i in range(254, -1, -1):
        acc = mont(acc, acc)
        if (e >> i) & 1:
            acc = mont(acc, a)
    return acc


def block_inv(v):
    """block_inv_n on one block's THREADS Montgomery values."""
    one = n_one()
    warps = len(v) // 32
    pre, suf = list(v), list(v)
    d = 1
    while d < 32:
        up = [pre[i - d] if i % 32 >= d else pre[i] for i in range(len(v))]
        down = [suf[i + d] if i % 32 + d < 32 else suf[i]
                for i in range(len(v))]
        pre = [mont(up[i], pre[i]) if i % 32 >= d else pre[i]
               for i in range(len(v))]
        suf = [mont(suf[i], down[i]) if i % 32 + d < 32 else suf[i]
               for i in range(len(v))]
        d <<= 1
    tot = [pre[32 * w + 31] for w in range(warps)]
    after, acc = [None] * warps, one
    for k in range(warps - 1, -1, -1):
        after[k] = acc
        acc = mont(tot[k], acc)
    before, acc = [None] * warps, one
    for k in range(warps):
        before[k] = acc
        acc = mont(acc, tot[k])
    inv = mont_inv(acc)
    out = []
    for i in range(len(v)):
        lane, w = i % 32, i // 32
        p = one if lane == 0 else pre[i - 1]
        s = one if lane == 31 else suf[i + 1]
        out.append(mont(mont(mont(before[w], p), mont(s, after[w])), inv))
    return out


def batch_inv(ss, low_s=True):
    """The kernel's w (Montgomery form of s^-1 mod n, Montgomery one for
    a refused s) for a batch, block by block, the last one ragged."""
    one = n_one()
    out = []
    for lo in range(0, len(ss), THREADS):
        v = []
        for i in range(lo, lo + THREADS):
            s = ss[i] if i < len(ss) else None
            ok = s is not None and 0 < s < N and (
                not low_s or s < HALF_N_PLUS_1)
            v.append(mont(s, R * R % N) if ok else one)
        out += block_inv(v)[:min(THREADS, len(ss) - lo)]
    return out


def test_constants():
    assert THREADS % 32 == 0
    assert n_one() == R % N


@pytest.mark.parametrize("n", [1, 31, 127, 128, 129, 300])
@pytest.mark.parametrize("low_s", [True, False])
def test_batched_inverse_matches_python_ints(n, low_s):
    rng = random.Random(n)
    ss = [rng.randrange(1, N) for _ in range(n)]
    for i, bad in zip(range(0, n, 7), (0, N, N + 5, R - 1, N - 1,
                                       HALF_N_PLUS_1, 1)):
        ss[i] = bad
    w = batch_inv(ss, low_s)
    assert len(w) == n
    for s, wi in zip(ss, w):
        ok = 0 < s < N and (not low_s or s < HALF_N_PLUS_1)
        if ok:
            # u1 = e w in the kernel: Montgomery w times plain e is plain
            assert mont(wi, 1) == pow(s, N - 2, N)
            e = (s * 977 + 3) % R
            assert mont(e, wi) == e * pow(s, N - 2, N) % N
        else:
            assert wi == R % N           # the inverse of one: one


def test_mont_inv_is_fermat():
    for s in (1, 2, N - 1, 0xDEADBEEF, HALF_N_PLUS_1):
        assert mont(mont_inv(s * R % N), 1) == pow(s, N - 2, N)
