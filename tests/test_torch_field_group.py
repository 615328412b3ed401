"""The group multiply of KP1 and KF2 (fabric_tpu_torch/ops/csrc/
field_group.cuh) on the CPU, before and without any build.

A Python mirror of the header's C runs one lane's Montgomery multiply on
TPI = 4 or 8 model threads, each with its own registers: every asm
statement is the header's own PTX text, parsed from the header and run
through the carry-semantics model of test_torch_field_ptx.py (`run_asm`,
`Fault`), and every __shfl*_sync and __ballot_sync is an explicit
exchange between the model threads.  The multiply is held against
Python ints for P-256's p and n, p25519 and BN254's p, exact and lazy;
one dropped carry, or one shuffle that reads the wrong lane, must make
the check fail.  Above it, mirrors of the two kernels' chains (KP1:
`field_chain.cu` kp1_group_kernel; KF2: `field_chain_variants.cu`
kf2_group_kernel, with its lane order and layouts) are held against the
plain versions (`field.mul_chain_plain`, `field_variants.variant_plain`)
and, mod p at R = 2^264, against the JAX package's `bignum.Mont` chain.
The launch rule (`field.group_plan`) is checked here too."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabric_tpu.ops import bignum as bn
from fabric_tpu_torch import experiments as X
from fabric_tpu_torch.ops import field as F
from fabric_tpu_torch.ops import field_variants as FV

from test_torch_field_ptx import NO_FAULT, Fault, parse_asm, run_asm

CSRC = Path(F.__file__).resolve().parent / "csrc"
HEADER = (CSRC / "field_group.cuh").read_text()
FIELD_H = (CSRC / "p256_field.cuh").read_text()
M32 = (1 << 32) - 1
R = 1 << 256

STATEMENTS = ("grp_mul_row1", "grp_mul_row2", "grp_red_row1",
              "grp_red_row2", "grp_add_words1", "grp_add_words2",
              "grp_shift", "grp_add_small1", "grp_add_small2", "grp_sub1",
              "grp_sub2", "grp_sub_small2")
ASM = {name: parse_asm(name, HEADER) for name in STATEMENTS}

RED_GENERIC, RED_P, RED_25519 = 0, 1, 2
LEAST_RED = {F.P: RED_P, F.N: RED_GENERIC, F.P25519: RED_25519,
             F.BN254: RED_GENERIC}
MODULI = {"p": F.P, "n": F.N, "p25519": F.P25519, "bn254": F.BN254}


def field_words(name: str) -> list:
    """The little-endian words of p256_field.cuh's constant array name."""
    m = re.search(r"%s\[8\] = \{(.*?)\};" % name, FIELD_H, re.S)
    assert m, name
    return [int(w.rstrip("u"), 16) for w in re.findall(r"0x[0-9A-F]+u",
                                                       m.group(1))]


def field_macro(name: str) -> int:
    return int(re.search(r"#define %s (0x[0-9A-F]+)u" % name,
                         FIELD_H).group(1), 16)


# mword<M> and minv<M>, as the header reads them
MWORDS = {F.P: field_words("C_P"), F.N: field_words("C_N"),
          F.P25519: field_words("C_F25519"), F.BN254: field_words("C_BN254")}
MINV = {F.P: field_macro("P256_P_MINV"), F.N: field_macro("P256_N_MINV"),
        F.P25519: field_macro("F25519_MINV"),
        F.BN254: field_macro("BN254_MINV")}


def limbs32(x: int) -> list:
    return [(x >> (32 * j)) & M32 for j in range(8)]


def value(w) -> int:
    return sum(int(v) << (32 * j) for j, v in enumerate(w))


# ---------------------------------------------------------------------------
# The warp: shuffles and ballots as exchanges between model threads
# ---------------------------------------------------------------------------

class ShuffleFault:
    """Make the shuffle at `site` read `delta` lanes off its source."""

    def __init__(self, site=None, delta=0):
        self.site, self.delta = site, delta

    def off(self, site: str) -> int:
        return self.delta if site == self.site else 0


NO_SHUFFLE_FAULT = ShuffleFault()


def shfl(vals, src, site, sf):
    """__shfl_sync(mask, v, src, TPI): every thread reads rank src."""
    tpi = len(vals)
    s = (src + sf.off(site)) % tpi
    return [vals[s] for _ in range(tpi)]


def shfl_down(vals, delta, site, sf):
    """__shfl_down_sync(mask, v, delta, TPI): rank r reads r + delta, or
    its own value past the group's end."""
    d = delta + sf.off(site)
    return [vals[r + d] if r + d < len(vals) else vals[r]
            for r in range(len(vals))]


def shfl_up(vals, delta, site, sf):
    """__shfl_up_sync(mask, v, delta, TPI): rank r reads r - delta, or its
    own value below the group's start."""
    d = delta + sf.off(site)
    return [vals[r - d] if r - d >= 0 else vals[r] for r in range(len(vals))]


def ballot(preds) -> int:
    """group_bits: the group's ballot, rank 0 in bit 0."""
    return sum(1 << r for r, p in enumerate(preds) if p)


# the header's shuffles, in its order: (function, call, value, source)
SHUFFLES = [
    ("group_gather", "__shfl_sync", "x[j % L]", "j / L"),
    ("group_resolve", "__shfl_up_sync", "e", "1"),
    ("group_mul", "__shfl_sync", "t[0] * p256::minv<M>()", "0"),
    ("group_mul", "__shfl_sync", "t[0]", "0"),
    ("group_mul", "__shfl_sync", "t[0]", "0"),
    ("group_mul", "__shfl_down_sync", "t[0]", "1"),
]


# ---------------------------------------------------------------------------
# The header's C, statement for statement, on TPI model threads
# ---------------------------------------------------------------------------

def group_mod(tpi: int, m: int, red: int) -> list:
    """group_mod<TPI, M, RED>: each rank's modulus words, selectors and
    top/below masks."""
    L = 8 // tpi
    out = []
    for rank in range(tpi):
        gm = {"m": [], "k0": [], "k1": [], "k2": []}
        for l in range(L):
            pos = rank * L + l
            gm["m"].append(MWORDS[m][pos])
            p, x = red == RED_P, red == RED_25519
            gm["k0"].append(1 if p and pos in (3, 6)
                            else M32 if (p and pos == 7) or (x and pos == 1)
                            else 0)
            gm["k1"].append(M32 if x and 2 <= pos <= 6 else 0)
            gm["k2"].append(M32 if x and pos == 7 else 0)
        gm["top"] = M32 if rank == tpi - 1 else 0
        gm["below"] = (~gm["top"]) & M32
        out.append(gm)
    return out


def group_gather(x, sf=NO_SHUFFLE_FAULT) -> list:
    """Every rank gets the 8 words of x (x: each rank's L words)."""
    tpi = len(x)
    L = 8 // tpi
    w = [[0] * 8 for _ in range(tpi)]
    for j in range(8):
        got = shfl([x[r][j % L] for r in range(tpi)], j // L, "gather", sf)
        for r in range(tpi):
            w[r][j] = got[r]
    return w


def group_own(w) -> list:
    """Each rank's L words of a value every rank holds whole."""
    tpi = len(w)
    L = 8 // tpi
    return [[w[r][r * L + l] for l in range(L)] for r in range(tpi)]


def group_resolve(t, e, gm, lazy, fault=NO_FAULT, sf=NO_SHUFFLE_FAULT,
                  warp_carry=False):
    """warp_carry: another group of the warp carried out of a thread, so
    this one takes the lookahead branch whatever its own carries."""
    tpi = len(t)
    L = 8 // tpi
    up = shfl_up(e, 1, "ein", sf)
    gen = []
    for r in range(tpi):
        env = {"t": t[r], "g": None, "c": 0 if r == 0 else up[r]}
        run_asm(f"grp_add_small{L}", env, fault, ASM)
        gen.append(env["g"])
    carry_top = 0
    if warp_carry or ballot([g != 0 for g in gen]) != 0:
        ones = []
        for r in range(tpi):
            o = t[r][0]
            for l in range(1, L):
                o &= t[r][l]
            ones.append(o)
        G = ballot([g != 0 for g in gen])
        P = ballot([o == M32 for o in ones])
        S = (G | P) + G
        for r in range(tpi):
            env = {"t": t[r], "g": None, "c": ((S ^ P) >> r) & 1}
            run_asm(f"grp_add_small{L}", env, fault, ASM)
        carry_top = (S >> tpi) & 1
    hi = [(e[r] + carry_top) & gm[r]["top"] for r in range(tpi)]
    d, bo, diff = [], [], []
    for r in range(tpi):
        d.append(list(t[r]))
        env = {"d": d[r], "bo": None, "m": gm[r]["m"]}
        run_asm(f"grp_sub{L}", env, fault, ASM)
        bo.append(env["bo"])
        x = d[r][0]
        for l in range(1, L):
            x |= d[r][l]
        diff.append(x)
    force = [lazy and gm[r]["top"] != 0 for r in range(tpi)]
    GB = ballot([h == 0 and (b != 0 or f)
                 for b, h, f in zip(bo, hi, force)])
    PB = ballot([h == 0 and x == 0 and not f
                 for x, h, f in zip(diff, hi, force)])
    SB = (GB | PB) + GB
    for r in range(tpi):
        c = ((SB ^ PB) >> r) & 1
        if L == 1:
            d[r][0] = (d[r][0] - c) & M32
        else:
            run_asm("grp_sub_small2", {"d": d[r], "c": c}, fault, ASM)
    use_d = ((SB >> tpi) & 1) == 0
    return [list(d[r]) if use_d else list(t[r]) for r in range(tpi)]


def group_mul(a, bw, m, red, lazy, fault=NO_FAULT, sf=NO_SHUFFLE_FAULT,
              warp_carry=False):
    """r = a b 2^-256: a as each rank's L words, bw each rank's copy of
    b's 8 words -> each rank's L words of r."""
    tpi = len(a)
    L = 8 // tpi
    gm = group_mod(tpi, m, red)
    t = [[0] * L for _ in range(tpi)]
    e = [0] * tpi
    for i in range(8):
        z, z2 = list(e), [None] * tpi
        for r in range(tpi):
            env = {"t": t[r], "z": z[r], "z2": None, "w": bw[r][i],
                   "a": a[r]}
            run_asm(f"grp_mul_row{L}", env, fault, ASM)
            z[r], z2[r] = env["z"], env["z2"]
        if red == RED_GENERIC:
            q = shfl([(t[r][0] * MINV[m]) & M32 for r in range(tpi)], 0,
                     "q", sf)
            for r in range(tpi):
                env = {"t": t[r], "z": z[r], "z2": z2[r], "q": q[r],
                       "m": gm[r]["m"]}
                run_asm(f"grp_red_row{L}", env, fault, ASM)
                z[r], z2[r] = env["z"], env["z2"]
        else:
            q = shfl([t[r][0] for r in range(tpi)], 0, "q", sf)
            for r in range(tpi):
                g = gm[r]
                if red == RED_P:
                    w = [(q[r] * g["k0"][l]) & M32 for l in range(L)]
                    wl = (q[r] * g["top"]) >> 32          # __umulhi
                else:
                    qq = (q[r] * MINV[F.P25519]) & M32
                    uh = (qq * 19) >> 32                  # __umulhi
                    b = 1 if uh != 0 else 0
                    w0 = (0 - uh) & M32
                    wm = (0 - b) & M32
                    v = ((qq << 31) - b) & ((1 << 64) - 1)
                    w6, w7 = v & M32, v >> 32
                    w = [(w0 & g["k0"][l]) | (wm & g["k1"][l])
                         | (w6 & g["k2"][l]) for l in range(L)]
                    wl = w7 & g["top"]
                env = {"t": t[r], "z": z[r], "z2": z2[r], "w": w, "wl": wl}
                run_asm(f"grp_add_words{L}", env, fault, ASM)
                z[r], z2[r] = env["z"], env["z2"]
        x = shfl_down([t[r][0] for r in range(tpi)], 1, "shift", sf)
        for r in range(tpi):
            x[r] &= gm[r]["below"]
            for l in range(L - 1):
                t[r][l] = t[r][l + 1]
            env = {"top": None, "e": None, "z": z[r], "z2": z2[r], "x": x[r]}
            run_asm("grp_shift", env, fault, ASM)
            t[r][L - 1], e[r] = env["top"], env["e"]
            if fault is NO_FAULT and sf is NO_SHUFFLE_FAULT:
                assert e[r] <= 3 and z2[r] <= 2     # the header's bounds
    return group_resolve(t, e, gm, lazy, fault, sf, warp_carry)


def distribute(x: int, tpi: int) -> list:
    L = 8 // tpi
    w = limbs32(x)
    return [w[r * L:(r + 1) * L] for r in range(tpi)]


def gathered(x: int, tpi: int) -> list:
    return [limbs32(x) for _ in range(tpi)]


def collect(parts) -> int:
    return value([w for part in parts for w in part])


def mul_int(a: int, b: int, m: int, red: int, lazy: bool, tpi: int,
            fault=NO_FAULT, sf=NO_SHUFFLE_FAULT, warp_carry=False) -> int:
    return collect(group_mul(distribute(a, tpi), gathered(b, tpi), m, red,
                             lazy, fault, sf, warp_carry))


def canon(x: int, m: int) -> int:
    """p256_field.cuh fe_canon<M>: its conditional subtractions."""
    for _ in range((R - 1) // m):
        if x >= m:
            x -= m
    return x


# ---------------------------------------------------------------------------
# The kernels' chains
# ---------------------------------------------------------------------------

S248 = 1 << 248


def kp1_lane(a: int, b: int, k: int, m: int, r264: bool, tpi: int) -> int:
    """kp1_group_kernel on one lane: b canonical (each thread, whole),
    scaled by 2^248 on the group, gathered once; k exact multiplies."""
    red = LEAST_RED[m]
    bw = gathered(canon(b, m), tpi)
    if r264:
        bl = group_mul(group_own(bw), gathered(S248, tpi), m, red, False)
        bw = group_gather(bl)
    if k == 0:
        return canon(a, m)
    t = distribute(a, tpi)
    for _ in range(k):
        t = group_mul(t, bw, m, red, False)
    return collect(t)


def kf2_launch(a: list, b: list, lanes: int, n: int, lazy: bool, k: int,
               planes: bool, mn: bool, tpi: int) -> list:
    """kf2_group_kernel over a flat buffer of 8 x lanes words: thread
    group j carries lanes kk * (lanes / K) + j; word w of a lane at
    w * lanes + lane (planes) or lane * 8 + w."""
    red = RED_P if mn else RED_GENERIC
    per = lanes // k
    out = [None] * (8 * lanes)
    for j in range(per):
        chains = []
        for kk in range(k):
            lane = kk * per + j
            at = [w * lanes + lane if planes else lane * 8 + w
                  for w in range(8)]
            bv = canon(value([b[x] for x in at]), F.P)
            bl = group_mul(distribute(bv, tpi), gathered(S248, tpi), F.P,
                           red, False)
            chains.append((at, distribute(value([a[x] for x in at]), tpi),
                           group_gather(bl)))
        ts = [t for _, t, _ in chains]
        for _ in range(n):
            ts = [group_mul(t, bw, F.P, red, lazy)
                  for t, (_, _, bw) in zip(ts, chains)]
        gm = group_mod(tpi, F.P, red)
        for t, (at, _, _) in zip(ts, chains):
            r = collect(group_resolve(t, [0] * tpi, gm, False))
            for w, x in enumerate(at):
                out[x] = (r >> (32 * w)) & M32
    return out


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def seeded(m: int, count: int, seed: int) -> list:
    """count (a, b): a < 2^256, b < m, from numpy's generator."""
    rng = np.random.default_rng(seed)

    def draw(bound):
        return int.from_bytes(rng.bytes(32), "big") % bound

    return [(draw(R), draw(m)) for _ in range(count)]


def edges(m: int) -> list:
    """0, 1, m - 1; a >= m up to 2^256 - 1; b = 1 and 2 with a = m and
    2m, whose lazy result is m itself (in [m, 2^256))."""
    a_vals = [0, 1, m - 1, m, m + 1, R - 1, R - m, (1 << 255) + 7]
    b_vals = [0, 1, 2, m - 1, m - 2, R * R % m, 1 << 248]
    out = [(a, b) for a in a_vals for b in b_vals]
    out += [(m, 1), (m, 2)] + ([(2 * m, 1)] if 2 * m < R else [])
    return out


def want(a: int, b: int, m: int) -> int:
    return a * b * pow(R, -1, m) % m


# ---------------------------------------------------------------------------
# Tests: the header
# ---------------------------------------------------------------------------

def test_statements_parse_and_chains_start_clean():
    """Every asm statement parses, starts without a carry-in and runs on
    the model (the model asserts that no carry is read before one of the
    statement's own instructions wrote it)."""
    for name, st in ASM.items():
        first = st["instrs"][0][0]
        assert not first.startswith(("addc", "subc", "madc")), name
        assert first.endswith(".cc.u32"), name


def test_header_moduli_and_minv():
    for m, w in MWORDS.items():
        assert value(w) == m
        assert (MINV[m] * m) % (1 << 32) == M32       # -m^-1 mod 2^32


def test_header_shuffles_are_the_models():
    """The header's shuffles, in order, are the ones the model exchanges:
    the same value from the same source lane, width TPI, over the
    group's mask."""
    got = []
    for m in re.finditer(r"(__shfl(?:_up|_down)?_sync)\(g\.mask, ", HEADER):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(HEADER[i], 0)
            i += 1
        args = [a.strip() for a in
                re.split(r",(?![^(<]*[)>])", HEADER[m.end():i - 1])]
        assert args[-1] == "TPI", args
        fn = re.findall(r"\n__device__ __forceinline__ \w+ (\w+)\(",
                        HEADER[:m.start()])[-1]
        got.append((fn, m.group(1), " ".join(args[0].split()), args[1]))
    assert got == SHUFFLES
    assert len(re.findall(r"__ballot_sync\(g\.mask, ", HEADER)) == 2
    assert HEADER.count("group_bits(g,") == 4


# ---------------------------------------------------------------------------
# Tests: the multiply against ints
# ---------------------------------------------------------------------------

CASES = [(tpi, mod, lazy) for tpi in (4, 8) for mod in MODULI
         for lazy in (False, True)]


@pytest.mark.parametrize("tpi,mod,lazy", CASES)
def test_group_mul_matches_ints(tpi, mod, lazy):
    m = MODULI[mod]
    red = LEAST_RED[m]
    for a, b in edges(m) + seeded(m, 40, seed=tpi + 3 * list(MODULI).index(
            mod)):
        got = mul_int(a, b, m, red, lazy, tpi)
        if lazy:
            assert got % m == want(a, b, m) and 0 <= got < R, (hex(a), b)
        else:
            assert got == want(a, b, m), (hex(a), hex(b))


@pytest.mark.parametrize("tpi", [4, 8])
@pytest.mark.parametrize("lazy", [False, True])
def test_lookahead_branch_taken_for_the_warp(tpi, lazy):
    """The carry lookahead runs when any group of the warp carried out of
    a thread; taken for a group with no such carry, it changes nothing."""
    for mod, m in MODULI.items():
        red = LEAST_RED[m]
        for a, b in edges(m)[::3] + seeded(m, 8, seed=4):
            got = mul_int(a, b, m, red, lazy, tpi, warp_carry=True)
            if lazy:
                assert got % m == want(a, b, m) and got < R
                assert got == mul_int(a, b, m, red, lazy, tpi)
            else:
                assert got == want(a, b, m)


@pytest.mark.parametrize("tpi", [4, 8])
def test_generic_reduction_mod_p(tpi):
    """KF2's presets other than `min` run the generic q m row mod p."""
    for a, b in edges(F.P) + seeded(F.P, 30, seed=5):
        assert mul_int(a, b, F.P, RED_GENERIC, False, tpi) == want(a, b,
                                                                   F.P)
        lazy = mul_int(a, b, F.P, RED_GENERIC, True, tpi)
        assert lazy % F.P == want(a, b, F.P) and lazy < R


@pytest.mark.parametrize("tpi", [4, 8])
@pytest.mark.parametrize("mod", sorted(MODULI))
def test_lazy_keeps_values_in_m_to_2_256(tpi, mod):
    """The relaxed end subtracts m only when bit 256 is set: a = m, b = 1
    gives m itself (Q = 2^256 - 1), which the exact end takes to 0."""
    m = MODULI[mod]
    red = LEAST_RED[m]
    assert mul_int(m, 1, m, red, True, tpi) == m
    assert mul_int(m, 2, m, red, True, tpi) == m
    assert mul_int(m, 1, m, red, False, tpi) == 0
    if 2 * m < R:
        assert mul_int(2 * m, 1, m, red, True, tpi) == m


@pytest.mark.parametrize("tpi", [4, 8])
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("warp_carry", [False, True])
def test_resolve_lookahead_ripples_through_all_ones_threads(tpi, lazy,
                                                            warp_carry):
    """group_resolve on redundant forms whose carries (and then borrows)
    ripple through every thread: limbs all ones above a boundary word
    e = 1, and the top thread's e as the value's bit 256."""
    L = 8 // tpi
    for m in (F.P25519, F.BN254, F.P, F.N):
        gm = group_mod(tpi, m, LEAST_RED[m])
        shapes = [((1 << 255) - 1, [1] + [0] * (tpi - 1)),
                  ((1 << 253) - 1, [3, 0, 2] + [0] * (tpi - 3)),
                  (m - 1, [0] * tpi), (m, [0] * tpi),
                  (R - 1 - (1 << (32 * L)), [1] + [0] * (tpi - 1)),
                  (m - 2, [0] * (tpi - 1) + [1])]
        for words, e in shapes:
            v = words + sum(c << (32 * L * (r + 1)) for r, c in enumerate(e))
            if v >= 2 * m or words >= R:
                continue
            got = collect(group_resolve(distribute(words, tpi), e, gm, lazy,
                                        warp_carry=warp_carry))
            if lazy:
                assert got == (v - m if v >= R else v), (hex(m), e)
            else:
                assert got == v % m, (hex(m), e)


# one site in each chain: the row's low and high chains and their carries
# into the boundary words, the q m row's, the special words' adds, the
# shift's carry into e, the resolution's carry-in, the subtraction's
# borrows
DROP_SITES = [("grp_mul_row1", 1), ("grp_mul_row1", 2),
              ("grp_mul_row2", 1), ("grp_mul_row2", 2), ("grp_mul_row2", 4),
              ("grp_mul_row2", 5), ("grp_red_row1", 1), ("grp_red_row1", 2),
              ("grp_red_row2", 1), ("grp_red_row2", 2), ("grp_red_row2", 3),
              ("grp_red_row2", 5), ("grp_red_row2", 6),
              ("grp_add_words1", 1), ("grp_add_words1", 2),
              ("grp_add_words2", 1), ("grp_add_words2", 2),
              ("grp_add_words2", 3), ("grp_shift", 1),
              ("grp_add_small1", 1), ("grp_add_small2", 1),
              ("grp_add_small2", 2), ("grp_sub1", 1), ("grp_sub2", 1),
              ("grp_sub2", 2), ("grp_sub_small2", 1)]


def _sites_tpi(name: str) -> int:
    return 8 if name.endswith("1") else 4 if name.endswith("2") else 0


@pytest.mark.parametrize("name,index", DROP_SITES)
def test_dropped_carry_is_caught(name, index):
    """With the carry into one instruction dropped, some input of the test
    set gives a wrong result."""
    assert ASM[name]["instrs"][index][0].split(".")[0] in (
        "addc", "subc", "madc")
    fault = Fault(name, index)
    tpis = [_sites_tpi(name)] if _sites_tpi(name) else [4, 8]
    for tpi in tpis:
        for mod, m in MODULI.items():
            red = LEAST_RED[m]
            if name.startswith("grp_red_row") and red != RED_GENERIC:
                continue
            if name.startswith("grp_add_words") and red == RED_GENERIC:
                continue
            for a, b in edges(m) + seeded(m, 30, seed=1):
                if mul_int(a, b, m, red, False, tpi, fault) != want(a, b, m):
                    return
    pytest.fail(f"dropping the carry into {name}[{index}] went unseen")


@pytest.mark.parametrize("site", ["q", "shift", "ein"])
@pytest.mark.parametrize("tpi", [4, 8])
def test_wrong_shuffle_lane_is_caught(site, tpi):
    sf = ShuffleFault(site, 1)
    for mod, m in MODULI.items():
        red = LEAST_RED[m]
        for a, b in edges(m) + seeded(m, 10, seed=2):
            if mul_int(a, b, m, red, False, tpi, NO_FAULT, sf) != want(
                    a, b, m):
                return
    pytest.fail(f"a shuffle off by one lane at {site} went unseen")


@pytest.mark.parametrize("tpi", [4, 8])
def test_wrong_gather_lane_is_caught(tpi):
    x = distribute(0x1234_5678_9ABC_DEF0 * (1 << 130) + 77, tpi)
    assert value(group_gather(x)[0]) == collect(x)
    assert value(group_gather(x, ShuffleFault("gather", 1))[0]) != collect(x)


# ---------------------------------------------------------------------------
# Tests: the kernels' chains against the plain versions and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tpi", [4, 8])
@pytest.mark.parametrize("mod", sorted(MODULI))
@pytest.mark.parametrize("r_log2", F.R_LOG2S)
def test_kp1_chain_model_matches_plain(mod, r_log2, tpi):
    m = MODULI[mod]
    va = [0, 1, m - 1, m, R - 1, 1 << 248]
    vb = [R - 1, m + 1, 3, m - 1, 1 << 255, m]
    for k in (0, 1, 3):
        plain = F.words_le_to_ints(F.mul_chain_plain(
            F.ints_to_words_le(va), F.ints_to_words_le(vb), k, mod, r_log2))
        got = [kp1_lane(a, b, k, m, r_log2 == 264, tpi)
               for a, b in zip(va, vb)]
        assert got == plain


def _flat(x: torch.Tensor) -> list:
    return [int(v) for v in x.view(torch.int32).flatten().tolist()]


@pytest.mark.parametrize("tpi", [4, 8])
@pytest.mark.parametrize("preset,k", [("relaxed", None), ("stacked", None),
                                      ("min", None), ("planes", None),
                                      ("ilp", 2), ("exact", None)])
def test_kf2_chain_model_matches_variant_plain(preset, k, tpi):
    """The group kernel's lane order (chain kk of group j is lane kk *
    (B / K) + j) and layouts, against variant_plain, on 8 lanes."""
    v = FV.variant_of(preset, k)
    va, vb = list(X.seeded_ints(6)) + [0, F.P - 1], \
        list(X.seeded_ints(6))[::-1] + [F.P - 1, 1]
    a, b = F.ints_to_words_le(va), F.ints_to_words_le(vb)
    if v.planes:
        a, b = FV.to_planes(a), FV.to_planes(b)
    n = 3
    plain = FV.variant_plain(a, b, n, preset, k)
    got = kf2_launch([x & M32 for x in _flat(a)],
                     [x & M32 for x in _flat(b)], len(va), n, v.lazy, v.k,
                     v.planes, v.min, tpi)
    assert got == [x & M32 for x in _flat(plain)]


def test_chain_model_matches_reference_mont_chain():
    """Mod p at R = 2^264 the model's KP1 chain is the reference's own
    function: a chain of `bignum.Mont(P256, "p").mul`, jitted."""
    va = list(X.seeded_ints(24)) + [0, 1, F.P - 1]
    vb = va[::-1]
    k = 3
    mont = jax.jit(bn.Mont(F.P, "p").mul)
    x = jnp.asarray(bn.ints_to_limbs(va))
    y = jnp.asarray(bn.ints_to_limbs(vb))
    for _ in range(k):
        x = mont(x, y)
    ref = [v % F.P for v in bn.limbs_to_ints(np.asarray(x))]
    for tpi, lanes in ((8, range(0, 27, 2)), (4, range(1, 27, 2))):
        for i in lanes:
            assert kp1_lane(va[i], vb[i], k, F.P, True, tpi) == ref[i]


# ---------------------------------------------------------------------------
# Tests: the launch rule
# ---------------------------------------------------------------------------

def test_group_plan_rule():
    """One thread a lane where that fills the card's thread slots (SMs x
    2,048), else a group of 4; unless the caller fixes the block, it
    halves (down to a warp) while the grid has fewer blocks than SMs."""
    sms = 132
    slots = sms * F.FILL_THREADS_PER_SM
    assert F.GROUP_TPI == 4
    assert F.group_plan(16384, sms) == (4, 128, 512)
    assert F.group_plan(slots, sms) == (1, 128, slots // 128)
    assert F.group_plan(slots - 1, sms)[0] == 4
    assert F.group_plan(1, sms) == (4, 32, 1)
    assert F.group_plan(31, sms) == (4, 32, 4)
    assert F.group_plan(16383, sms) == (4, 128, 512)
    assert F.group_plan(16384, sms, tpi=1) == (1, 64, 256)
    # K = 4 chains a thread at the reference's B: 4,096 groups of 4
    assert F.group_plan(16384, sms, k=4) == (4, 64, 256)
    # ilp's K = 8: 2,048 groups of 4 threads: 32-thread blocks
    assert F.group_plan(16384, sms, k=8) == (4, 32, 256)
    # a block the caller fixes is kept, even where it leaves SMs idle
    assert F.group_plan(16384, sms, threads=512, k=4) == (4, 512, 32)
    assert F.group_plan(16384, sms, threads=128, k=8) == (4, 128, 64)
    # K chains in a thread count as K threads: B lanes that fill the card
    # take one thread whatever K
    assert F.group_plan(slots, sms, threads=512, k=4) == (
        1, 512, slots // 4 // 512)
    assert F.group_plan(slots, sms, k=4) == (1, 128, slots // 4 // 128)
    for lanes in (1, 31, 16383, 16384, 33792, slots):
        tpi, threads, blocks = F.group_plan(lanes, sms)
        assert tpi in F.TPIS and threads % 32 == 0
        assert blocks * threads >= lanes * tpi
        assert blocks >= sms or threads == 32
    assert F.TPIS == (1, 4)
    # the header's TPI = 8 has no kernel: the plan refuses it
    for tpi in (2, 8):
        with pytest.raises(ValueError):
            F.group_plan(10, sms, tpi=tpi)
    assert F.group_plan(10, sms, tpi=4)[0] == 4


def test_sweep_adds_the_plans_block_once(monkeypatch):
    """The experiments' sweep runs each tile's block as it names it and
    adds the launch plan's block only where no configuration runs it: at
    16,384 lanes on 132 SMs, stacked (K = 4) and ilp K = 4 and 8, whose
    128-thread grids leave SMs idle."""
    from fabric_tpu_torch.experiments import proto_ilp, proto_pallas2
    monkeypatch.setattr(F, "sm_count", lambda device: 132)
    dev = torch.device("cpu")
    grid = [("ilp", k, tile) for tile, k in proto_ilp.GRID]
    grid += [(p, None, proto_pallas2.B_TILE) for p in ("relaxed", "stacked")]
    configs = X.plan(grid)
    added = X.with_plan(configs, X.REF_B, dev)[len(configs):]
    assert added == [("ilp", 4, None, ()), ("ilp", 8, None, ()),
                     ("stacked", None, None, ())]
    for preset, k, _, _ in added:
        tpi, block, blocks = FV.variant_plan(preset, k, X.REF_B, dev)
        assert tpi == F.GROUP_TPI and block < 128 and blocks >= 132
    # a fixed block is run as named, idle SMs and all
    assert FV.variant_plan("stacked", None, X.REF_B, dev, 128) == (
        4, 128, 128)
