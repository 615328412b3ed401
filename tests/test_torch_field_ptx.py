"""KP2's field layer (fabric_tpu_torch/ops/csrc/field_ptx.cuh) on the CPU,
before and without any build: an instruction-level model of PTX's carry
semantics runs the PTX text of every asm statement of the header, read
from the header itself, under a statement-for-statement Python mirror of
the C around them, and `mul_p`, `sqr_p`, `mul_25519` (KE5's and KE6's
multiply mod 2^255 - 19) and `mont_mul_ptx` (P-256's n and BN254's p)
are held against Python ints: r == a b 2^-256 mod m, r < m.
A test drops one carry at a time and shows the check catches it.  The
field probe's CPU path (`ops/p256.py` `p256_field_probe`) is held against
ints and against the reference's `bignum.Mont` multiply."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabric_tpu.ops import bignum as bn
from fabric_tpu_torch.ops import field as F
from fabric_tpu_torch.ops import p256

CSRC = Path(F.__file__).resolve().parent / "csrc"
HEADER = (CSRC / "field_ptx.cuh").read_text()
M32 = (1 << 32) - 1
R = 1 << 256
TOP = R - 1


# ---------------------------------------------------------------------------
# The header's asm statements, parsed
# ---------------------------------------------------------------------------

def _function_body(name: str, header: str = HEADER) -> str:
    """The text of the function `name` in the header, from its name to
    the closing brace at column 0."""
    m = re.search(r"\b%s\(" % re.escape(name), header)
    assert m, name
    end = header.index("\n}\n", m.end())
    return header[m.start():end]


def _split_top(s: str, sep: str) -> list:
    """Split at sep outside string literals and parentheses."""
    out, depth, cur, in_str, i = [], 0, [], False, 0
    while i < len(s):
        c = s[i]
        if in_str:
            cur.append(c)
            if c == "\\":
                cur.append(s[i + 1])
                i += 1
            elif c == '"':
                in_str = False
        elif c == '"':
            in_str = True
            cur.append(c)
        elif c == "(":
            depth += 1
            cur.append(c)
        elif c == ")":
            depth -= 1
            cur.append(c)
        elif c == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    out.append("".join(cur))
    return out


def parse_asm(name: str, header: str = HEADER) -> dict:
    """The one asm statement of function `name` -> {"instrs": [(opcode,
    [operand, ...]), ...], "outputs": [(constraint, expr)], "inputs":
    [(constraint, expr)]}."""
    body = _function_body(name, header)
    starts = [m.end() for m in re.finditer(r"\basm\(", body)]
    assert len(starts) == 1, f"{name}: {len(starts)} asm statements"
    depth, i = 1, starts[0]
    while depth:
        depth += {"(": 1, ")": -1}.get(body[i], 0)
        i += 1
    parts = _split_top(body[starts[0]:i - 1], ":")
    text = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', parts[0]))
    text = text.replace("\\n", "\n").replace("\\t", "\t")
    instrs = []
    for line in text.split(";"):
        line = line.strip()
        if line:
            op, args = line.split(None, 1)
            instrs.append((op, [a.strip() for a in args.split(",")]))

    def operands(part):
        out = []
        for item in _split_top(part, ","):
            m = re.fullmatch(r'\s*"([=+]?r)"\((.*)\)\s*', item, re.S)
            assert m, (name, item)
            out.append((m.group(1), m.group(2).strip()))
        return out

    return {"instrs": instrs, "outputs": operands(parts[1]),
            "inputs": operands(parts[2])}


STATEMENTS = ("ptx_mul_row", "ptx_row", "ptx_reduce", "ptx_red_p",
              "ptx_red_row", "ptx_red_25519")
ASM = {name: parse_asm(name) for name in STATEMENTS}


def header_words(pattern: str) -> list:
    """Every 0x... constant of the first match of pattern, in order."""
    m = re.search(pattern, HEADER, re.S)
    assert m, pattern
    return [int(w.rstrip("u"), 16) for w in re.findall(r"0x[0-9A-Fa-f]+u?",
                                                       m.group(0))]


def limbs32(x: int) -> list:
    return [(x >> (32 * j)) & M32 for j in range(8)]


def value(w) -> int:
    return sum(int(v) << (32 * j) for j, v in enumerate(w))


# p's words as mul_p spells them (0u and 1u are not hex there)
P_WORDS = [0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0, 0, 0, 1, 0xFFFFFFFF]
P25519_WORDS = header_words(r"mul_25519\(uint32_t r.*?pw\[8\] = \{.*?\};")
F25519_MINV = int(re.search(
    r"#define F25519_MINV (0x[0-9A-F]+)u",
    (CSRC / "p256_field.cuh").read_text()).group(1), 16)
MWORDS = header_words(r"ptx_mword\(int j\) \{.*?\n\}")
N_WORDS, BN_WORDS = MWORDS[:8], MWORDS[8:]
MINV = {F.N: (-pow(F.N, -1, 1 << 32)) % (1 << 32),
        F.BN254: (-pow(F.BN254, -1, 1 << 32)) % (1 << 32)}


# ---------------------------------------------------------------------------
# The instruction model: 32-bit registers and the carry flag CC.CF
# ---------------------------------------------------------------------------

class Fault:
    """Drop the carry (or borrow) into instruction `index` of statement
    `name`: it reads CC.CF as 0."""

    def __init__(self, name=None, index=None):
        self.name, self.index = name, index


NO_FAULT = Fault()


class View:
    """t + off, as C's pointer arithmetic on a word array."""

    def __init__(self, base: list, off: int):
        self.base, self.off = base, off

    def __getitem__(self, j):
        return self.base[self.off + j]

    def __setitem__(self, j, v):
        self.base[self.off + j] = v


def _lvalue(expr: str, env: dict):
    m = re.fullmatch(r"(\w+)\[(\d+)\]", expr)
    if m:
        return env[m.group(1)], int(m.group(2))
    assert re.fullmatch(r"\w+", expr), expr
    return env, expr


def run_asm(name: str, env: dict, fault: Fault = NO_FAULT,
            asm: dict = ASM) -> None:
    """Run the asm statement of function `name` (parsed into `asm`) on
    the C variables in env (lists, Views or ints), writing its outputs
    back into them."""
    st = asm[name]
    ops = st["outputs"] + st["inputs"]
    regs = []
    for cons, expr in ops:
        if cons.startswith("="):
            regs.append(None)                  # write-only: no value yet
        else:
            regs.append(eval(expr, {}, env) & M32)
    cf = None                                  # undefined at entry

    def val(tok):
        if tok.startswith("%"):
            v = regs[int(tok[1:])]
            assert v is not None, f"{name}: {tok} read before written"
            return v
        return int(tok, 0)

    for k, (op, args) in enumerate(st["instrs"]):
        parts = op.split(".")
        base, cc = parts[0], "cc" in parts
        reads_cf = base in ("addc", "subc", "madc")
        if reads_cf:
            assert cf is not None, f"{name}: {op} reads an undefined carry"
            cin = 0 if (fault.name == name and fault.index == k) else cf
        else:
            cin = 0
        d = int(args[0][1:])
        src = [val(a) for a in args[1:]]
        if base in ("add", "addc"):
            s = src[0] + src[1] + cin
            out_cf = s >> 32
        elif base in ("sub", "subc"):
            s = src[0] - src[1] - cin
            out_cf = 1 if s < 0 else 0
        elif base in ("mad", "madc"):
            prod = src[0] * src[1]
            half = prod & M32 if "lo" in parts else prod >> 32
            s = half + src[2] + cin
            out_cf = s >> 32
        else:
            raise AssertionError(f"{name}: no model for {op}")
        assert parts[-1] == "u32", op
        regs[d] = s & M32
        if cc:
            cf = out_cf
    for (cons, expr), v in zip(st["outputs"], regs):
        assert v is not None, f"{name}: output {expr} never written"
        obj, key = _lvalue(expr, env)
        obj[key] = v


# ---------------------------------------------------------------------------
# The C around the asm, statement for statement
# ---------------------------------------------------------------------------

def ptx_mul_row(t, ai, b, fault=NO_FAULT):
    run_asm("ptx_mul_row", {"t": t, "ai": ai, "b": b}, fault)


def ptx_row(t, ai, b, fault=NO_FAULT):
    run_asm("ptx_row", {"t": t, "ai": ai, "b": b}, fault)


def ptx_reduce(r, t, hi, m, fault=NO_FAULT):
    d = [t[j] for j in range(8)]
    env = {"d": d, "bw": hi, "m": m}
    run_asm("ptx_reduce", env, fault)
    bw = env["bw"]
    vals = [t[j] if bw else d[j] for j in range(8)]
    for j in range(8):
        r[j] = vals[j]


def ptx_red_p(t, c_in, fault=NO_FAULT):
    q = t[0]
    lo = (0 - q) & M32
    hi = (q - (q != 0) + c_in) & M32
    env = {"t": t, "q": q, "lo": lo, "hi": hi, "c": None}
    run_asm("ptx_red_p", env, fault)
    return env["c"]


def ptx_red_25519(t, c_in, fault=NO_FAULT):
    q = (t[0] * F25519_MINV) & M32
    uh = (q * 19) >> 32                        # __umulhi(q, 19u)
    b = 1 if uh != 0 else 0
    w0 = (0 - uh) & M32
    wm = (0 - b) & M32
    v = ((q << 31) - b) & ((1 << 64) - 1)
    w6 = v & M32
    w7 = ((v >> 32) + c_in) & M32
    env = {"t": t, "w0": w0, "wm": wm, "w6": w6, "w7": w7, "c": None}
    run_asm("ptx_red_25519", env, fault)
    return env["c"]


def mul_25519(r, a, b, fault=NO_FAULT):
    pw = list(P25519_WORDS)
    t = [0] * 16
    for i in range(8):
        ptx_mul_row(View(t, i), a[i], b, fault)
    c = 0
    for i in range(8):
        c = ptx_red_25519(View(t, i), c, fault)
    ptx_reduce(r, View(t, 8), c, pw, fault)


def mul_p(r, a, b, fault=NO_FAULT):
    pw = list(P_WORDS)
    t = [0] * 17
    for i in range(8):
        ptx_mul_row(View(t, i), a[i], b, fault)
    c = 0
    for i in range(8):
        c = ptx_red_p(View(t, i), c, fault)
    assert t[16] == 0
    ptx_reduce(r, View(t, 8), c, pw, fault)


def sqr_p(r, a, fault=NO_FAULT):
    mul_p(r, a, a, fault)


def ptx_red_row(t, q, m, fault=NO_FAULT):
    run_asm("ptx_red_row", {"t": t, "q": q, "m": m}, fault)


def mont_mul_ptx(modulus, r, a, b, fault=NO_FAULT):
    m = list(N_WORDS if modulus == F.N else BN_WORDS)
    t = [0] * 10
    for i in range(8):
        ptx_row(t, a[i], b, fault)
        ptx_red_row(t, (t[0] * MINV[modulus]) & M32, m, fault)
        assert t[0] == 0
        for j in range(9):
            t[j] = t[j + 1]
    ptx_reduce(r, t, t[8], m, fault)


def mont_inv_ptx(modulus, r, a):
    x, acc = list(a), list(a)
    for i in range(252 if modulus == F.BN254 else 254, -1, -1):
        mont_mul_ptx(modulus, acc, acc, acc)
        w = (modulus >> (32 * (i >> 5)) & M32) - (2 if i < 32 else 0)
        if (w >> (i & 31)) & 1:
            mont_mul_ptx(modulus, acc, acc, x)
    r[:] = acc


def emulate(op: str, a: int, b: int, fault=NO_FAULT) -> int:
    """One probe op on ints through the model (r a separate array)."""
    r = [0] * 8
    if op == "mul_p":
        mul_p(r, limbs32(a), limbs32(b), fault)
    elif op == "sqr_p":
        sqr_p(r, limbs32(a), fault)
    elif op == "mul_25519":
        mul_25519(r, limbs32(a), limbs32(b), fault)
    else:
        mont_mul_ptx(F.N if op == "mul_n" else F.BN254, r, limbs32(a),
                     limbs32(b), fault)
    return value(r)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

OPS = ("mul_p", "sqr_p", "mul_n", "mul_bn254", "mul_25519")
MOD = {"mul_p": F.P, "sqr_p": F.P, "mul_n": F.N, "mul_bn254": F.BN254,
       "mul_25519": F.P25519}


def seeded(op: str, count: int, seed: int) -> tuple:
    """count random (a, b) within op's preconditions (a < 2^256, b < m;
    sqr_p a < p), from numpy's generator."""
    rng = np.random.default_rng(seed)
    m = MOD[op]

    def draw(bound):
        return int.from_bytes(rng.bytes(32), "big") % bound

    a = [draw(m if op == "sqr_p" else R) for _ in range(count)]
    b = a if op == "sqr_p" else [draw(m) for _ in range(count)]
    return a, b


def edges(op: str) -> tuple:
    if op == "mul_bn254":
        m = F.BN254
        rinv = pow(R, -1, m)
        a = [0, 1, m - 1, TOP, m, TOP - 1, rinv, (m - 1) * rinv % m,
             (1 << 224) - 1]
        b = [m - 1, m - 1, m - 1, m - 1, 5, 1, R * R % m, R * R % m, m - 1]
        return a, b
    return p256.field_probe_edges(op)


def cases(op: str, count: int = 300, seed: int = 0) -> list:
    ea, eb = edges(op)
    ra, rb = seeded(op, count, seed + OPS.index(op))
    return list(zip(ea + ra, eb + rb))


def want(op: str, a: int, b: int) -> int:
    m = MOD[op]
    return a * (a if op == "sqr_p" else b) * pow(R, -1, m) % m


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_header_constants_are_the_moduli():
    assert value(P_WORDS) == F.P
    assert value(N_WORDS) == F.N
    assert value(BN_WORDS) == F.BN254
    assert value(P25519_WORDS) == F.P25519
    assert (F25519_MINV * 19) % (1 << 32) == 1        # -p^-1 = 19^-1
    pw = header_words(r"pw\[8\] = \{.*?\};")
    assert [w for w in pw] == [w for w in P_WORDS if w not in (0, 1)]
    field_h = (CSRC / "p256_field.cuh").read_text()
    for macro, m in (("P256_N_MINV", F.N), ("BN254_MINV", F.BN254),
                     ("P256_P_MINV", F.P)):
        got = int(re.search(r"#define %s (0x[0-9A-F]+)u" % macro,
                            field_h).group(1), 16)
        assert got == (-pow(m, -1, 1 << 32)) % (1 << 32)


def test_every_chain_is_whole_in_one_statement():
    """Each statement starts without a carry-in and reads CC.CF only
    after an instruction of its own wrote it (the model asserts both
    while it runs; this names where the chains start)."""
    for name, st in ASM.items():
        first = st["instrs"][0][0]
        assert not first.startswith(("addc", "subc", "madc")), name
        assert first.endswith(".cc.u32"), name


@pytest.mark.parametrize("op", OPS)
def test_emulation_matches_ints(op):
    m = MOD[op]
    for a, b in cases(op):
        got = emulate(op, a, b)
        assert got == want(op, a, b), (op, hex(a), hex(b))
        assert 0 <= got < m


@pytest.mark.parametrize("op", ["mul_p", "mul_n", "mul_25519"])
def test_emulation_aliasing(op):
    """r aliasing a, b, or both (pt_dbl's fp_mul(x, x, y), the Fermat
    chain's acc = acc * acc): the result is the same."""
    m = MOD[op]
    run = {"mul_p": mul_p, "mul_25519": mul_25519}.get(
        op, lambda r, a, b: mont_mul_ptx(F.N, r, a, b))
    for a, b in cases(op, 40, seed=7):
        x, y = limbs32(a), limbs32(b)
        run(x, x, y)
        assert value(x) == want(op, a, b)
        x, y = limbs32(a), limbs32(b)
        run(y, x, y)
        assert value(y) == want(op, a, b)
        if b < m and a < m:
            y = limbs32(b)
            run(y, y, y)
            assert value(y) == b * b * pow(R, -1, m) % m


def test_emulated_fermat_inverse_mod_n():
    for s in (3, F.N - 2):
        sm = limbs32(s * R % F.N)
        r = [0] * 8
        mont_inv_ptx(F.N, r, sm)
        assert value(r) == pow(s, -1, F.N) * R % F.N


# one site in each chain of each statement: the rows' low chains, their
# carry into t[8] and their high chains, the reduction step mod p, the
# CIOS q m row's two chains and its top carries, the conditional
# subtraction's borrow chain and its last word.  (Every carry-in of the
# header is caught by these inputs but one: ptx_row's carry out of t[8],
# which needs t + a_i b >= 2^288, i.e. t within ~2^192 of 2n with a_i =
# 2^32 - 1 and b near n; it is kept for such inputs and none is seeded.)
DROP_SITES = [("ptx_mul_row", 3), ("ptx_mul_row", 8), ("ptx_mul_row", 14),
              ("ptx_mul_row", 16), ("ptx_row", 3), ("ptx_row", 8),
              ("ptx_row", 14), ("ptx_red_p", 2), ("ptx_red_p", 5),
              ("ptx_red_p", 6), ("ptx_red_row", 4), ("ptx_red_row", 8),
              ("ptx_red_row", 9), ("ptx_red_row", 15), ("ptx_red_row", 18),
              ("ptx_reduce", 1), ("ptx_reduce", 7), ("ptx_reduce", 8),
              # mod p25519: W's borrow words (-uh's borrow carried up), its
              # q << 31 and q >> 1 words, and the carry out of t[8]
              ("ptx_red_25519", 1), ("ptx_red_25519", 3),
              ("ptx_red_25519", 5), ("ptx_red_25519", 6),
              ("ptx_red_25519", 7), ("ptx_red_25519", 8)]
OPS_OF = {"ptx_mul_row": ("mul_p", "sqr_p", "mul_25519"),
          "ptx_red_p": ("mul_p", "sqr_p"),
          "ptx_red_25519": ("mul_25519",),
          "ptx_row": ("mul_n", "mul_bn254"),
          "ptx_red_row": ("mul_n", "mul_bn254"), "ptx_reduce": OPS}


@pytest.mark.parametrize("name,index", DROP_SITES)
def test_dropped_carry_is_caught(name, index):
    """With the carry into one instruction dropped, some input of the
    test set gives a wrong result: the check above can catch a lost
    carry at this site."""
    fault = Fault(name, index)
    assert ASM[name]["instrs"][index][0].split(".")[0] in (
        "addc", "subc", "madc")
    for op in OPS_OF[name]:
        for a, b in cases(op, 200):
            if emulate(op, a, b, fault) != want(op, a, b):
                return
    pytest.fail(f"dropping the carry into {name}[{index}] went unseen")


@pytest.mark.parametrize("op", p256.FIELD_PROBE_OPS)
def test_probe_cpu_path_matches_ints_and_emulation(op):
    m = MOD[op]
    pairs = cases(op, 500, seed=11)
    va = [a for a, _ in pairs]
    vb = [b for _, b in pairs]
    a = F.ints_to_words_le(va)
    b = None if op == "sqr_p" else F.ints_to_words_le(vb)
    before = p256.p256_field_probe.launches
    got = F.words_le_to_ints(p256.p256_field_probe(op, a, b))
    assert p256.p256_field_probe.launches == before    # the CPU counts none
    assert got == [want(op, x, y) for x, y in pairs]
    assert all(0 <= g < m for g in got)
    assert got[:60] == [emulate(op, x, y) for x, y in pairs[:60]]


@pytest.mark.parametrize("op", ["mul_p", "mul_n", "sqr_p", "mul_25519"])
def test_probe_matches_reference_mont(op):
    """The reference's Montgomery multiply (`bignum.Mont`, R = 2^264)
    on the same seeded inputs: Mont(a, b) = probe(a, b 2^-8 mod m); for
    sqr_p, which takes a alone, Mont(a, a) 2^8 = probe(a)."""
    m = MOD[op]
    va, vb = seeded(op, 64, seed=21)
    va = [x % m for x in va]
    if op == "sqr_p":
        vb = va
    mont = bn.Mont(m, "ref")
    ref = jax.jit(mont.mul)(jnp.asarray(bn.ints_to_limbs(va)),
                            jnp.asarray(bn.ints_to_limbs(vb)))
    ref = [v % m for v in bn.limbs_to_ints(np.asarray(ref))]
    if op == "sqr_p":
        got = p256.p256_field_probe(op, F.ints_to_words_le(va))
        assert F.words_le_to_ints(got) == [v * 256 % m for v in ref]
        return
    inv8 = pow(1 << 8, -1, m)
    got = p256.p256_field_probe(
        op, F.ints_to_words_le(va),
        F.ints_to_words_le([y * inv8 % m for y in vb]))
    assert F.words_le_to_ints(got) == ref


def test_probe_rejects_bad_inputs():
    a = F.ints_to_words_le([1, 2])
    with pytest.raises(ValueError):
        p256.p256_field_probe("mul_q", a, a)
    with pytest.raises(ValueError):
        p256.p256_field_probe("sqr_p", a, a)
    with pytest.raises(ValueError):
        p256.p256_field_probe("mul_p", a)
    with pytest.raises(ValueError):
        p256.p256_field_probe("mul_p", a, a[:1].contiguous())
    with pytest.raises(ValueError):
        p256.p256_field_probe("mul_p", a.to(torch.int64), a)
