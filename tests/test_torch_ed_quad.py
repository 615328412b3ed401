"""A CPU model of the quad layout of KE5 and KE6
(fabric_tpu_torch/ops/csrc/edwards_point.cuh): one signature on four
neighbouring lanes of a warp, lane j holding coordinate j of (X, Y, Z, T),
a point operation as two steps of one multiply a lane with shuffles
inside the quad between them.

The model runs a warp of 32 lanes, lane by lane and step by step.  The
straight-line point routines (quad_add, quad_dbl, quad_cached and
quad_finish) are read from the kernel's source and interpreted statement
by statement: each declaration is evaluated on every lane, its C
conditionals translated, and each `quad_read(var, src)` reads var from
lane src of the reading lane's quad, as __shfl_sync with the width the
source gives does.  So which lane multiplies what, and which lane each
shuffle reads, come from the kernel.  The ladder's cached table, its
signed lookup and the comb's column choice use the expressions the source
spells; the block's gated Z^-1 (Montgomery's trick over 4 warps) is
modelled step for step with its shuffle distances.  Field values are
Python ints in Montgomery form (R = 2^256) mod p = 2^255 - 19, the
kernel's constants parsed from its source.

Held against the port's plain `edwards.add`, `dbl`, `add_niels` and the
reference's (`fabric_tpu.ops.edwards`, eagerly), value for value, on
seeded points, the identity and the 2-torsion point (0, -1); two
mutations of the source (a swapped shuffle source, a shuffle width that
reaches the neighbouring quad) are caught.  No JAX in the model; only the
reference side imports it."""
import random
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from fabric_tpu.ops import bignum as bn
from fabric_tpu.ops import edwards as ref_ed
from fabric_tpu_torch.ops import ed25519 as E
from fabric_tpu_torch.ops import edwards as ed
from fabric_tpu_torch.ops import field as F

SRC = (Path(E.__file__).parent / "csrc" / "edwards_point.cuh").read_text()
P = ed.P
R = 1 << 256
RINV = pow(R, -1, P)
WARP = 32


# ---------------------------------------------------------------------------
# The source, parsed
# ---------------------------------------------------------------------------

def body(src: str, name: str) -> str:
    """The body of function `name` (between its first { and the } at
    column 0)."""
    m = re.search(r"\b%s\([^)]*\)\s*\{" % re.escape(name), src)
    assert m, name
    end = src.index("\n}\n", m.end())
    return src[m.end():end]


def split_top(s: str, sep: str) -> list:
    out, depth, cur = [], 0, []
    for c in s:
        if c in "([":
            depth += 1
        elif c in ")]":
            depth -= 1
        if c == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    out.append("".join(cur))
    return out


def c2py(expr: str) -> str:
    """A C expression of the point routines -> Python: right-nested
    conditionals, &&, ||, !, and the u suffix of literals."""
    expr = expr.strip()
    depth, q = 0, None
    for i, c in enumerate(expr):
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif c == "?" and depth == 0:
            q = i
            break
    if q is None:
        return _plain_c2py(expr)
    depth, nest = 0, 0
    for k in range(q + 1, len(expr)):
        c = expr[k]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif depth == 0 and c == "?":
            nest += 1
        elif depth == 0 and c == ":":
            if nest == 0:
                return "(%s if %s else %s)" % (
                    c2py(expr[q + 1:k]), c2py(expr[:q]), c2py(expr[k + 1:]))
            nest -= 1
    raise AssertionError(f"unbalanced conditional: {expr}")


def _plain_c2py(expr: str) -> str:
    """An expression without a conditional at its top level: each
    parenthesised group's comma-separated parts translated on their own."""
    out, i = [], 0
    while i < len(expr):
        c = expr[i]
        if c != "(":
            out.append(c)
            i += 1
            continue
        depth, k = 1, i + 1
        while depth:
            depth += {"(": 1, ")": -1}.get(expr[k], 0)
            k += 1
        inner = expr[i + 1:k - 1]
        parts = [c2py(a) for a in split_top(inner, ",")] if inner.strip() \
            else []
        out.append("(" + ", ".join(parts) + ")")
        i = k
    text = re.sub(r"(\d+)u\b", r"\1", "".join(out))
    text = text.replace("&&", " and ").replace("||", " or ")
    return re.sub(r"!(?!=)", " not ", text)


def statements(fn_body: str) -> list:
    """[(name, C expression)] of the declarations, in order, and ("return",
    expression) last."""
    out = []
    for st in split_top(re.sub(r"//[^\n]*", "", fn_body), ";"):
        st = " ".join(st.split())
        if not st or st.startswith("#"):
            continue
        m = re.fullmatch(r"const (?:fe|int) (.*)", st)
        if m:
            for decl in split_top(m.group(1), ","):
                name, expr = decl.split("=", 1)
                out.append((name.strip(), expr.strip()))
            continue
        m = re.fullmatch(r"return (.*)", st)
        assert m, f"no model for the statement {st!r}"
        out.append(("return", m.group(1)))
    return out


def constants(src: str) -> dict:
    c = {}
    for name, words in re.findall(
            r"static __constant__ uint32_t (\w+)\[8\] = \{([^}]*)\}", src):
        ws = [int(w.strip().rstrip("u"), 16) for w in words.split(",")]
        c[name] = sum(w << (32 * i) for i, w in enumerate(ws))
    for name in ("fq_one", "fq_two"):
        m = re.search(r"fe %s\(\) \{ return fe_small\((\d+)u\); \}" % name,
                      src)
        c[name] = int(m.group(1))
    for name in ("COMB_WINDOWS", "COMB_ROWS", "ROW_WORDS", "LADDER_WINDOWS",
                 "LADDER_ENTRIES"):
        c[name] = int(re.search(r"\b%s = (\d+)," % name, src).group(1))
    m = re.search(r"QUAD_TAB_WORDS = LADDER_ENTRIES \* 4 \* 8 \+ (\d+)", src)
    c["QUAD_TAB_WORDS"] = c["LADDER_ENTRIES"] * 32 + int(m.group(1))
    m = re.search(r"__shfl_sync\(0xFFFFFFFFu, v\.w\[j\], src, (\d+)\)",
                  body(src, "quad_read"))
    c["width"] = int(m.group(1))
    return c


# ---------------------------------------------------------------------------
# The field and the warp
# ---------------------------------------------------------------------------

def fq_mul(a, b):
    assert 0 <= a < R and 0 <= b < P
    return a * b * RINV % P


class Model:
    """The kernel's point routines on a warp of WARP lanes, from `src`."""

    def __init__(self, src: str = SRC):
        self.c = constants(src)
        self.fns = {name: statements(body(src, name))
                    for name in ("quad_add", "quad_dbl", "quad_cached",
                                 "quad_finish")}
        self.params = {"quad_add": ("v", "c"), "quad_dbl": ("v",),
                       "quad_cached": ("v",),
                       "quad_finish": ("j", "E", "F", "G", "H")}
        lad = body(src, "quad_ladder")
        self.comp = c2py(re.search(r"const int comp = (.*?);", lad).group(1))
        self.e0 = c2py(re.search(r"const fe e0 = (.*?);", lad).group(1))
        comb = body(src, "quad_comb")
        self.col = c2py(re.search(r"const int col = (.*?);", comb).group(1))
        self.multiplies = 0

    def lane_env(self, j, env):
        c = self.c
        base = {
            "j": j, "fq_mul": self.mul, "fq_sqr": lambda a: self.mul(a, a),
            "fq_add": lambda a, b: (a + b) % P,
            "fq_sub": lambda a, b: (a - b) % P,
            "fq_neg": lambda a: (-a) % P,
            "fq_one": lambda: c["fq_one"], "fq_two": lambda: c["fq_two"],
            "fe_small": lambda k: k, "fe_of": lambda v: v,
            "fe_sel": lambda cond, a, b: a if cond else b,
            "quad_finish": lambda *a: self.call_lane("quad_finish", a),
            "quad_lane": lambda: j}
        base.update({k: v for k, v in c.items() if k.startswith("C_")})
        base.update(env)
        return base

    def mul(self, a, b):
        self.multiplies += 1
        return fq_mul(a, b)

    def call_lane(self, name, args):
        """A routine with no shuffles, on one lane."""
        env = dict(zip(self.params[name], args))
        for var, expr in self.fns[name]:
            val = eval(c2py(expr), {}, self.lane_env(env["j"], env))
            if var == "return":
                return val
            env[var] = val
        raise AssertionError(f"{name} returns nothing")

    def read(self, vals, lane, src):
        w = self.c["width"]
        return vals[(lane & ~(w - 1)) + (src % w)]

    def run(self, name, *args):
        """Routine `name` on the warp: args are per-lane lists."""
        envs = [dict(zip(self.params[name], [a[lane] for a in args]))
                for lane in range(WARP)]
        for var, expr in self.fns[name]:
            m = re.fullmatch(r"quad_read\((\w+), (.+)\)", expr)
            if m:
                src = c2py(m.group(2))
                vals = [e[m.group(1)] for e in envs]
                new = [self.read(vals, lane, eval(src, {}, self.lane_env(
                    lane & 3, envs[lane]))) for lane in range(WARP)]
            else:
                assert "quad_read" not in expr, expr
                new = [eval(c2py(expr), {}, self.lane_env(lane & 3, e))
                       for lane, e in enumerate(envs)]
            if var == "return":
                return new
            for e, v in zip(envs, new):
                e[var] = v
        raise AssertionError(f"{name} returns nothing")

    # the routines with loops, modelled on the parsed expressions

    def cached_lookup(self, table, mags, negs):
        """The ladder's signed lookup: lane j reads component `comp` of
        entry |d| of its quad's table, lane 3 negates when d < 0."""
        out = []
        for lane in range(WARP):
            j, q = lane & 3, lane >> 2
            env = {"neg": negs[q], "j": j}
            comp = eval(self.comp, {}, env)
            v = table[q][mags[q]][comp]
            out.append((-v) % P if negs[q] and j == 3 else v)
        return out

    def ladder_table(self, v):
        """The quad_ladder table build: entries 0 ... LADDER_ENTRIES - 1,
        per quad [entry][component]."""
        q1 = self.run("quad_cached", v)
        entries = [[eval(self.e0, {}, self.lane_env(lane & 3, {}))
                    for lane in range(WARP)], q1]
        p = v
        for e in range(2, self.c["LADDER_ENTRIES"]):
            p = self.run("quad_dbl", v) if e == 2 else self.run(
                "quad_add", p, q1)
            entries.append(self.run("quad_cached", p))
        return [[[entries[e][4 * q + j] for j in range(4)]
                 for e in range(self.c["LADDER_ENTRIES"])]
                for q in range(WARP // 4)]

    def niels_component(self, row, neg, lane):
        """Lane j's cached component of a signed niels row (y - x, y + x,
        2dxy) as quad_comb loads it: the word offset `col`, negated on
        lane 3, the constant 2 on lane 2."""
        j = lane & 3
        col = eval(self.col, {}, {"j": j, "neg": neg})
        v = row[col // 8]
        if j == 3 and neg:
            v = (-v) % P
        return self.c["fq_two"] if j == 2 else v


# ---------------------------------------------------------------------------
# Points
# ---------------------------------------------------------------------------

def ext_mul(k, pt):
    """k * pt on ints (affine double-and-add through extended coords)."""
    acc = (0, 1, 1, 0)
    for bit in bin(k)[2:]:
        acc = ext_add(acc, acc)
        if bit == "1":
            acc = ext_add(acc, pt)
    return acc


def ext_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * 2 * ed.D * t2 % P
    d = z1 * 2 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % P, g * h % P, f * g % P, e * h % P


B_EXT = (ed.BX, ed.BY, 1, ed.BX * ed.BY % P)
IDENTITY = (0, 1, 1, 0)
TORSION2 = (0, P - 1, 1, 0)                   # (0, -1), order 2


def points(n, seed):
    rng = random.Random(seed)
    pts = [ext_mul(rng.randrange(1, ed.L), B_EXT) for _ in range(n)]
    # a projective scaling, so that Z != 1 and T = XY/Z
    out = []
    for x, y, z, t in pts:
        s = rng.randrange(1, P)
        out.append((x * s % P, y * s % P, z * s % P, t * s % P))
    return out


def mont(v):
    return v * R % P


def lanes_of(pts):
    """8 points (one a quad) -> per-lane Montgomery coordinates."""
    assert len(pts) == WARP // 4
    return [mont(pts[lane >> 2][lane & 3]) for lane in range(WARP)]


def cached_of(pts):
    """Per-lane components of (Y - X, Y + X, 2Z, 2dT), Montgomery."""
    out = []
    for lane in range(WARP):
        x, y, z, t = pts[lane >> 2]
        out.append(mont([(y - x) % P, (y + x) % P, 2 * z % P,
                         2 * ed.D * t % P][lane & 3]))
    return out


def quads_of(vals):
    """Per-lane values -> per quad (X, Y, Z, T) as plain ints."""
    return [tuple(v * RINV % P for v in vals[4 * q:4 * q + 4])
            for q in range(WARP // 4)]


def port_plain(fn, *pts_lists):
    """The port's plain routine on the points (Montgomery limbs)."""
    args = [tuple(F.f25519.to_mont(F.ints_to_limbs([p[c] for p in pts]))
                  for c in range(4)) for pts in pts_lists]
    out = fn(*args)
    cols = [F.limbs_to_ints(F.f25519.from_mont(c)) for c in out]
    return [tuple(cols[c][i] for c in range(4)) for i in range(len(cols[0]))]


R264 = 1 << 264


def ref_cols(pts):
    return tuple(jnp.asarray(bn.ints_to_limbs([p[c] * R264 % P
                                               for p in pts]))
                 for c in range(4))


def ref_ints(col) -> list:
    """The reference's lazily reduced 12-bit limbs -> ints (a limb may
    exceed 12 bits, so they are added, not or-ed)."""
    arr = np.asarray(col).astype(np.int64)
    return [sum(int(arr[i, b]) << (12 * i) for i in range(arr.shape[0]))
            for b in range(arr.shape[1])]


def from_ref(out):
    cols = [[v * pow(R264, -1, P) % P for v in ref_ints(c)] for c in out]
    return [tuple(cols[c][i] for c in range(4)) for i in range(len(cols[0]))]


@pytest.fixture(scope="module")
def model():
    return Model()


@pytest.fixture(scope="module")
def pts():
    """Two warps' worth of points: seeded ones, the identity, the
    2-torsion point, B."""
    p = points(13, 5)
    return (p[:6] + [IDENTITY, TORSION2], p[6:12] + [TORSION2, B_EXT])


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_constants_parsed(model):
    c = model.c
    assert c["fq_one"] == R % P and c["fq_two"] == 2 * R % P
    assert c["C_ED_D2_MONT"] == 2 * ed.D * R % P
    assert (c["COMB_WINDOWS"], c["COMB_ROWS"], c["ROW_WORDS"]) == (
        ed.COMB_WINDOWS, ed.COMB_ROWS, ed.ROW_WORDS)
    assert c["LADDER_WINDOWS"] == ed.LADDER_WINDOWS
    assert c["LADDER_ENTRIES"] == E.LADDER_ENTRIES
    assert c["width"] == 4
    # the ladder table's stride puts the 8 quads of a warp, reading any
    # entry and component, on 32 different banks for every word
    stride = c["QUAD_TAB_WORDS"]
    for e in range(c["LADDER_ENTRIES"]):
        for w in range(8):
            banks = {(q * stride + (e * 4 + j) * 8 + w) % 32
                     for q in range(8) for j in range(4)}
            assert len(banks) == 32


def test_quad_add_matches_plain_and_reference(model, pts):
    p, q = pts
    model.multiplies = 0
    got = quads_of(model.run("quad_add", lanes_of(p), cached_of(q)))
    assert model.multiplies == 2 * WARP           # two steps, one a lane
    assert got == port_plain(ed.add, p, q)
    assert got == from_ref(ref_ed.add(ref_cols(p), ref_cols(q)))
    # and the sums are the points' sums
    assert [affine(g) for g in got] == [affine(ext_add(a, b))
                                        for a, b in zip(p, q)]


def test_quad_dbl_matches_plain_and_reference(model, pts):
    p, _ = pts
    model.multiplies = 0
    got = quads_of(model.run("quad_dbl", lanes_of(p)))
    assert model.multiplies == 2 * WARP
    assert got == port_plain(ed.dbl, p)
    assert got == from_ref(ref_ed.dbl(ref_cols(p)))


def test_quad_niels_add_matches_plain_and_reference(model, pts):
    """quad_add with each lane's component of a niels row as quad_comb
    loads it, both signs, against add_niels of the (negated) entry."""
    p, q = pts
    aff = [affine(x) for x in q]
    rows = [[mont((y - x) % P), mont((y + x) % P), mont(2 * ed.D * x * y % P)]
            for x, y in aff]
    for neg in (False, True):
        c = [model.niels_component(rows[lane >> 2], neg, lane)
             for lane in range(WARP)]
        got = quads_of(model.run("quad_add", lanes_of(p), c))
        e = [[(r[1] if neg else r[0]) * RINV % P for r in rows],
             [(r[0] if neg else r[1]) * RINV % P for r in rows],
             [(-r[2] if neg else r[2]) * RINV % P for r in rows]]
        lim = [F.f25519.to_mont(F.ints_to_limbs(col)) for col in e]
        plain = ed.add_niels(tuple(F.f25519.to_mont(F.ints_to_limbs(
            [x[c] for x in p])) for c in range(4)), *lim)
        cols = [F.limbs_to_ints(F.f25519.from_mont(col)) for col in plain]
        assert got == [tuple(cols[k][i] for k in range(4))
                       for i in range(len(p))]
        ref = ref_ed.add_niels(ref_cols(p), *[jnp.asarray(bn.ints_to_limbs(
            [v * R264 % P for v in col])) for col in e])
        assert got == from_ref(ref)
        sign = -1 if neg else 1
        assert [affine(g) for g in got] == [
            affine(ext_add(a, (sign * x % P, y, 1, sign * x * y % P)))
            for a, (x, y) in zip(p, aff)]


def affine(pt):
    x, y, z, _ = pt
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def test_ladder_table_and_signed_lookup(model, pts):
    """The cached table of 0Q ... 8Q (quad_cached after quad_dbl and
    quad_add) and its signed lookup: entry |d| with (Y - X, Y + X)
    swapped and 2dT negated is -|d|Q."""
    q, _ = pts
    table = model.ladder_table(lanes_of(q))
    n = model.c["LADDER_ENTRIES"]
    for quad, pt in enumerate(q):
        for e in range(n):
            x, y = affine(ext_mul(e, pt)) if e else (0, 1)
            zc = table[quad][e][2] * RINV % P * pow(2, -1, P) % P
            want = [(y - x) * zc, (y + x) * zc, 2 * zc,
                    2 * ed.D * x * y * zc]
            assert [v * RINV % P for v in table[quad][e]] == [
                w % P for w in want], (quad, e)
    rng = random.Random(3)
    for _ in range(4):
        mags = [rng.randrange(n) for _ in range(8)]
        negs = [rng.random() < 0.5 for _ in range(8)]
        got = model.cached_lookup(table, mags, negs)
        for quad, (m, neg) in enumerate(zip(mags, negs)):
            x, y = affine(ext_mul(m, q[quad])) if m else (0, 1)
            if neg:
                x = (-x) % P
            comps = [v * RINV % P for v in got[4 * quad:4 * quad + 4]]
            zc = comps[2] * pow(2, -1, P) % P
            assert comps == [(y - x) * zc % P, (y + x) * zc % P,
                             2 * zc % P, 2 * ed.D * x * y * zc % P]


def block_inv(zs, use, warps=E.BLOCK_WARPS):
    """quad_block_inv step for step on warps x 8 quads: per quad (Z,
    use) -> Z^-1 (Montgomery), with the warp's prefix and suffix products
    by shuffles of 4 d lanes, one thread's products over the warps and
    one Fermat chain, and the quad's four multiplies."""
    one = R % P
    nq = 8
    assert len(zs) == warps * nq
    v = [z if (u and z) else one for z, u in zip(zs, use)]
    out = []
    pres, sufs, tots = [], [], []
    for w in range(warps):
        pre, suf = list(v[w * nq:(w + 1) * nq]), list(v[w * nq:(w + 1) * nq])
        d = 1
        while d < nq:
            up = [pre[q - d] if q >= d else pre[q] for q in range(nq)]
            pre = [fq_mul(up[q], pre[q]) if q >= d else pre[q]
                   for q in range(nq)]
            dn = [suf[q + d] if q + d < nq else suf[q] for q in range(nq)]
            suf = [fq_mul(suf[q], dn[q]) if q + d < nq else suf[q]
                   for q in range(nq)]
            d <<= 1
        pres.append(pre)
        sufs.append(suf)
        tots.append(pre[nq - 1])
    after, acc = [0] * warps, one
    for w in range(warps - 1, -1, -1):
        after[w] = acc
        acc = fq_mul(tots[w], acc)
    before, acc = [0] * warps, one
    for w in range(warps):
        before[w] = acc
        acc = fq_mul(acc, tots[w])
    inv = inv_vartime(acc)[0]
    for w in range(warps):
        for q in range(nq):
            pre = one if q == 0 else pres[w][q - 1]
            suf = one if q == nq - 1 else sufs[w][q + 1]
            x = fq_mul(fq_mul(fq_mul(before[w], pre),
                              fq_mul(suf, after[w])), inv)
            out.append(0 if zs[w * nq + q] == 0 else x)
    return out


def inv_vartime(z):
    """fq_inv_vartime step for step: the binary extended Euclid on the
    integers, then one Montgomery multiply by R^3 mod p (parsed)."""
    r3 = int(re.search(r"fe_small\((\d+)u\)\);\n", body(
        SRC, "fq_inv_vartime")).group(1))
    assert r3 == R ** 3 % P
    u, v, x1, x2, steps = z, P, 1, 0, 0
    while True:
        while u % 2 == 0:
            u, x1 = u >> 1, (x1 + (P if x1 & 1 else 0)) >> 1
            steps += 1
        while v % 2 == 0:
            v, x2 = v >> 1, (x2 + (P if x2 & 1 else 0)) >> 1
            steps += 1
        if u == 1 or v == 1:
            return fq_mul(x1 if u == 1 else x2, r3), steps
        if u < v:
            v, x2 = v - u, (x2 - x1) % P
        else:
            u, x1 = u - v, (x1 - x2) % P
        steps += 1


def test_vartime_inverse_matches_fermat():
    rng = random.Random(12)
    for z in [1, 2, P - 1, R % P, (P - 1) // 2] + [rng.randrange(1, P)
                                                   for _ in range(40)]:
        got, steps = inv_vartime(z)
        assert got == pow(z * RINV, P - 2, P) * R % P       # (a^-1) R
        assert steps <= 3 * 256


def test_gated_block_inverse():
    """Every used quad with Z != 0 gets Z^-1; a quad past n or with its
    verdict already false brings 1, and one with Z = 0 gets 0: neither
    poisons the others."""
    rng = random.Random(9)
    n = E.BLOCK_WARPS * 8
    zs = [mont(rng.randrange(1, P)) for _ in range(n)]
    use = [True] * n
    zs[3] = 0                                  # garbage with Z = 0
    for k in (5, 17, 30, 31):                  # refused or past n
        use[k] = False
        zs[k] = rng.randrange(P)
    got = block_inv(zs, use)
    for z, u, g in zip(zs, use, got):
        if z == 0:
            assert g == 0
        elif u:
            assert fq_mul(z, g) == R % P       # z * z^-1 = 1


def test_source_block_inverse_shape():
    """The model's shuffle distances and steps are the source's."""
    b = body(SRC, "quad_block_inv")
    assert "for (int d = 1; d < 8; d <<= 1)" in b
    assert "__shfl_up_sync(0xFFFFFFFFu, t.w[k], 4 * d)" in b
    assert "__shfl_down_sync(0xFFFFFFFFu, t.w[k], 4 * d)" in b
    assert "__shfl_up_sync(0xFFFFFFFFu, pre.w[k], 4)" in b
    assert "fe_sel(use && !zero, z, fq_one())" in b
    assert "fe_sel(zero, fe_small(0u), w)" in b
    assert "acc = fq_inv_vartime(acc);" in b
    rows = (Path(E.__file__).parent / "csrc" /
            "ed25519_verify_rows.cu").read_text()
    assert "quad_block_inv<THREADS / 32>" in rows
    threads = int(re.search(r"constexpr int THREADS = (\d+)", rows).group(1))
    assert threads == 32 * E.BLOCK_WARPS


def test_chain_length_model():
    """ed25519.chain_muls counts the source's steps: two multiply
    latencies a point operation."""
    assert E.chain_muls("ed25519_verify_rows") == (
        4 * ed.COMB_WINDOWS + 6 + 2 * E.BLOCK_WARPS + 1 + 4 + 2)
    assert E.chain_muls("ed25519_verify") == (
        8 + 262 + 7 + 1 + 3 * (E.LADDER_ENTRIES - 2)
        + 2 * 64 + 8 * 63 + 2 * ed.COMB_WINDOWS + 1)


@pytest.mark.parametrize("mutation", ["swapped_source", "neighbour_quad"])
def test_mutation_is_caught(pts, mutation):
    """A copy of the source with one shuffle broken: the model built from
    it no longer matches the plain add."""
    p, q = pts
    if mutation == "swapped_source":
        src = SRC.replace("quad_read(r, 0), B = quad_read(r, 1)",
                          "quad_read(r, 1), B = quad_read(r, 0)")
    else:
        src = SRC.replace("v.w[j], src, 4)", "v.w[j], src, 8)")
    assert src != SRC
    got = quads_of(Model(src).run("quad_add", lanes_of(p), cached_of(q)))
    assert got != port_plain(ed.add, p, q)
