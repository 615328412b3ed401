"""Edwards25519 point arithmetic in plain PyTorch: the plain versions of
the point code the Ed25519 kernels KE5 and KE6 inline
(`csrc/edwards_point.cuh`).

Counterpart of `fabric_tpu/ops/edwards.py` (`add`, `dbl`, `add_niels`,
`neg`, `comb_digits_signed`, `comb_accumulate`, `comb_accumulate_rows`,
`ladder_digits`, `windowed_mul`, `decompress`, `batch_zinv`,
`compressed_equals`), on the port's field layer (`ops/field.py`): every
coordinate is a (16, B) int64 tensor of 16-bit limbs holding the
Montgomery form x * 2^256 mod p, p = 2^255 - 19, fully reduced after
every operation.  The reference keeps lazily reduced 22 x 12-bit limbs
with R = 2^264; the values, and so the verdicts, are the same.

Points are extended homogeneous coordinates (X : Y : Z : T), x = X/Z,
y = Y/Z, T = XY/Z, on -x^2 + y^2 = 1 + d x^2 y^2.  The unified add
(add-2008-hwcd-3) and the doubling (dbl-2008-hwcd) are complete for
a = -1 and non-square d: no case splits, no infinity flag.  Comb table
entries are "niels" triples (y - x, y + x, 2dxy); the identity's is
(1, 1, 0), so digit 0 needs no masking, and a negative signed digit
swaps the first two and negates the third.

Two things differ from the reference by design: Z^-1 is a Fermat chain
per signature (`zinv`) where the reference inverts a batch with a
product tree, and the fixed exponents (p - 2 and (p - 5) / 8) run
ref10's addition chains instead of binary square-and-multiply.  Both
give the same values.
"""

from __future__ import annotations

import torch

from .field import P25519 as P
from .field import f25519 as fq
from .field import is_zero_limbs, lt_const, words_le_to_limbs

L = 2**252 + 27742317777372353535851937790883648493   # group order
D = (-121665 * pow(121666, -1, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)                     # sqrt(-1) mod p
BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
BY = 46316835694926478169428394003475163141307993866256225615783033603165251855960

COMB_W = 7
COMB_WINDOWS = 37              # 37 * 7 = 259 >= 253, room for the carry
COMB_ROWS = 65                 # |digit| in 0..64; row 0 = identity niels
ROWS = COMB_WINDOWS * COMB_ROWS
ROW_WORDS = 24                 # (y - x, y + x, 2dxy), 8 words each
LADDER_W = 4
LADDER_WINDOWS = 64
LADDER_ENTRIES = 1 << LADDER_W


# ---------------------------------------------------------------------------
# Fixed-exponent chains (ref10's fe_invert / fe_pow22523)
# ---------------------------------------------------------------------------

def _sqr_n(sqr, t, n):
    for _ in range(n):
        t = sqr(t)
    return t


def _pow_2_250_1(mul, sqr, z):
    """-> (z^(2^250 - 1), z^11): the head both chains share."""
    t0 = sqr(z)                                   # 2
    t1 = mul(z, _sqr_n(sqr, t0, 2))               # 9
    z11 = mul(t0, t1)                             # 11
    t1 = mul(t1, sqr(z11))                        # 2^5 - 1
    t1 = mul(_sqr_n(sqr, t1, 5), t1)              # 2^10 - 1
    t2 = mul(_sqr_n(sqr, t1, 10), t1)             # 2^20 - 1
    t2 = mul(_sqr_n(sqr, t2, 20), t2)             # 2^40 - 1
    t1 = mul(_sqr_n(sqr, t2, 10), t1)             # 2^50 - 1
    t2 = mul(_sqr_n(sqr, t1, 50), t1)             # 2^100 - 1
    t2 = mul(_sqr_n(sqr, t2, 100), t2)            # 2^200 - 1
    t1 = mul(_sqr_n(sqr, t2, 50), t1)             # 2^250 - 1
    return t1, z11


def inv_chain(mul, sqr, z):
    """z^(p - 2) = z^(2^255 - 21): 254 squares, 11 multiplies."""
    t, z11 = _pow_2_250_1(mul, sqr, z)
    return mul(_sqr_n(sqr, t, 5), z11)


def pow22523_chain(mul, sqr, z):
    """z^((p - 5) / 8) = z^(2^252 - 3): 251 squares, 11 multiplies."""
    t, _ = _pow_2_250_1(mul, sqr, z)
    return mul(_sqr_n(sqr, t, 2), z)


def chain_ops(chain) -> dict:
    """{"mul": m, "sqr": s} of a chain, counted by running it on ints."""
    n = {"mul": 0, "sqr": 0}

    def mul(a, b):
        n["mul"] += 1
        return a * b % P

    def sqr(a):
        n["sqr"] += 1
        return a * a % P

    chain(mul, sqr, 2)
    return n


def zinv(Z):
    """Z^-1 (Montgomery in and out) per element by the Fermat chain;
    zinv(0) = 0."""
    return inv_chain(fq.mul, fq.sqr, Z)


# ---------------------------------------------------------------------------
# Extended-coordinate point ops
# ---------------------------------------------------------------------------

def identity(like):
    zero = torch.zeros_like(like)
    one = fq.one_bc(like)
    return zero, one, one.clone(), zero.clone()


def from_affine(x_m, y_m):
    return x_m, y_m, fq.one_bc(x_m), fq.mul(x_m, y_m)


def neg(pt):
    X, Y, Z, T = pt
    zero = torch.zeros_like(X)
    return fq.sub(zero, X), Y, Z, fq.sub(zero, T)


def add(p, q):
    """Complete unified addition (add-2008-hwcd-3, a = -1); 9 multiplies."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = fq.mul(fq.sub(Y1, X1), fq.sub(Y2, X2))
    B = fq.mul(fq.add(Y1, X1), fq.add(Y2, X2))
    C = fq.mul(fq.mul(T1, fq.const_mont(2 * D, X1)), T2)
    Dv = fq.mul(Z1, Z2)
    Dv = fq.add(Dv, Dv)
    E, F, G, H = fq.sub(B, A), fq.sub(Dv, C), fq.add(Dv, C), fq.add(B, A)
    return fq.mul(E, F), fq.mul(G, H), fq.mul(F, G), fq.mul(E, H)


def dbl(p):
    """Doubling (dbl-2008-hwcd, a = -1), complete; 4 squares and 4
    multiplies."""
    X1, Y1, Z1, _ = p
    A = fq.sqr(X1)
    B = fq.sqr(Y1)
    C = fq.sqr(Z1)
    C = fq.add(C, C)
    H = fq.add(A, B)
    E = fq.sub(H, fq.sqr(fq.add(X1, Y1)))
    G = fq.sub(A, B)
    F = fq.add(C, G)
    return fq.mul(E, F), fq.mul(G, H), fq.mul(F, G), fq.mul(E, H)


def add_niels(p, e0, e1, e2):
    """Mixed add of a niels entry (y - x, y + x, 2dxy); 7 multiplies.  The
    identity entry (1, 1, 0) flows through unmasked."""
    X1, Y1, Z1, T1 = p
    A = fq.mul(fq.sub(Y1, X1), e0)
    B = fq.mul(fq.add(Y1, X1), e1)
    C = fq.mul(T1, e2)
    Dv = fq.add(Z1, Z1)
    E, F, G, H = fq.sub(B, A), fq.sub(Dv, C), fq.add(Dv, C), fq.add(B, A)
    return fq.mul(E, F), fq.mul(G, H), fq.mul(F, G), fq.mul(E, H)


# ---------------------------------------------------------------------------
# Signed comb and windowed ladder
# ---------------------------------------------------------------------------

def comb_digits_signed(u):
    """(16, B) canonical limbs -> 37 (B,) int64 signed digits in
    [-64, 64], LSB-first: u = sum d_j 2^(7j) for u < 2^253; the carry out
    of the last window is dropped, as in the reference."""
    out = []
    carry = torch.zeros_like(u[0])
    for j in range(COMB_WINDOWS):
        pos = COMB_W * j
        limb, off = pos // 16, pos % 16
        v = u[limb] >> off
        if off > 16 - COMB_W and limb + 1 < 16:
            v = v | (u[limb + 1] << (16 - off))
        v = (v & ((1 << COMB_W) - 1)) + carry
        hi = v >= (1 << (COMB_W - 1))
        out.append(torch.where(hi, v - (1 << COMB_W), v))
        carry = hi.to(v.dtype)
    return out


def _niels(rows, negd):
    """(B, 24) int64 table rows and (B,) bool -> the signed entry."""
    e0 = words_le_to_limbs(rows[:, 0:8])
    e1 = words_le_to_limbs(rows[:, 8:16])
    e2 = words_le_to_limbs(rows[:, 16:24])
    e2n = fq.sub(torch.zeros_like(e2), e2)
    return (torch.where(negd, e1, e0), torch.where(negd, e0, e1),
            torch.where(negd, e2n, e2))


def comb_accumulate(table, u):
    """u * T over T's (2405, 24) uint32 niels comb table: row
    j*65 + m = niels(m * 2^(7j) * T), row j*65 = identity."""
    flat = table.view(torch.int32)
    acc = identity(u)
    for j, d in enumerate(comb_digits_signed(u)):
        rows = flat[j * COMB_ROWS + d.abs()].to(torch.int64) & 0xFFFFFFFF
        acc = add_niels(acc, *_niels(rows, d < 0))
    return acc


def comb_accumulate_rows(bank, slot, u):
    """u * T_slot per signature, each over its own table of the
    (K, 2405, 24) bank."""
    flat = bank.view(torch.int32).reshape(-1, ROW_WORDS)
    base = slot.to(torch.int64) * ROWS
    acc = identity(u)
    for j, d in enumerate(comb_digits_signed(u)):
        rows = flat[base + j * COMB_ROWS + d.abs()].to(torch.int64) \
            & 0xFFFFFFFF
        acc = add_niels(acc, *_niels(rows, d < 0))
    return acc


def ladder_digits(u):
    """-> 64 (B,) int64 4-bit digits, MSB-first."""
    return [(u[w // 4] >> (4 * (w % 4))) & 0xF
            for w in range(LADDER_WINDOWS - 1, -1, -1)]


def windowed_mul(u, q):
    """u * Q by the 4-bit window ladder over Q's 16-entry table (identity,
    Q, 2Q, ...), 4 doublings and one complete add per window."""
    tab = [identity(q[0]), q, dbl(q)]
    for _ in range(3, LADDER_ENTRIES):
        tab.append(add(tab[-1], q))
    cols = [torch.stack([t[c] for t in tab]) for c in range(4)]  # (16,16,B)
    acc = identity(q[0])
    for d in ladder_digits(u):
        for _ in range(LADDER_W):
            acc = dbl(acc)
        idx = d.reshape(1, 1, -1).expand(1, cols[0].shape[1], -1)
        acc = add(acc, tuple(c.gather(0, idx)[0] for c in cols))
    return acc


# ---------------------------------------------------------------------------
# Decompression and the recompression compare
# ---------------------------------------------------------------------------

def decompress(y, sign):
    """RFC 8032 5.1.3 decompression, batched: y (16, B) canonical limbs
    (< 2^255), sign (B,) 0/1 -> ((x_m, y_m), ok).  ok is False for
    y >= p, for a y with no x, and for x = 0 with sign 1; the point of a
    lane that is not ok is garbage and its verdict is False."""
    y_ok = lt_const(y, P)
    y_m = fq.to_mont(y)
    one = fq.one_bc(y_m)
    y2 = fq.sqr(y_m)
    u = fq.sub(y2, one)                               # y^2 - 1
    v = fq.add(fq.mul(y2, fq.const_mont(D, y_m)), one)  # d y^2 + 1
    v3 = fq.mul(fq.sqr(v), v)
    v7 = fq.mul(fq.sqr(v3), v)
    pw = pow22523_chain(fq.mul, fq.sqr, fq.mul(u, v7))
    x = fq.mul(fq.mul(u, v3), pw)                     # u v^3 (u v^7)^((p-5)/8)
    vx2 = fq.mul(v, fq.sqr(x))
    root_ok = fq.eq(vx2, u)
    root_neg = fq.eq(vx2, fq.sub(torch.zeros_like(u), u))
    x = torch.where(root_neg, fq.mul(x, fq.const_mont(SQRT_M1, x)), x)
    ok = y_ok & (root_ok | root_neg)
    x_can = fq.from_mont(x)
    x_zero = is_zero_limbs(x_can)
    ok = ok & ~(x_zero & (sign == 1))
    flip = ((x_can[0] & 1) != sign) & ~x_zero
    x = torch.where(flip, fq.sub(torch.zeros_like(x), x), x)
    return (x, y_m), ok


def compressed_equals(pt, y, sign, z_inv):
    """Does the point equal the encoding (y, sign)?  y (16, B) canonical
    limbs; non-canonical y (>= p) never matches, nor does sign 1 with
    x = 0.  z_inv: Montgomery Z^-1 from `zinv`."""
    X, Y, _, _ = pt
    x_aff = fq.from_mont(fq.mul(X, z_inv))
    y_aff = fq.from_mont(fq.mul(Y, z_inv))
    return lt_const(y, P) & fq.eq(y_aff, y) & ((x_aff[0] & 1) == sign)
