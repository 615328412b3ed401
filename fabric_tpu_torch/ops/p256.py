"""K2: generic ECDSA-P256 batch verification.

Counterpart of `fabric_tpu/ops/ecp256.py` (`verify_body`, `dbl`,
`add_nodbl`, `add_complete`, `add_mixed`, `comb_accumulate`,
`ladder_digits`, `comb_digits`, `_inv_n`, `verify_words_xla`) and of the
packing helpers of `fabric_tpu/ops/p256.py` (`bytes32_to_words`,
`ints_to_words`).

`verify_words(qx, qy, r, s, e)` takes (8, B) uint32 big-endian words (SEC1
byte order, the digest read as a big-endian integer) and returns (B,)
bool.  Semantics, shared by the kernel KP2 (`csrc/p256_verify.cu`) and
its plain PyTorch version `verify_words_plain` here:

* r and s in [1, n); with `require_low_s`, s < (n - 1) / 2 + 1;
* qx, qy < p and Q on the curve;
* w = s^-1 mod n by Fermat; u1 = e w, u2 = r w mod n;
* u1*G by an 8-bit fixed-base comb over G's table (digits LSB-first,
  digit 0 adds nothing), u2*Q by a 4-bit window ladder over a 16-entry
  Jacobian table of Q (64 digits MSB-first);
* a fully complete add of the two (u1*G == +-u2*Q can be crafted);
* accept iff the sum is finite with Z != 0 and X == r Z^2, or r + n < p
  and X == (r + n) Z^2.

Infinity is tracked by a flag, never by Z == 0.  The plain version runs
the same steps on whole batches, with selects where the kernel branches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, p256_tables
from .field import (IMADS, LIMBS, N, P, add_const, f25519, fp, fn,
                    is_zero_limbs, limbs_to_words_le, lt_const,
                    words_be_to_limbs, words_le_to_limbs)
from ..device import resolve_device

A = P - 3
B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
GX = p256_tables.GX
GY = p256_tables.GY
HALF_N = (N - 1) // 2

COMB_W = p256_tables.COMB_W
COMB_WINDOWS = p256_tables.COMB_WINDOWS
COMB_ENTRIES = p256_tables.COMB_ENTRIES
LADDER_W = 4
LADDER_WINDOWS = 64
LADDER_ENTRIES = 1 << LADDER_W


# ---------------------------------------------------------------------------
# Plain PyTorch point arithmetic: (X, Y, Z, inf), X/Y/Z Montgomery (16, B)
# limbs mod p, inf a (B,) bool
# ---------------------------------------------------------------------------

def dbl(pt):
    """Jacobian doubling, dbl-2001-b with a = -3; 8 mont_muls.  The
    infinity flag passes through (its coordinates are never read)."""
    X, Y, Z, inf = pt
    delta = fp.sqr(Z)
    gamma = fp.sqr(Y)
    beta = fp.mul(X, gamma)
    alpha = fp.mul(fp.sub(X, delta), fp.add(X, delta))
    alpha = fp.add(fp.add(alpha, alpha), alpha)
    b4 = fp.add(beta, beta)
    b4 = fp.add(b4, b4)
    b8 = fp.add(b4, b4)
    X3 = fp.sub(fp.sqr(alpha), b8)
    Z3 = fp.sub(fp.sub(fp.sqr(fp.add(Y, Z)), gamma), delta)
    g8 = fp.add(gamma, gamma)
    g8 = fp.add(g8, g8)
    g8 = fp.add(g8, g8)
    Y3 = fp.sub(fp.mul(alpha, fp.sub(b4, X3)), fp.mul(gamma, g8))
    return X3, Y3, Z3, inf


def _add_body(p, q):
    """General Jacobian add of finite P, Q; 16 mont_muls.
    -> (X3, Y3, Z3, h == 0, r == 0)."""
    X1, Y1, Z1, _ = p
    X2, Y2, Z2, _ = q
    z1z1 = fp.sqr(Z1)
    z2z2 = fp.sqr(Z2)
    u1 = fp.mul(X1, z2z2)
    u2 = fp.mul(X2, z1z1)
    s1 = fp.mul(Y1, fp.mul(Z2, z2z2))
    s2 = fp.mul(Y2, fp.mul(Z1, z1z1))
    h = fp.sub(u2, u1)
    r = fp.sub(s2, s1)
    h2 = fp.sqr(h)
    h3 = fp.mul(h, h2)
    u1h2 = fp.mul(u1, h2)
    X3 = fp.sub(fp.sub(fp.sub(fp.sqr(r), h3), u1h2), u1h2)
    Y3 = fp.sub(fp.mul(r, fp.sub(u1h2, X3)), fp.mul(s1, h3))
    Z3 = fp.mul(fp.mul(Z1, Z2), h)
    return X3, Y3, Z3, fp.is_zero(h), fp.is_zero(r)


def _pick_operands(p, q, X3, Y3, Z3, inf3):
    """P infinite -> Q; Q infinite -> P; both -> infinity."""
    i1, i2 = p[3], q[3]
    sel = fp.select
    X = sel(i1, q[0], sel(i2, p[0], X3))
    Y = sel(i1, q[1], sel(i2, p[1], Y3))
    Z = sel(i1, q[2], sel(i2, p[2], Z3))
    inf = torch.where(i1, i2, torch.where(i2, False, inf3))
    return X, Y, Z, inf


def add_nodbl(p, q):
    """Add without the doubling case: h == 0 (P == -Q, or P == Q, which
    the ladder cannot reach for an on-curve Q) gives infinity."""
    X3, Y3, Z3, h_zero, _ = _add_body(p, q)
    return _pick_operands(p, q, X3, Y3, Z3, h_zero)


def add_complete(p, q):
    """Fully complete add: P == Q doubles Q."""
    X3, Y3, Z3, h_zero, r_zero = _add_body(p, q)
    dx, dy, dz, _ = dbl(q)
    is_dbl = h_zero & r_zero
    sel = fp.select
    X3, Y3, Z3 = sel(is_dbl, dx, X3), sel(is_dbl, dy, Y3), sel(is_dbl, dz, Z3)
    return _pick_operands(p, q, X3, Y3, Z3, h_zero & ~r_zero)


def add_mixed(p, x2, y2, absent):
    """P + (x2, y2) for an affine comb entry; absent (digit 0) keeps P.
    11 mont_muls; no P == +-Q patch (unreachable for u1 < n)."""
    X1, Y1, Z1, inf1 = p
    z1z1 = fp.sqr(Z1)
    u2 = fp.mul(x2, z1z1)
    s2 = fp.mul(y2, fp.mul(Z1, z1z1))
    h = fp.sub(u2, X1)
    r = fp.sub(s2, Y1)
    h2 = fp.sqr(h)
    h3 = fp.mul(h, h2)
    u1h2 = fp.mul(X1, h2)
    X3 = fp.sub(fp.sub(fp.sub(fp.sqr(r), h3), u1h2), u1h2)
    Y3 = fp.sub(fp.mul(r, fp.sub(u1h2, X3)), fp.mul(Y1, h3))
    Z3 = fp.mul(Z1, h)
    sel = fp.select
    one = fp.one_bc(X1)
    X3, Y3, Z3 = sel(inf1, x2, X3), sel(inf1, y2, Y3), sel(inf1, one, Z3)
    X3, Y3, Z3 = sel(absent, X1, X3), sel(absent, Y1, Y3), sel(absent, Z1, Z3)
    return X3, Y3, Z3, inf1 & absent


def infinity(like):
    one = fp.one_bc(like)
    return one, one, one, torch.ones(like.shape[1:], dtype=torch.bool,
                                     device=like.device)


# ---------------------------------------------------------------------------
# Digit extraction from canonical (16, B) limbs
# ---------------------------------------------------------------------------

def comb_digits(u):
    """-> COMB_WINDOWS (B,) int64 digits, LSB-first (8 bits each)."""
    return [(u[j // 2] >> (8 * (j % 2))) & 0xFF for j in range(COMB_WINDOWS)]


def ladder_digits(u):
    """-> LADDER_WINDOWS (B,) int64 digits, MSB-first (4 bits each)."""
    return [(u[w // 4] >> (4 * (w % 4))) & 0xF
            for w in range(LADDER_WINDOWS - 1, -1, -1)]


def comb_accumulate(table, u):
    """u * G for canonical u < n over a (8192, 16) uint32 comb table."""
    tab = table.to(torch.int64)
    acc = infinity(u)
    for j, d in enumerate(comb_digits(u)):
        rows = tab[j * COMB_ENTRIES + d]                 # (B, 16)
        x2 = words_le_to_limbs(rows[:, :8])
        y2 = words_le_to_limbs(rows[:, 8:])
        acc = add_mixed(acc, x2, y2, d == 0)
    return acc


def ladder(qx_m, qy_m, u):
    """u * Q by the 4-bit window ladder over Q's 16-entry table."""
    t1 = (qx_m, qy_m, fp.one_bc(qx_m),
          torch.zeros(qx_m.shape[1:], dtype=torch.bool, device=qx_m.device))
    tab = [infinity(qx_m), t1, dbl(t1)]
    for _ in range(3, LADDER_ENTRIES):
        tab.append(add_nodbl(tab[-1], t1))
    TX, TY, TZ = (torch.stack([t[c] for t in tab]) for c in range(3))
    TI = torch.stack([t[3] for t in tab])                # (16, B)
    acc = infinity(qx_m)
    for d in ladder_digits(u):
        for _ in range(LADDER_W):
            acc = dbl(acc)
        idx = d.reshape(1, 1, -1).expand(1, LIMBS, -1)
        ent = (TX.gather(0, idx)[0], TY.gather(0, idx)[0],
               TZ.gather(0, idx)[0], TI.gather(0, d.reshape(1, -1))[0])
        acc = add_nodbl(acc, ent)
    return acc


# ---------------------------------------------------------------------------
# The plain version of KP2
# ---------------------------------------------------------------------------

def verify_core_plain(R, S, E, table, q_mul,
                      require_low_s: bool) -> torch.Tensor:
    """The steps both P-256 lanes share (the reference's
    `p256_fixed._verify_core`), on (16, B) limbs: the r and s range
    checks, u1 = e / s and u2 = r / s mod n, u1*G over G's comb table,
    `q_mul(u2)` -> u2*Q, the complete combine and the projective x
    check -> (B,) bool."""
    r_ok = ~is_zero_limbs(R) & lt_const(R, N)
    s_ok = ~is_zero_limbs(S) & lt_const(S, N)
    if require_low_s:
        s_ok = s_ok & lt_const(S, HALF_N + 1)

    w = fn.inv(fn.to_mont(S))          # Montgomery form of s^-1
    u1 = fn.mul(E, w)                  # e * s^-1, canonical
    u2 = fn.mul(R, w)

    X, _, Z, inf = add_complete(comb_accumulate(table, u1), q_mul(u2))
    nonzero = ~inf & ~fp.is_zero(Z)

    # --- projective x check: X == (r + k n) Z^2, k in {0, 1} ---
    z2 = fp.sqr(Z)
    eq1 = fp.eq(X, fp.mul(fp.to_mont(R), z2))
    rn, carry = add_const(R, N)
    rn_lt_p = ~carry & lt_const(rn, P)
    eq2 = rn_lt_p & fp.eq(X, fp.mul(fp.to_mont(rn), z2))
    return r_ok & s_ok & nonzero & (eq1 | eq2)


def verify_words_plain(qx, qy, r, s, e, table,
                       require_low_s: bool = True) -> torch.Tensor:
    """Plain PyTorch version of KP2 on int64 tensors: (8, B) uint32
    big-endian words and the (8192, 16) uint32 G table, all on one
    device -> (B,) bool."""
    QX, QY, R, S, E = (words_be_to_limbs(v) for v in (qx, qy, r, s, e))

    # --- key checks: qx, qy < p and Q on the curve ---
    q_ok = lt_const(QX, P) & lt_const(QY, P)
    xm = fp.to_mont(QX)
    ym = fp.to_mont(QY)
    lhs = fp.sqr(ym)
    rhs = fp.add(fp.mul(fp.add(fp.sqr(xm), fp.const_mont(A, xm)), xm),
                 fp.const_mont(B, xm))
    q_ok = q_ok & fp.eq(lhs, rhs)

    return q_ok & verify_core_plain(R, S, E, table,
                                    lambda u2: ladder(xm, ym, u2),
                                    require_low_s)


# ---------------------------------------------------------------------------
# KP2 wrapper and entry point
# ---------------------------------------------------------------------------

def _check(name, x, shape, device):
    if x.dtype != torch.uint32:
        raise TypeError(f"{name} must be uint32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")


def p256_verify(qx, qy, r, s, e, table,
                require_low_s: bool = True) -> torch.Tensor:
    """KP2 wrapper.  CUDA tensors launch the kernel on the current stream
    (one thread per signature, no synchronisation); CPU tensors take
    `verify_words_plain`.  Raises on anything the kernel does not take and
    when the launch fails."""
    if qx.dim() != 2 or qx.shape[0] != 8:
        raise ValueError("inputs must have shape (8, B)")
    dev = qx.device
    for name, x in (("qx", qx), ("qy", qy), ("r", r), ("s", s), ("e", e)):
        _check(name, x, qx.shape, dev)
    _check("table", table, (p256_tables.ROWS, p256_tables.ROW_WORDS), dev)
    n = qx.shape[1]
    if dev.type == "cpu":
        return verify_words_plain(qx, qy, r, s, e, table, require_low_s)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n >= 1 << 31:
        raise ValueError("batch too large for one launch")
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    lib = _build.load("p256_verify")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [ctypes.c_void_p(t.data_ptr())
                for t in (qx, qy, r, s, e, table, out)]
        rc = lib.p256_verify_launch(*ptrs, ctypes.c_int(n),
                                    ctypes.c_int(bool(require_low_s)),
                                    ctypes.c_void_p(stream))
    if rc:
        raise RuntimeError(f"p256_verify launch failed: CUDA error {rc}")
    p256_verify.launches += 1
    return out


p256_verify.launches = 0


def _as_words(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.uint32)))
    return t.to(device).contiguous()


def verify_words(qx, qy, r, s, e, require_low_s: bool = True,
                 device=None) -> torch.Tensor:
    """Batched verify over (8, B) uint32 big-endian words (numpy arrays
    or tensors) on `device` (default: CUDA; raises without it)."""
    dev = resolve_device(device)
    args = [_as_words(v, dev) for v in (qx, qy, r, s, e)]
    return p256_verify(*args, p256_tables.g_table(dev),
                       require_low_s=require_low_s)


# ---------------------------------------------------------------------------
# The field probe: one of KP2's field routines a lane
# ---------------------------------------------------------------------------
# Inputs and output (n, 8) uint32, little-endian words, Montgomery form
# (R = 2^256).  mul_p is field_ptx.cuh's a b R^-1 mod p, sqr_p its a^2
# R^-1 mod p, mul_n its mont_mul_ptx<MOD_N>, a b R^-1 mod n, mul_25519
# its a b R^-1 mod p25519 (KE5's and KE6's multiply).

_PROBE_FIELD = {"mul_p": fp, "sqr_p": fp, "mul_n": fn, "mul_25519": f25519}
FIELD_PROBE_OPS = tuple(_PROBE_FIELD)

# A warp moves one tile of PROBE_TILE lanes, one lane a thread, in blocks
# of FIELD_PROBE_THREADS (the kernel's PROBE_THREADS).  The A/B
# (tools/probe_ab.py, H100, PERF.md §6) found 128 and 256 threads within
# 1.5% at 65,536 and SMs x 2,048 lanes, and two lanes a thread 7-8% slower
# at both, so one layout is kept.
PROBE_TILE = 32
FIELD_PROBE_THREADS = 256


def field_probe_plan(n: int) -> int:
    """Blocks of FIELD_PROBE_THREADS threads that launch the field probe
    over n lanes, a warp a tile of PROBE_TILE lanes; n = 0 gives none."""
    if n < 0:
        raise ValueError("n must be >= 0")
    return -(-n // FIELD_PROBE_THREADS)


def field_probe_bound_ms(op: str, n: int, imad_rate: float,
                         bytes_per_s: float) -> tuple:
    """The least time of one probe launch over n lanes -> (ms, "bytes" or
    "operations"): the larger of its 32-bit multiply-adds (`field.IMADS`
    of the op's multiply) over `imad_rate` and its bytes (a and b read
    once, out written once: 96 a lane, 64 for sqr_p) over `bytes_per_s`."""
    key = {"mul_n": ("n", "mul"), "sqr_p": ("p", "sqr"),
           "mul_25519": ("p25519", "mul")}.get(op, ("p", "mul"))
    ops_s = n * IMADS[key] / imad_rate
    bytes_s = n * 32 * (2 if op == "sqr_p" else 3) / bytes_per_s
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def field_probe_modulus(op: str) -> int:
    """The modulus of a probe op."""
    return _PROBE_FIELD[op].m


def field_probe_plain(op: str, a: torch.Tensor,
                      b: torch.Tensor = None) -> torch.Tensor:
    """The plain version of the probe: `field.Mod.mul` on (n, 8) words.
    Preconditions as the kernel's: a < 2^256, b < m (sqr_p: a < p)."""
    if op not in FIELD_PROBE_OPS:
        raise ValueError(f"unknown field op {op!r}; one of {FIELD_PROBE_OPS}")
    x = words_le_to_limbs(a)
    y = x if op == "sqr_p" else words_le_to_limbs(b)
    return limbs_to_words_le(_PROBE_FIELD[op].mul(x, y))


def p256_field_probe(op: str, a: torch.Tensor,
                     b: torch.Tensor = None) -> torch.Tensor:
    """Wrapper of KP2's field probe (`p256_field_probe_plan_launch`, in
    KP2's library): op (`FIELD_PROBE_OPS`) on each row of a (and b;
    sqr_p takes a alone), one lane each.  CUDA tensors launch the op's
    kernel on the current stream in `field_probe_plan`'s blocks, and
    raise on an input not 16-byte aligned; CPU tensors
    take `field_probe_plain`.  No lanes, no launch.  The kernel does not
    check the preconditions (a < 2^256, b < m, sqr_p's a < p)."""
    if op not in FIELD_PROBE_OPS:
        raise ValueError(f"unknown field op {op!r}; one of {FIELD_PROBE_OPS}")
    if a.dim() != 2 or a.shape[1] != 8 or a.dtype != torch.uint32 \
            or not a.is_contiguous():
        raise ValueError("a must be a contiguous (n, 8) uint32 tensor")
    if (b is None) != (op == "sqr_p"):
        raise ValueError(f"{op} takes {1 if op == 'sqr_p' else 2} input(s)")
    if b is not None and (b.shape != a.shape or b.dtype != a.dtype
                          or not b.is_contiguous() or b.device != a.device):
        raise ValueError("b must be a contiguous uint32 tensor of a's shape "
                         "on a's device")
    dev = a.device
    n = a.shape[0]
    if n == 0:
        return torch.empty_like(a)
    if dev.type == "cpu":
        return field_probe_plain(op, a, b)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty_like(a)
    for name, t in (("a", a), ("b", b), ("out", out)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "moves 16-byte vectors); got a view at "
                             f"{t.data_ptr() % 16} bytes past a boundary")
    lib = _build.load("p256_verify")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.p256_field_probe_plan_launch(
            ctypes.c_int(FIELD_PROBE_OPS.index(op)),
            ctypes.c_int(field_probe_plan(n)),
            ctypes.c_void_p(a.data_ptr()),
            ctypes.c_void_p((a if b is None else b).data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_int(n),
            ctypes.c_void_p(stream))
    if rc:
        raise RuntimeError(f"p256_field_probe launch failed: CUDA error {rc}")
    p256_field_probe.launches += 1
    return out


p256_field_probe.launches = 0


def field_probe_edges(op: str) -> tuple:
    """Edge inputs of the probe's op -> (a values, b values), each within
    the op's preconditions: 0, 1, m - 1 and 2^256 - 1 as a; m itself and
    values just past it as a; operands whose words are all ones, so that
    every carry chain carries into its top word; inputs whose result is
    0, 1 or m - 1 (a = m, a = R^-1 mod m, a = (m - 1) R^-1 mod m against
    b = R^2 mod m); mod p25519 also 2p and 2^256 - 1 - p as a (a >= p,
    as to_mont is given)."""
    m = field_probe_modulus(op)
    top = (1 << 256) - 1
    r2 = (1 << 512) % m
    rinv = pow(1 << 256, -1, m)
    a = [0, 1, m - 1, top, m, m + 1, top, top, (1 << 224) - 1,
         (1 << 128) - 1, 1 << 255, rinv, (m - 1) * rinv % m, m - 2]
    b = [m - 1, m - 1, m - 1, m - 1, 7, m - 1, (1 << 224) - 1, 1, m - 1,
         (1 << 255) + 1, m - 1, r2, r2, 0]
    if op == "sqr_p":                           # a is also b: a < p
        a = [x for x in a if x < m] + [(1 << 224) - 1, m - 2]
        b = a
    if op == "mul_25519":
        a += [2 * m, top - m, m - 1]
        b += [m - 1, 2, m - 1]
    return a, b


# ---------------------------------------------------------------------------
# Work count for the kernel's bound
# ---------------------------------------------------------------------------

# (multiplies, squares) mod p of each point operation in csrc/p256_verify.cu
_DBL = (4, 4)
_ADD = (12, 4)                                # pt_add_body
_MIXED = (8, 3)

# s^-1 mod n over a batch, at least: Montgomery's trick costs 3 multiplies
# per signature (counted in field_ops_per_verify) and one Fermat chain per
# launch, s^(n-2) by 255 squares and a multiply per further set bit.  The
# kernels do not batch it yet: each thread runs its own chain.
INV_N_BATCH_MULS = 3
INV_N_CHAIN = {("n", "mul"): bin(N - 2)[3:].count("1"), ("n", "sqr"): 255}


def imads_per_launch() -> int:
    """32-bit multiply-adds of the one Fermat chain a launch's batched
    inversion needs, on top of the per-signature counts."""
    return sum(IMADS[k] * c for k, c in INV_N_CHAIN.items())


def field_ops_per_verify(u1: int, u2: int) -> dict:
    """Montgomery multiplies and squares one KP2 signature with these
    scalars needs at least, keyed like `field.IMADS`, counted from
    csrc/p256_verify.cu: the fixed steps, plus the comb and ladder adds
    and ladder doublings the digits of u1 and u2 call for (an add onto
    infinity is a copy, a digit 0 adds nothing).  s^-1 counts as batched
    (`INV_N_CHAIN` is added once per launch)."""
    pm, ps = 2 + 1, 2                         # to_mont Q; the curve check
    nm = 1 + INV_N_BATCH_MULS + 2             # to_mont s, s^-1, u1 u2
    ns = 0
    pts = [_DBL] + [_ADD] * 13                # Q's table
    comb = sum(1 for j in range(COMB_WINDOWS) if (u1 >> (8 * j)) & 0xFF)
    pts += [_MIXED] * max(comb - 1, 0)
    inf = True
    for w in range(LADDER_WINDOWS - 1, -1, -1):
        if not inf:
            pts += [_DBL] * LADDER_W
        if (u2 >> (4 * w)) & 0xF:
            if not inf:
                pts.append(_ADD)
            inf = False
    if comb and not inf:
        pts.append(_ADD)                      # the complete combine
    pm += 4 + sum(m for m, _ in pts)          # the projective x check: 4
    ps += 1 + sum(s for _, s in pts)          # and 1
    return {("p", "mul"): pm, ("p", "sqr"): ps,
            ("n", "mul"): nm, ("n", "sqr"): ns}


def imads_per_verify(u1: int, u2: int) -> int:
    """32-bit multiply-adds that one signature's field work needs."""
    return sum(IMADS[k] * c for k, c in field_ops_per_verify(u1, u2).items())


# what KP2 issues mod n a signature: to_mont(s), its own Fermat chain,
# u1 and u2
N_OPS_ISSUED = 1 + sum(INV_N_CHAIN.values()) + 2


def field_ops_issued(u1: int, u2: int) -> int:
    """Montgomery multiplies and squares KP2 issues for one signature:
    the least count mod p (the kernel issues exactly that) and
    `N_OPS_ISSUED` mod n."""
    c = field_ops_per_verify(u1, u2)
    return c["p", "mul"] + c["p", "sqr"] + N_OPS_ISSUED


# ---------------------------------------------------------------------------
# Host-side packing helpers (numpy; byte-level)
# ---------------------------------------------------------------------------

def bytes32_to_words(vals: list) -> np.ndarray:
    """list of B 32-byte big-endian bytestrings -> (8, B) uint32."""
    for v in vals:
        if len(v) != 32:
            raise ValueError("expected 32-byte value")
    if not vals:
        return np.zeros((8, 0), dtype=np.uint32)
    flat = np.frombuffer(b"".join(vals), dtype=">u4")
    return np.ascontiguousarray(
        flat.reshape(len(vals), 8).T).astype(np.uint32)


def ints_to_words(vals: list) -> np.ndarray:
    """list of B python ints (< 2^256) -> (8, B) uint32 big-endian words."""
    return bytes32_to_words([int(v).to_bytes(32, "big") for v in vals])
