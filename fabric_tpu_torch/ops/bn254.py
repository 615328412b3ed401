"""K8: the batched BN254 pairing check of the idemix lane.

Counterpart of `fabric_tpu/ops/bn254_batch.py` (`pairing_check_batch`,
`miller_loop_dual`, `miller_loop`, `final_exp`, `f12_mul`,
`f12_mul_sparse013`, `f2_mul`, `pack_steps`, `pairing_batch`).  For a
batch of G1 pairs (P1_i, P2_i) against two fixed G2 points Q1 (the
issuer's w, one per issuer) and Q2 (g2), it decides

    e(P1_i, Q1) * e(P2_i, Q2) == 1

with the ate pairing: the Miller lines depend only on multiples of the
fixed Q, so the host precomputes every step's line constants once
(`idemix.bn254.ate_precompute`, 137 steps, 126 of them squaring steps)
and the per-check work is Fp12 tower arithmetic.  The idemix
presentation equation e(A', w) == e(Abar, g2) is this check with
P1 = A' and P2 = -Abar.

The tower is the host's: Fp2 = Fp[i]/(i^2 + 1), Fp12 = Fp2[w]/(w^6 - xi)
with xi = 1 + i, an Fp12 element being six Fp2 coefficients of w^k.
A line evaluated at P = (x, y) is the sparse element y (w^0, in Fp)
+ A*x (w^1) + B (w^3).

The final exponentiation by (p^12 - 1)/r is split as the host's
`_final_exp` does: the easy part conj(f) * f^-1 (tower inversion, one
Fp inversion by Fermat) and the Frobenius p^2 + 1, then the
Devegili-Scott-Dominguez hard part with three |u|-powers.  It is the
same function as the reference's square-and-multiply over the 2,786-bit
exponent with about a twelfth of the work; the tests hold it against
both.

The port's layout replaces the reference's (22, B) int32 12-bit limbs
with R = 2^264 and lazy bounds:

* coordinates: (8, B) uint32, row j the j-th little-endian 32-bit limb
  of a coordinate < 2^256 (the caller's on-curve gate makes them < p;
  a larger value is taken mod p);
* line constants: (K, S, 2, 2, 8) uint32, slot 0 g2's lines and one
  slot per issuer's w, [slot, step, A or B, c0 or c1] in Montgomery form
  with R = 2^256, fully reduced; flags (S,) int32, shared by every slot
  (all precomputes run over the same ATE_LAMBDA);
* slot: (B,) int32, the slot of check i's Q1; Q2 is always slot 0.

`pairing_check_batch` is the plain PyTorch version, on the (16, ...)
int64 limbs of `field.py` with every value fully reduced; each Fp12
product runs as one wide call of the field layer (all 36 Fp2 products
stacked).  `bn254_pairing_check` is the wrapper of the CUDA kernel KB8
(`csrc/bn254_pairing.cu`); for CPU tensors it runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from . import _build
from .field import (BN254 as P, IMADS, LIMBS, LIMB_BITS, MASK, fbn as fp,
                    int_to_limbs, normalize, words_le_to_limbs)
from ..idemix import bn254 as hb

assert P == hb.P
R_MONT = 1 << 256
X_ABS = -hb.X_BN                    # |u| = 2^62 + 2^55 + 1 (u < 0)


def mont(x: int) -> int:
    return x % P * R_MONT % P


def ints_to_words(vals: Sequence[int]) -> np.ndarray:
    """B ints (< 2^256) -> (8, B) uint32 little-endian limbs."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.ascontiguousarray(
        np.frombuffer(raw, "<u4").reshape(len(vals), 8).T, np.uint32)


# ---------------------------------------------------------------------------
# Line constants (the host precompute carried to the port's layout)
# ---------------------------------------------------------------------------

def pack_steps(steps) -> dict:
    """`idemix.bn254.ate_precompute` output -> {"flags": (S,) int32,
    "lines": (S, 2, 2, 8) uint32 Montgomery words}."""
    flags = np.asarray([s[0] for s in steps], np.int32)
    vals = [mont(v) for _, A, B in steps for v in (*A, *B)]
    lines = ints_to_words(vals).T.reshape(len(steps), 2, 2, 8)
    return {"flags": flags, "lines": np.ascontiguousarray(lines)}


@functools.lru_cache(maxsize=None)
def g2_packed() -> dict:
    """g2's line constants, `pack_steps(ate_precompute(G2_GEN))`, built
    once per process (~25 ms of host arithmetic); do not modify."""
    return pack_steps(hb.ate_precompute(hb.G2_GEN))


def from_jax_packed(packed: dict) -> dict:
    """The reference's `bn254_batch.pack_steps` dict ({"flags", "A",
    "B"}, (S, 2, 22) int32 12-bit limbs in Montgomery form with
    R = 2^264) -> the port's `pack_steps` layout: x*2^264 becomes
    x*2^256 by a factor 2^-8 mod p."""
    shift = pow(1 << 8, -1, P)

    def val(limbs) -> int:
        return sum(int(v) << (12 * i) for i, v in enumerate(limbs))

    A = np.asarray(packed["A"])
    B = np.asarray(packed["B"])
    vals = [val(M[s, c]) % P * shift % P
            for s in range(A.shape[0]) for M in (A, B) for c in (0, 1)]
    lines = ints_to_words(vals).T.reshape(A.shape[0], 2, 2, 8)
    return {"flags": np.asarray(packed["flags"], np.int32),
            "lines": np.ascontiguousarray(lines)}


def stack_lines(packs: Sequence[dict]) -> tuple:
    """[pack_steps dicts], g2's first -> (flags (S,) int32, lines
    (K, S, 2, 2, 8) uint32).  The dual loop walks one flags array for
    both lines, so every pack must carry the same flags."""
    flags = packs[0]["flags"]
    for pk in packs[1:]:
        if not np.array_equal(pk["flags"], flags):
            raise ValueError("line sets of unaligned step sequences")
    return flags, np.stack([pk["lines"] for pk in packs])


# ---------------------------------------------------------------------------
# Plain tower arithmetic on (16, ..., B) int64 limbs, Montgomery form
# ---------------------------------------------------------------------------
# Fp: (16, B); Fp2: (16, ..., 2, B) with (c0, c1) on dim -2; Fp12:
# (16, 6, 2, B), coefficient k of w^k on dim 1.  Every value in and out
# is fully reduced.

_COLS: dict = {}


def _mult_col(k: int, like: torch.Tensor) -> torch.Tensor:
    """Limbs of k*p as a broadcast column, the top limb carrying what
    exceeds 2^256 (cached per device and rank)."""
    key = (k, str(like.device), like.dim())
    col = _COLS.get(key)
    if col is None:
        v = k * P
        limbs = [(v >> (LIMB_BITS * i)) & MASK for i in range(LIMBS - 1)]
        limbs.append(v >> (LIMB_BITS * (LIMBS - 1)))
        col = _COLS[key] = torch.tensor(
            limbs, dtype=torch.int64, device=like.device).reshape(
                (LIMBS,) + (1,) * (like.dim() - 1))
    return col


def _reduce_lazy(t: torch.Tensor) -> torch.Tensor:
    """Signed limbs of a value in (-16p, 16p) -> [0, p): add 16p, then
    subtract 16p, 8p, 4p, 2p and p where the difference stays >= 0."""
    t = normalize(t + _mult_col(16, t))
    for k in (16, 8, 4, 2, 1):
        d = normalize(t - _mult_col(k, t))
        t = torch.where(d[LIMBS - 1] < 0, t, d)
    return t


def _f2_mul_lazy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba Fp2 products, one wide field call for all of them ->
    lazy (re in (-p, p), im in (-2p, p)) stacked on dim -2."""
    a0, a1 = a.select(-2, 0), a.select(-2, 1)
    b0, b1 = b.select(-2, 0), b.select(-2, 1)
    x = torch.stack(torch.broadcast_tensors(a0, a1, fp.add(a0, a1)), 1)
    y = torch.stack(torch.broadcast_tensors(b0, b1, fp.add(b0, b1)), 1)
    t = fp.mul(x, y)
    t0, t1, t2 = t[:, 0], t[:, 1], t[:, 2]
    return torch.stack([t0 - t1, t2 - t0 - t1], -2)


def f2_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce_lazy(_f2_mul_lazy(a, b))


def f2_scale(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Fp2 times an Fp value s (16, B)."""
    return fp.mul(a, s.unsqueeze(-2))


def f2_neg(a: torch.Tensor) -> torch.Tensor:
    return fp.sub(torch.zeros_like(a), a)


def f2_mul_xi(a: torch.Tensor) -> torch.Tensor:
    """a * (1 + i) = (c0 - c1) + (c0 + c1) i."""
    c0, c1 = a.select(-2, 0), a.select(-2, 1)
    return torch.stack([fp.sub(c0, c1), fp.add(c0, c1)], -2)


def f2_conj(a: torch.Tensor) -> torch.Tensor:
    return torch.stack([a.select(-2, 0), f2_neg(a.select(-2, 1))], -2)


def f2_inv(a: torch.Tensor) -> torch.Tensor:
    """(a0 - a1 i) / (a0^2 + a1^2), one Fermat inversion in Fp."""
    a0, a1 = a.select(-2, 0), a.select(-2, 1)
    d = fp.inv(fp.add(fp.mul(a0, a0), fp.mul(a1, a1)))
    return torch.stack([fp.mul(a0, d), f2_neg(fp.mul(a1, d))], -2)


_TERMS: dict = {}


def _terms(js: tuple, device) -> tuple:
    """Index tables of a product over b's coefficients js: term (j, k)
    multiplies a_((k - j) mod 6) by b_j, times xi where j > k (w^6 = xi)."""
    key = (js, str(device))
    got = _TERMS.get(key)
    if got is None:
        idx = torch.tensor([[(k - j) % 6 for k in range(6)] for j in js],
                           device=device)
        wrap = torch.tensor([[j > k for k in range(6)] for j in js],
                            device=device)
        got = _TERMS[key] = (idx, wrap[None, :, :, None, None])
    return got


def _f12_mul_by(a: torch.Tensor, bj: torch.Tensor, js: tuple) -> torch.Tensor:
    """a (dense Fp12) times the Fp12 whose nonzero coefficients are
    bj (16, J, 2, B) at the powers js of w: the 6 J Fp2 products in one
    wide call, summed per power."""
    idx, wrap = _terms(js, a.device)
    bsel = torch.where(wrap, f2_mul_xi(bj)[:, :, None], bj[:, :, None])
    return _reduce_lazy(_f2_mul_lazy(a[:, idx], bsel).sum(1))


_DENSE = (0, 1, 2, 3, 4, 5)
_SPARSE = (0, 1, 3)


def f12_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook over w^6 = xi: 36 Fp2 products."""
    return _f12_mul_by(a, b, _DENSE)


def f12_sqr(a: torch.Tensor) -> torch.Tensor:
    return f12_mul(a, a)


def f12_mul_sparse013(f: torch.Tensor, y: torch.Tensor, l1: torch.Tensor,
                      l3: torch.Tensor) -> torch.Tensor:
    """f times the line y (w^0, y in Fp) + l1 (w^1) + l3 (w^3)."""
    y2 = torch.stack([y, torch.zeros_like(y)], -2)
    b = torch.stack(torch.broadcast_tensors(y2, l1, l3), 1)
    return _f12_mul_by(f, b, _SPARSE)


def f12_one(batch: int, device="cpu") -> torch.Tensor:
    f = torch.zeros((LIMBS, 6, 2, batch), dtype=torch.int64, device=device)
    f[:, 0, 0] = torch.tensor(int_to_limbs(fp.one_int), device=device)[:, None]
    return f


def f12_conj(a: torch.Tensor) -> torch.Tensor:
    """a^(p^6): the odd powers of w negated."""
    out = a.clone()
    out[:, 1::2] = f2_neg(a[:, 1::2])
    return out


def _gamma_limbs(power: int, device) -> torch.Tensor:
    vals = [mont(c) for g in hb.GAMMA[power] for c in g]
    t = torch.tensor([int_to_limbs(v) for v in vals], dtype=torch.int64,
                     device=device)
    return t.T.reshape(LIMBS, 6, 2, 1)


def f12_frobenius(a: torch.Tensor, power: int) -> torch.Tensor:
    """a^(p^power), power 1, 2 or 3: c_k -> conj^power(c_k) * GAMMA[k]."""
    c = f2_conj(a) if power % 2 else a
    return f2_mul(c, _gamma_limbs(power, a.device))


def _f6(a, i):
    return a.select(1, i)


def f6_mul(a, b):
    """Fp6 = Fp2[v]/(v^3 - xi), a and b triples of Fp2 (host f6_mul)."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = fp.add(t0, f2_mul_xi(fp.sub(
        f2_mul(fp.add(a1, a2), fp.add(b1, b2)), fp.add(t1, t2))))
    c1 = fp.add(fp.sub(f2_mul(fp.add(a0, a1), fp.add(b0, b1)),
                       fp.add(t0, t1)), f2_mul_xi(t2))
    c2 = fp.add(fp.sub(f2_mul(fp.add(a0, a2), fp.add(b0, b2)),
                       fp.add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_inv(a):
    a0, a1, a2 = a
    t0 = fp.sub(f2_mul(a0, a0), f2_mul_xi(f2_mul(a1, a2)))
    t1 = fp.sub(f2_mul_xi(f2_mul(a2, a2)), f2_mul(a0, a1))
    t2 = fp.sub(f2_mul(a1, a1), f2_mul(a0, a2))
    norm = fp.add(f2_mul(a0, t0), f2_mul_xi(
        fp.add(f2_mul(a2, t1), f2_mul(a1, t2))))
    ninv = f2_inv(norm)
    return (f2_mul(t0, ninv), f2_mul(t1, ninv), f2_mul(t2, ninv))


def f12_inv(a: torch.Tensor) -> torch.Tensor:
    """Tower inversion (host f12_inv): a = g + h w with g, h in Fp6 over
    v = w^2; (g + h w)^-1 = (g - h w) / (g^2 - h^2 v)."""
    g = (_f6(a, 0), _f6(a, 2), _f6(a, 4))
    h = (_f6(a, 1), _f6(a, 3), _f6(a, 5))
    hh = f6_mul(h, h)
    d = tuple(fp.sub(x, y) for x, y in zip(
        f6_mul(g, g), (f2_mul_xi(hh[2]), hh[0], hh[1])))
    dinv = f6_inv(d)
    gi = f6_mul(g, dinv)
    hi = f6_mul(h, dinv)
    return torch.stack([gi[0], f2_neg(hi[0]), gi[1], f2_neg(hi[1]),
                        gi[2], f2_neg(hi[2])], 1)


def _pow_abs_u(m: torch.Tensor) -> torch.Tensor:
    acc = m
    for bit in bin(X_ABS)[3:]:
        acc = f12_sqr(acc)
        if bit == "1":
            acc = f12_mul(acc, m)
    return acc


def _pow_u(m: torch.Tensor) -> torch.Tensor:
    """m^u (u < 0): conj inverts in the cyclotomic subgroup."""
    return f12_conj(_pow_abs_u(m))


def final_exp_hard(m: torch.Tensor) -> torch.Tensor:
    """m^((p^4 - p^2 + 1)/r) for m in the cyclotomic subgroup: the
    Devegili-Scott-Dominguez chain of the host's `final_exp_hard`."""
    f1 = _pow_u(m)
    f2 = _pow_u(f1)
    f3 = _pow_u(f2)
    y0 = f12_mul(f12_mul(f12_frobenius(m, 1), f12_frobenius(m, 2)),
                 f12_frobenius(m, 3))
    y1 = f12_conj(m)
    y2 = f12_frobenius(f2, 2)
    y3 = f12_conj(f12_frobenius(f1, 1))
    y4 = f12_conj(f12_mul(f1, f12_frobenius(f2, 1)))
    y5 = f12_conj(f2)
    y6 = f12_conj(f12_mul(f3, f12_frobenius(f3, 1)))
    t0 = f12_mul(f12_mul(f12_sqr(y6), y4), y5)
    t1 = f12_mul(f12_mul(y3, y5), t0)
    t0 = f12_mul(t0, y2)
    t1 = f12_mul(f12_sqr(t1), t0)
    t1 = f12_sqr(t1)
    t0 = f12_sqr(f12_mul(t1, y1))
    return f12_mul(t0, f12_mul(t1, y0))


def final_exp(f: torch.Tensor) -> torch.Tensor:
    """f^((p^12 - 1)/r): easy part conj(f) * f^-1 and the p^2 + 1
    Frobenius, then the hard part."""
    f = f12_mul(f12_conj(f), f12_inv(f))
    f = f12_mul(f12_frobenius(f, 2), f)
    return final_exp_hard(f)


def f12_is_one(f: torch.Tensor) -> torch.Tensor:
    """(B,) bool: f equals 1 (Montgomery one at w^0, zero elsewhere)."""
    one = fp.const(fp.one_int, f[:, 0, 0])
    rest = f.reshape(LIMBS, 12, -1)[:, 1:]
    return (f[:, 0, 0] == one).all(0) & (rest == 0).all(0).all(0)


# ---------------------------------------------------------------------------
# Miller loops and the pairing check (the plain version of KB8)
# ---------------------------------------------------------------------------

def lines_to_limbs(lines: torch.Tensor) -> torch.Tensor:
    """(K, S, 2, 2, 8) uint32 words -> (16, K, S, 2, 2) int64 limbs."""
    k, s = lines.shape[:2]
    flat = words_le_to_limbs(lines.reshape(-1, 8))
    return flat.reshape(LIMBS, k, s, 2, 2)


def coords_to_limbs(x: torch.Tensor) -> torch.Tensor:
    """(8, B) uint32 little-endian limbs -> (16, B) int64 limbs."""
    return words_le_to_limbs(x.T)


def _lane_lines(lines_l: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """(16, K, S, 2, 2) limbs, (B,) slots -> (16, S, 2, 2, B)."""
    return lines_l[:, slot.to(lines_l.device, torch.int64)].permute(
        0, 2, 3, 4, 1)


def _line_step(f, s, L, xm, ym):
    A, B = L[:, s, 0], L[:, s, 1]            # (16, 2, B or 1)
    return f12_mul_sparse013(f, ym, f2_scale(A, xm), B)


def miller_loop(flags, L, xm, ym, n_steps: int = None) -> torch.Tensor:
    """f_{lambda,Q}(P) in Montgomery form.  flags (S,); L (16, S, 2, 2,
    B or 1) Montgomery line limbs; xm, ym (16, B) Montgomery coordinates;
    n_steps limits the loop (prefix tests)."""
    flags = [int(v) for v in flags][:n_steps]
    f = f12_one(xm.shape[-1], xm.device)
    for s, flag in enumerate(flags):
        if flag:
            f = f12_sqr(f)
        f = _line_step(f, s, L, xm, ym)
    return f


def miller_loop_dual(flags, L1, L2, x1m, y1m, x2m, y2m,
                     n_steps: int = None) -> torch.Tensor:
    """f_{lambda,Q1}(P1) * f_{lambda,Q2}(P2) with shared squarings: the
    two step lists come from one ATE_LAMBDA, so each step squares f once
    (flag 1) and multiplies both lines in."""
    flags = [int(v) for v in flags][:n_steps]
    f = f12_one(x1m.shape[-1], x1m.device)
    for s, flag in enumerate(flags):
        if flag:
            f = f12_sqr(f)
        f = _line_step(f, s, L1, x1m, y1m)
        f = _line_step(f, s, L2, x2m, y2m)
    return f


def _check_inputs(flags, lines, slot, coords) -> tuple:
    """Validate the KB8 inputs -> (S, K, B, device)."""
    if lines.dim() != 5 or tuple(lines.shape[2:]) != (2, 2, 8):
        raise ValueError("lines must have shape (K, S, 2, 2, 8)")
    k, s = lines.shape[:2]
    dev = lines.device
    if lines.dtype != torch.uint32 or not lines.is_contiguous():
        raise ValueError("lines must be a contiguous uint32 tensor")
    if flags.dtype != torch.int32 or tuple(flags.shape) != (s,) \
            or not flags.is_contiguous() or flags.device != dev:
        raise ValueError(f"flags must be a contiguous ({s},) int32 tensor "
                         "on the lines' device")
    if k == 0 or s == 0:
        raise ValueError("lines must hold at least one slot and one step")
    x = coords[0]
    if x.dim() != 2 or x.shape[0] != 8:
        raise ValueError("coordinates must have shape (8, B)")
    n = x.shape[1]
    for name, c in zip(("x1", "y1", "x2", "y2"), coords):
        if c.dtype != torch.uint32 or tuple(c.shape) != (8, n) \
                or not c.is_contiguous() or c.device != dev:
            raise ValueError(f"{name} must be a contiguous (8, {n}) uint32 "
                             "tensor on the lines' device")
    if slot.dtype != torch.int32 or tuple(slot.shape) != (n,) \
            or not slot.is_contiguous():
        raise ValueError(f"slot must be a contiguous ({n},) int32 tensor")
    if slot.device.type != "cpu":
        raise ValueError("slot must lie on the CPU (its range is checked "
                         "there before the upload)")
    if n and (int(slot.min()) < 0 or int(slot.max()) >= k):
        raise ValueError(f"slot out of range [0, {k})")
    return s, k, n, dev


def pairing_check_batch(flags, lines, slot, x1, y1, x2, y2) -> torch.Tensor:
    """Plain PyTorch version of KB8: e(P1_i, Q1_slot[i]) * e(P2_i, Q2)
    == 1 -> (B,) bool.  Layouts as in the module docstring; Q2 is slot
    0.  On-curve membership of the points is the caller's gate."""
    L = lines_to_limbs(lines)
    L1 = _lane_lines(L, slot)
    L2 = L[:, 0].unsqueeze(-1)
    ms = [fp.to_mont(coords_to_limbs(c)) for c in (x1, y1, x2, y2)]
    f = miller_loop_dual(flags.tolist(), L1, L2, *ms)
    return f12_is_one(final_exp(f))


def pairing_batch(flags, lines_q, x, y) -> list:
    """Reduced ate pairing e(P_i, Q) for tests: flags (S,), lines_q
    (S, 2, 2, 8) uint32 words of one Q, x, y (8, B) uint32 -> B host
    Fp12 tuples (plain ints), comparable with `ate_pairing_lines`."""
    L = lines_to_limbs(lines_q[None])[:, 0].unsqueeze(-1)
    xm, ym = (fp.to_mont(coords_to_limbs(c)) for c in (x, y))
    return f12_to_ints(final_exp(miller_loop(flags.tolist(), L, xm, ym)))


def f12_to_ints(f: torch.Tensor) -> list:
    """(16, 6, 2, B) Montgomery limbs -> B host Fp12 tuples."""
    std = fp.from_mont(f)
    cols = std.reshape(LIMBS, 12, -1).permute(0, 2, 1).reshape(LIMBS, -1)
    vals = [sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(col))
            for col in cols.T.tolist()]
    n = f.shape[-1]
    return [tuple((vals[b * 12 + 2 * k], vals[b * 12 + 2 * k + 1])
                  for k in range(6)) for b in range(n)]


def f12_from_ints(vals: Sequence, device="cpu") -> torch.Tensor:
    """B host Fp12 tuples -> (16, 6, 2, B) Montgomery limbs."""
    rows = [[int_to_limbs(mont(c)) for g in v for c in g] for v in vals]
    t = torch.tensor(rows, dtype=torch.int64, device=device)  # (B, 12, 16)
    return t.permute(2, 1, 0).reshape(LIMBS, 6, 2, len(vals)).contiguous()


# ---------------------------------------------------------------------------
# KB8 wrapper
# ---------------------------------------------------------------------------

THREADS = 128                   # threads per block: the kernel's launch bound


def bn254_pairing_check(flags, lines, slot, x1, y1, x2, y2) -> torch.Tensor:
    """KB8 wrapper.  flags, lines and the coordinates lie on one device;
    slot is a (B,) int32 tensor on the CPU, checked to lie in [0, K)
    here and then copied to the device.  CUDA tensors launch the kernel
    on the current stream (one thread per check, no synchronisation);
    CPU tensors take `pairing_check_batch`.  Raises on anything the
    kernel does not take and when the launch fails."""
    s, k, n, dev = _check_inputs(flags, lines, slot, (x1, y1, x2, y2))
    if dev.type == "cpu":
        return pairing_check_batch(flags, lines, slot, x1, y1, x2, y2)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    lib = _build.load("bn254_pairing")
    slot_d = slot.pin_memory().to(dev, non_blocking=True)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [ctypes.c_void_p(t.data_ptr())
                for t in (flags, lines, slot_d, x1, y1, x2, y2, out)]
        rc = lib.bn254_pairing_launch(*ptrs, ctypes.c_int(s),
                                      ctypes.c_int(k), ctypes.c_int(n),
                                      ctypes.c_int(THREADS),
                                      ctypes.c_void_p(stream))
    if rc:
        raise RuntimeError(f"bn254_pairing launch failed: CUDA error {rc}")
    bn254_pairing_check.launches += 1
    return out


bn254_pairing_check.launches = 0


# ---------------------------------------------------------------------------
# Work count for the kernel's bound
# ---------------------------------------------------------------------------

# Least Fp multiplies of each tower operation (the square of an Fp2
# coefficient counts as two Fp multiplies; only the Fermat chain's are
# Fp squares).  This is the least work known, not what KB8 issues
# (`fp_ops_issued`): KB8 runs every Fp12 square as a schoolbook product.
F2_MUL = 3                      # Karatsuba
F2_SQR = 2                      # (a + b)(a - b), 2ab
F6_MUL = 6 * F2_MUL             # Karatsuba over Fp2
F6_SQR = 2 * F2_MUL + 3 * F2_SQR          # Chung-Hasan SQR2
F12_MUL = 3 * F6_MUL            # Karatsuba over Fp6: 54
F12_SQR = 2 * F6_MUL            # complex squaring: 36
# a square in the cyclotomic subgroup (the hard part): Karabina's
# compressed squaring; its decompressions are left out, which only
# lowers the count
F12_CYC_SQR = 6 * F2_SQR
# a Miller step's two lines: A*x for each (2 + 2), their product (the
# Fp terms 1 + 4 * 2, the Fp2 terms by Karatsuba 3 * 3: 18), then f by a
# product whose w^5 coefficient is 0 (Karatsuba over Fp6: f_0 g and
# (f_0 + f_1)(g + h) dense, f_1 h with h sparse, 6 + 6 + 5 Fp2 products)
LINES = 2 * 2 + 18
LINES_INTO_F = LINES + 17 * F2_MUL
# the Frobenius maps: p and p^3 multiply four coefficients by Fp2
# constants and one by an Fp constant; p^2's five constants lie in Fp
FROBENIUS = {1: 4 * F2_MUL + 2, 2: 5 * 2, 3: 4 * F2_MUL + 2}
# f12_inv: g^2 and h^2, then f6_inv (its cofactors 3 F2_SQR + 3 F2_MUL,
# the norm 3 F2_MUL, the Fp2 inverse 2 + 2 around the Fp inverse, the
# cofactors by it 3 F2_MUL), then g and h by its result
F6_INV = 3 * F2_SQR + 9 * F2_MUL + 4
F12_INV = 2 * F6_SQR + F6_INV + 2 * F6_MUL
# the Fp inverse, batched over a launch by Montgomery's trick: 3
# multiplies a check and one Fermat chain a launch (`imads_per_launch`)
INV_BATCH_MULS = 3
INV_CHAIN = {("bn254", "mul"): bin(P - 2)[3:].count("1"),
             ("bn254", "sqr"): (P - 2).bit_length() - 1}


def fp_ops_per_check(flags) -> dict:
    """Fp multiplies one check needs at least, keyed like `field.IMADS`:
    the coordinates to Montgomery form (4); the dual Miller loop, whose
    first step (f = 1) is only its two lines and whose later steps square
    f when flagged and multiply in both lines; the easy part (an
    inversion, two Fp12 products, Frobenius p^2); the hard part (three
    |u|-powers of cyclotomic squares and products, 7 Frobenius maps, 13
    products and 4 cyclotomic squares).  The Fp inverse counts as
    batched: `INV_CHAIN` is added once per launch.  The work does not
    depend on the coordinates."""
    flags = [int(v) for v in flags]
    miller = LINES + sum(flags[1:]) * F12_SQR + \
        (len(flags) - 1) * LINES_INTO_F
    pow_u = (X_ABS.bit_length() - 1) * F12_CYC_SQR + \
        (bin(X_ABS).count("1") - 1) * F12_MUL
    easy = F12_INV + INV_BATCH_MULS + 2 * F12_MUL + FROBENIUS[2]
    hard = 3 * pow_u + 4 * FROBENIUS[1] + 2 * FROBENIUS[2] + \
        FROBENIUS[3] + 13 * F12_MUL + 4 * F12_CYC_SQR
    return {("bn254", "mul"): 4 + miller + easy + hard}


def imads_per_check(flags) -> int:
    """32-bit multiply-adds of one check's field work (`field.IMADS`)."""
    return sum(IMADS[k] * c for k, c in fp_ops_per_check(flags).items())


def imads_per_launch() -> int:
    """32-bit multiply-adds of the one Fermat chain a launch's batched
    Fp inversion needs, on top of the per-check counts."""
    return sum(IMADS[k] * c for k, c in INV_CHAIN.items())


def fp_ops_issued(flags) -> int:
    """Fp multiplies and squares KB8 issues for one check: each Fp2
    product by Karatsuba (3), each Fp12 product and square schoolbook
    (36 Fp2 products), a sparse line product as 6 * (2 + 2 * 3), every
    Frobenius as 6 Fp2 products, the |u|-powers by square and multiply,
    the inversion as 4 Fp6 products, 12 Fp2 products and 4, plus its own
    Fermat chain.  Set beside `fp_ops_per_check`, it is the work a
    dedicated squaring, cyclotomic squares and Karatsuba Fp12 products
    would save."""
    f12 = 36 * F2_MUL
    frob = 6 * F2_MUL
    flags = [int(v) for v in flags]
    miller = sum(flags) * f12 + len(flags) * 2 * (2 + 6 * (2 + 2 * F2_MUL))
    pow_u = (X_ABS.bit_length() - 1 + bin(X_ABS).count("1") - 1) * f12
    inv = 4 * F6_MUL + 12 * F2_MUL + 4 + sum(INV_CHAIN.values())
    easy = inv + 2 * f12 + frob
    hard = 3 * pow_u + 7 * frob + 17 * f12
    return 4 + miller + easy + hard
