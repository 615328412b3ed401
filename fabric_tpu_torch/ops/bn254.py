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
int64 limbs of `field.py` with every value fully reduced.  It repeats
KB8's least-work tower (`f2_sqr`, `f12_mul_karatsuba`,
`f12_sqr_complex`, `f12_cyc_sqr`, `lines_product`, `f12_mul_by_lines`,
`f12_frobenius`), each formula's Fp2 products stacked into one wide call
of the field layer.  `bn254_pairing_check` is the wrapper of the CUDA kernel KB8 (`csrc/bn254_pairing.cu`) and
`bn254_tower_probe` of its tower probe; for CPU tensors each runs its
plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from . import _build
from .field import (BN254 as P, IMADS, LIMBS, LIMB_BITS, MASK, fbn as fp,
                    int_to_limbs, limbs_to_words_le, normalize,
                    words_le_to_limbs)
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


def f2_sqr(a: torch.Tensor) -> torch.Tensor:
    """(a0 + a1)(a0 - a1) + 2 a0 a1 i: 2 Fp multiplies, one wide call
    for every square of a."""
    a0, a1 = a.select(-2, 0), a.select(-2, 1)
    t = fp.mul(torch.stack([fp.add(a0, a1), a0], -2),
               torch.stack([fp.sub(a0, a1), a1], -2))
    t1 = t.select(-2, 1)
    return torch.stack([t.select(-2, 0), fp.add(t1, t1)], -2)


def _xi_lazy(x: torch.Tensor) -> torch.Tensor:
    """x * xi on lazy limbs, no reduction."""
    x0, x1 = x.select(-2, 0), x.select(-2, 1)
    return torch.stack([x0 - x1, x0 + x1], -2)


# -- Fp6 = Fp2[v]/(v^3 - xi), v = w^2: (16, ..., 3, 2, B), v^i on dim -3 ----
# An Fp12 f is g + h w with g = (c0, c2, c4) and h = (c1, c3, c5) in Fp6.

def _v_lazy(x: torch.Tensor) -> torch.Tensor:
    """x * v = (xi x2, x0, x1), lazy."""
    return torch.stack([_xi_lazy(x.select(-3, 2)), x.select(-3, 0),
                        x.select(-3, 1)], -3)


def _f6_operands(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The 6 Fp2 factor pairs of a Karatsuba product over Fp6: (a_i, b_i)
    and the pair sums (1, 2), (0, 1), (0, 2) -> two (16, ..., 6, 2, B)."""
    a, b = torch.broadcast_tensors(a, b)
    i, j = [1, 0, 0], [2, 1, 2]
    return (torch.cat([a, fp.add(a[..., i, :, :], a[..., j, :, :])], -3),
            torch.cat([b, fp.add(b[..., i, :, :], b[..., j, :, :])], -3))


def _f6_combine(t: torch.Tensor) -> torch.Tensor:
    """The 6 lazy Fp2 products of `_f6_operands` -> the Fp6 product,
    lazy in (-10p, 10p) (idemix/bn254.py f6_mul)."""
    t0, t1, t2, t3, t4, t5 = t.unbind(-3)
    return torch.stack([t0 + _xi_lazy(t3 - t1 - t2),
                        t4 - t0 - t1 + _xi_lazy(t2),
                        t5 - t0 - t2 + t1], -3)


def _f6_01_operands(a: torch.Tensor, b0: torch.Tensor,
                    b1: torch.Tensor) -> tuple:
    """The 5 factor pairs of a times b0 + b1 v (b's v^2 coefficient 0):
    a0 b0, a1 b1, (a1 + a2) b1, (a0 + a1)(b0 + b1), (a0 + a2) b0."""
    a0, a1, a2 = a.unbind(-3)
    s = fp.add(torch.stack([a1, a0, a0], -3), torch.stack([a2, a1, a2], -3))
    x = torch.stack(torch.broadcast_tensors(a0, a1, *s.unbind(-3)), -3)
    y = torch.stack(torch.broadcast_tensors(b0, b1, b1, fp.add(b0, b1), b0),
                    -3)
    return x, y


def _f6_01_combine(t: torch.Tensor) -> torch.Tensor:
    t0, t1, t2, t3, t4 = t.unbind(-3)
    return torch.stack([t0 + _xi_lazy(t2 - t1), t3 - t0 - t1,
                        t4 - t0 + t1], -3)


def f6_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba over Fp2 (6 products, one wide call)."""
    return _reduce_lazy(_f6_combine(_f2_mul_lazy(*_f6_operands(a, b))))


def f6_inv(a: torch.Tensor) -> torch.Tensor:
    """(host f6_inv) the cofactors t0 = a0^2 - xi a1 a2, t1 = xi a2^2 -
    a0 a1, t2 = a1^2 - a0 a2 over the norm a0 t0 + xi (a2 t1 + a1 t2)."""
    a0, a1, a2 = a.unbind(-3)
    p = _f2_mul_lazy(torch.stack([a0, a1, a2, a0, a1, a0], -3),
                     torch.stack([a0, a2, a2, a1, a1, a2], -3))
    p0, p12, p22, p01, p11, p02 = p.unbind(-3)
    t = _reduce_lazy(torch.stack([p0 - _xi_lazy(p12), _xi_lazy(p22) - p01,
                                  p11 - p02], -3))
    n = _f2_mul_lazy(torch.stack([a0, a2, a1], -3), t)
    norm = _reduce_lazy(n.select(-3, 0) + _xi_lazy(n.select(-3, 1)
                                                   + n.select(-3, 2)))
    return f2_mul(t, f2_inv(norm).unsqueeze(-3))


def _gh(a: torch.Tensor) -> torch.Tensor:
    """Fp12 (16, 6, 2, B) -> (16, 2, 3, 2, B): [0] g, [1] h."""
    return a.unflatten(1, (3, 2)).transpose(1, 2)


def _from_gh(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """g + h w: (16, 3, 2, B) each -> (16, 6, 2, B)."""
    return torch.stack([g, h], 2).flatten(1, 2)


def f12_mul_karatsuba(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba over Fp6: g1 g2 + v h1 h2 + ((g1 + h1)(g2 + h2) - g1 g2
    - h1 h2) w, three Fp6 products (54 Fp multiplies) in one wide call."""
    x, y = _gh(a), _gh(b)
    x = torch.cat([x, fp.add(x[:, :1], x[:, 1:])], 1)
    y = torch.cat([y, fp.add(y[:, :1], y[:, 1:])], 1)
    gg, hh, ss = _reduce_lazy(_f6_combine(_f2_mul_lazy(
        *_f6_operands(x, y)))).unbind(1)
    return _reduce_lazy(_from_gh(gg + _v_lazy(hh), ss - gg - hh))


def f12_sqr_complex(a: torch.Tensor) -> torch.Tensor:
    """Complex squaring: with t = g h, f^2 = (g + h)(g + v h) - t - v t
    + 2 t w, two Fp6 products (36 Fp multiplies) in one wide call."""
    g, h = _gh(a).unbind(1)
    s = _reduce_lazy(torch.stack([g + h, g + _v_lazy(h)], 1))
    t, pr = _reduce_lazy(_f6_combine(_f2_mul_lazy(*_f6_operands(
        torch.stack([h, s[:, 0]], 1), torch.stack([g, s[:, 1]], 1))))
    ).unbind(1)
    return _reduce_lazy(_from_gh(pr - t - _v_lazy(t), t + t))


_CYC_SIGN: dict = {}


def f12_cyc_sqr(a: torch.Tensor) -> torch.Tensor:
    """Granger-Scott square of an element of the cyclotomic subgroup
    (9 Fp2 squares, 18 Fp multiplies, one wide call).  Over Fp4 =
    Fp2[s]/(s^2 - xi) with s = w^3, f = a + b w + c w^2 with a = c0 +
    c3 s, b = c1 + c4 s, c = c2 + c5 s, and f^2 = (3 a^2 - 2 conj a) +
    (3 s c^2 + 2 conj b) w + (3 b^2 - 2 conj c) w^2, conj the p^6-power
    (s -> -s).  Wrong outside the subgroup."""
    x0, x1 = a[:, :3], a[:, 3:]           # (c0, c1, c2), (c3, c4, c5)
    sq = f2_sqr(torch.cat([x0, x1, fp.add(x0, x1)], 1))
    s0, s1, s2 = sq[:, :3], sq[:, 3:6], sq[:, 6:]
    e = s0 + _xi_lazy(s1)                 # the squares of a, b, c at s^0
    o = s2 - s0 - s1                      # at s^1
    t = torch.cat([torch.stack([e[:, 0], _xi_lazy(o[:, 2]), e[:, 1]], 1),
                   torch.stack([o[:, 0], e[:, 2], o[:, 1]], 1)], 1)
    key = str(a.device)
    sign = _CYC_SIGN.get(key)
    if sign is None:                      # -2 at even powers of w, +2 odd
        sign = _CYC_SIGN[key] = torch.tensor(
            [-2, 2, -2, 2, -2, 2], device=a.device).reshape(1, 6, 1, 1)
    return _reduce_lazy(3 * t + sign * a)


def lines_product(y1, a1, b1, y2, a2, b2) -> torch.Tensor:
    """(y1 + a1 w + b1 w^3)(y2 + a2 w + b2 w^3) for y in Fp (16, B), a
    and b in Fp2 (16, 2, B): y1 y2 + xi b1 b2 + (y1 a2 + y2 a1) w +
    a1 a2 w^2 + (y1 b2 + y2 b1) w^3 + (a1 b2 + a2 b1) w^4, the last by
    Karatsuba.  1 + 8 Fp products and 3 Fp2 products (18 Fp multiplies)
    in one wide call -> Fp12 with c5 = 0."""
    bs = torch.broadcast_shapes(y1.shape[1:], y2.shape[1:], *(
        t.shape[2:] for t in (a1, b1, a2, b2)))
    y1, y2 = (y.unsqueeze(1).expand((LIMBS, 1) + bs) for y in (y1, y2))
    a1, b1, a2, b2 = (t.expand((LIMBS, 2) + bs) for t in (a1, b1, a2, b2))
    u = torch.stack([a1, b1, fp.add(a1, b1)], 1)     # (16, 3, 2, ...)
    v = torch.stack([a2, b2, fp.add(a2, b2)], 1)
    u0, u1, v0, v1 = u[:, :, 0], u[:, :, 1], v[:, :, 0], v[:, :, 1]
    y1_2, y2_2 = y1.expand_as(a1), y2.expand_as(a1)
    t = fp.mul(torch.cat([y1, y1_2, y2_2, y1_2, y2_2, u0, u1,
                          fp.add(u0, u1)], 1),
               torch.cat([y2, a2, a1, b2, b1, v0, v1, fp.add(v0, v1)], 1))
    k0, k1, k2 = t[:, 9:12], t[:, 12:15], t[:, 15:18]
    pa, pb, ps = torch.stack([k0 - k1, k2 - k0 - k1], 2).unbind(1)
    c0 = _xi_lazy(pb) + torch.cat([t[:, :1], torch.zeros_like(t[:, :1])], 1)
    return _reduce_lazy(torch.stack([
        c0, t[:, 1:3] + t[:, 3:5], pa, t[:, 5:7] + t[:, 7:9], ps - pa - pb,
        torch.zeros_like(pa)], 1))


def f12_mul_by_lines(f: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """f times a product of lines l (c5 = 0): Karatsuba over Fp6 with
    l's h = (c1, c3, 0) sparse, 6 + 5 + 6 Fp2 products (51 Fp
    multiplies) in one wide call."""
    f, l = torch.broadcast_tensors(f, l)
    fg, fh = _gh(f).unbind(1)
    lg, lh = _gh(l).unbind(1)
    xd, yd = _f6_operands(torch.stack([fg, fp.add(fg, fh)], 1),
                          torch.stack([lg, fp.add(lg, lh)], 1))
    xs, ys = _f6_01_operands(fh, lh[:, 0], lh[:, 1])
    t = _f2_mul_lazy(torch.cat([xd.flatten(1, 2), xs], 1),
                     torch.cat([yd.flatten(1, 2), ys], 1))
    gg, ss = _reduce_lazy(_f6_combine(t[:, :12].unflatten(1, (2, 6)))
                          ).unbind(1)
    hh = _reduce_lazy(_f6_01_combine(t[:, 12:]))
    return _reduce_lazy(_from_gh(gg + _v_lazy(hh), ss - gg - hh))


def f12_one(batch: int, device="cpu") -> torch.Tensor:
    f = torch.zeros((LIMBS, 6, 2, batch), dtype=torch.int64, device=device)
    f[:, 0, 0] = torch.tensor(int_to_limbs(fp.one_int), device=device)[:, None]
    return f


def f12_conj(a: torch.Tensor) -> torch.Tensor:
    """a^(p^6): the odd powers of w negated."""
    out = a.clone()
    out[:, 1::2] = f2_neg(a[:, 1::2])
    return out


_GAMMA: dict = {}


def _gamma(power: int, device) -> tuple:
    """GAMMA[power][1:] as Montgomery limbs (16, 5, 2, 1), and the
    powers k >= 1 whose constant lies in Fp (c1 = 0) and those whose
    does not, cached per device."""
    key = (power, str(device))
    got = _GAMMA.get(key)
    if got is None:
        vals = [mont(c) for g in hb.GAMMA[power][1:] for c in g]
        t = torch.tensor([int_to_limbs(v) for v in vals], dtype=torch.int64,
                         device=device)
        real = [k for k in range(1, 6) if hb.GAMMA[power][k][1] == 0]
        cplx = [k for k in range(1, 6) if k not in real]
        got = _GAMMA[key] = (t.T.reshape(LIMBS, 5, 2, 1), real, cplx)
    return got


def f12_frobenius(a: torch.Tensor, power: int) -> torch.Tensor:
    """a^(p^power), power 1, 2 or 3: c_k -> conj^power(c_k) * GAMMA[k].
    GAMMA[0] is 1, so c_0 is only conjugated; a constant in Fp (all of
    p^2's, p and p^3's at k = 4) multiplies as an Fp scalar."""
    c = f2_conj(a) if power % 2 else a
    g, real, cplx = _gamma(power, a.device)
    out = c.clone()
    out[:, real] = f2_scale(c[:, real], g[:, [k - 1 for k in real], 0])
    if cplx:
        out[:, cplx] = f2_mul(c[:, cplx], g[:, [k - 1 for k in cplx]])
    return out


def f12_inv(a: torch.Tensor) -> torch.Tensor:
    """Tower inversion (host f12_inv): a = g + h w with g, h in Fp6 over
    v = w^2; (g + h w)^-1 = (g - h w) / (g^2 - h^2 v)."""
    gh = _gh(a)
    sq = f6_mul(gh, gh)                    # g^2, h^2
    d = fp.sub(sq[:, 0], _reduce_lazy(_v_lazy(sq[:, 1])))
    gi, hi = f6_mul(gh, f6_inv(d).unsqueeze(1)).unbind(1)
    return _from_gh(gi, f2_neg(hi))


def _pow_abs_u(m: torch.Tensor) -> torch.Tensor:
    """m^|u| by square-and-multiply, the squares cyclotomic."""
    acc = m
    for bit in bin(X_ABS)[3:]:
        acc = f12_cyc_sqr(acc)
        if bit == "1":
            acc = f12_mul_karatsuba(acc, m)
    return acc


def _pow_u(m: torch.Tensor) -> torch.Tensor:
    """m^u (u < 0): conj inverts in the cyclotomic subgroup."""
    return f12_conj(_pow_abs_u(m))


def final_exp_hard(m: torch.Tensor) -> torch.Tensor:
    """m^((p^4 - p^2 + 1)/r) for m in the cyclotomic subgroup: the
    Devegili-Scott-Dominguez chain of the host's `final_exp_hard`, its
    squares cyclotomic and its products Karatsuba."""
    mul, sqr = f12_mul_karatsuba, f12_cyc_sqr
    f1 = _pow_u(m)
    f2 = _pow_u(f1)
    f3 = _pow_u(f2)
    y0 = mul(mul(f12_frobenius(m, 1), f12_frobenius(m, 2)),
             f12_frobenius(m, 3))
    y1 = f12_conj(m)
    y2 = f12_frobenius(f2, 2)
    y3 = f12_conj(f12_frobenius(f1, 1))
    y4 = f12_conj(mul(f1, f12_frobenius(f2, 1)))
    y5 = f12_conj(f2)
    y6 = f12_conj(mul(f3, f12_frobenius(f3, 1)))
    t0 = mul(mul(sqr(y6), y4), y5)
    t1 = mul(mul(y3, y5), t0)
    t0 = mul(t0, y2)
    t1 = mul(sqr(t1), t0)
    t1 = sqr(t1)
    t0 = sqr(mul(t1, y1))
    return mul(t0, mul(t1, y0))


def final_exp_easy(f: torch.Tensor) -> torch.Tensor:
    """f^((p^6 - 1)(p^2 + 1)): conj(f) * f^-1, then the p^2 Frobenius
    times itself; the result lies in the cyclotomic subgroup."""
    f = f12_mul_karatsuba(f12_conj(f), f12_inv(f))
    return f12_mul_karatsuba(f12_frobenius(f, 2), f)


def final_exp(f: torch.Tensor) -> torch.Tensor:
    """f^((p^12 - 1)/r): the easy part, then the hard part."""
    return final_exp_hard(final_exp_easy(f))


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


def _line_f12(y, ax, b) -> torch.Tensor:
    """The line y (w^0, y in Fp) + ax (w^1) + b (w^3) as an Fp12."""
    z = torch.zeros_like(ax)
    y2 = torch.stack([y, torch.zeros_like(y)], -2)
    return torch.stack(torch.broadcast_tensors(y2, ax, z, b, z, z), 1)


def miller_loop(flags, L, xm, ym, n_steps: int = None) -> torch.Tensor:
    """f_{lambda,Q}(P) in Montgomery form.  flags (S,); L (16, S, 2, 2,
    B or 1) Montgomery line limbs; xm, ym (16, B) Montgomery coordinates;
    n_steps limits the loop (prefix tests)."""
    flags = [int(v) for v in flags][:n_steps]
    ax = f2_scale(L[:, :, 0], xm[:, None])
    f = f12_one(xm.shape[-1], xm.device)
    for s, flag in enumerate(flags):
        if flag:
            f = f12_sqr_complex(f)
        f = f12_mul_by_lines(f, _line_f12(ym, ax[:, s], L[:, s, 1]))
    return f


def miller_loop_dual(flags, L1, L2, x1m, y1m, x2m, y2m,
                     n_steps: int = None) -> torch.Tensor:
    """f_{lambda,Q1}(P1) * f_{lambda,Q2}(P2) with shared squarings: the
    two step lists come from one ATE_LAMBDA, so each step squares f once
    (flag 1, complex squaring) and multiplies in the product of its two
    lines; on the first step f = 1 becomes that product (KB8's loop)."""
    flags = [int(v) for v in flags][:n_steps]
    ax1 = f2_scale(L1[:, :, 0], x1m[:, None])  # A x of every step at once
    ax2 = f2_scale(L2[:, :, 0], x2m[:, None])
    f = f12_one(x1m.shape[-1], x1m.device)
    for s, flag in enumerate(flags):
        lines = lines_product(y1m, ax1[:, s], L1[:, s, 1],
                              y2m, ax2[:, s], L2[:, s, 1])
        if s == 0:
            f = lines
            continue
        if flag:
            f = f12_sqr_complex(f)
        f = f12_mul_by_lines(f, lines)
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
# The tower probe: one of KB8's tower routines per thread
# ---------------------------------------------------------------------------
# Inputs and output (6, 2, 8, n) uint32: coefficient k of w, c0 or c1,
# little-endian word, input; Montgomery form (R = 2^256), fully reduced.

PROBE_OPS = ("mul", "sqr", "cyc_sqr", "mul_by_lines", "pow_u", "final_exp")
BINARY_OPS = ("mul", "mul_by_lines")


def f12_to_words(f: torch.Tensor) -> torch.Tensor:
    """(16, 6, 2, n) canonical limbs -> (6, 2, 8, n) uint32 words."""
    n = f.shape[-1]
    w = limbs_to_words_le(f.reshape(LIMBS, -1))           # (12 n, 8)
    return w.reshape(6, 2, n, 8).permute(0, 1, 3, 2).contiguous()


def words_to_f12(w: torch.Tensor) -> torch.Tensor:
    """(6, 2, 8, n) uint32 words -> (16, 6, 2, n) limbs."""
    n = w.shape[-1]
    flat = words_le_to_limbs(w.permute(0, 1, 3, 2).reshape(-1, 8))
    return flat.reshape(LIMBS, 6, 2, n)


def tower_probe_plain(op: str, a: torch.Tensor,
                      b: torch.Tensor = None) -> torch.Tensor:
    """The plain version of the probe: op on (6, 2, 8, n) words."""
    x = words_to_f12(a)
    if op == "mul":
        r = f12_mul_karatsuba(x, words_to_f12(b))
    elif op == "sqr":
        r = f12_sqr_complex(x)
    elif op == "cyc_sqr":
        r = f12_cyc_sqr(x)
    elif op == "mul_by_lines":
        y = words_to_f12(b)
        r = f12_mul_by_lines(x, lines_product(y[:, 0, 0], y[:, 1], y[:, 3],
                                              y[:, 0, 1], y[:, 2], y[:, 4]))
    elif op == "pow_u":
        r = _pow_u(x)
    elif op == "final_exp":
        r = final_exp(x)
    else:
        raise ValueError(f"unknown tower op {op!r}; one of {PROBE_OPS}")
    return f12_to_words(r)


def bn254_tower_probe(op: str, a: torch.Tensor,
                      b: torch.Tensor = None) -> torch.Tensor:
    """Wrapper of KB8's tower probe (`bn254_tower_probe_launch`, in
    KB8's library): op (`PROBE_OPS`) on each input, one thread each;
    `BINARY_OPS` take b of a's shape.  mul_by_lines multiplies a by the
    product of the lines y1 = b.c0.c0, A x = b.c1, B = b.c3 and y2 =
    b.c0.c1, A x = b.c2, B = b.c4.  CUDA tensors launch the kernel on
    the current stream; CPU tensors take `tower_probe_plain`.  Inputs
    must be fully reduced: the kernel does not check."""
    if op not in PROBE_OPS:
        raise ValueError(f"unknown tower op {op!r}; one of {PROBE_OPS}")
    if a.dim() != 4 or tuple(a.shape[:3]) != (6, 2, 8) \
            or a.dtype != torch.uint32 or not a.is_contiguous():
        raise ValueError("a must be a contiguous (6, 2, 8, n) uint32 tensor")
    if (b is not None) != (op in BINARY_OPS):
        raise ValueError(f"{op} takes {2 if op in BINARY_OPS else 1} "
                         "input(s)")
    if b is not None and (b.shape != a.shape or b.dtype != a.dtype
                          or not b.is_contiguous() or b.device != a.device):
        raise ValueError("b must be a contiguous uint32 tensor of a's shape "
                         "on a's device")
    dev = a.device
    if dev.type == "cpu":
        return tower_probe_plain(op, a, b)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty_like(a)
    n = a.shape[-1]
    if n == 0:
        return out
    lib = _build.load("bn254_pairing")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bn254_tower_probe_launch(
            ctypes.c_int(PROBE_OPS.index(op)), ctypes.c_void_p(a.data_ptr()),
            ctypes.c_void_p((a if b is None else b).data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_int(n),
            ctypes.c_int(THREADS), ctypes.c_void_p(stream))
    if rc:
        raise RuntimeError(f"bn254_tower_probe launch failed: CUDA error {rc}")
    bn254_tower_probe.launches += 1
    return out


bn254_tower_probe.launches = 0


# ---------------------------------------------------------------------------
# Work count for the kernel's bound
# ---------------------------------------------------------------------------

# Fp multiplies of each tower operation (the square of an Fp2
# coefficient counts as two Fp multiplies; only the Fermat chain's are Fp
# squares).  KB8 issues these, but for two: the least known is
# Karabina's compressed square in the cyclotomic subgroup (KB8:
# Granger-Scott's) and a launch-wide batched inversion (KB8: one Fermat
# chain a thread).
F2_MUL = 3                      # Karatsuba
F2_SQR = 2                      # (a + b)(a - b), 2ab
F6_MUL = 6 * F2_MUL             # Karatsuba over Fp2
F6_SQR = 2 * F2_MUL + 3 * F2_SQR          # Chung-Hasan SQR2
F12_MUL = 3 * F6_MUL            # Karatsuba over Fp6: 54
F12_SQR = 2 * F6_MUL            # complex squaring: 36
# a square in the cyclotomic subgroup: Granger-Scott's three Fp4 squares
# of 3 Fp2 squares each (KB8), and Karabina's compressed squaring (the
# least; its decompressions are left out, which only lowers the count)
GS_SQR = 9 * F2_SQR
F12_CYC_SQR = 6 * F2_SQR
# a Miller step's two lines: A*x for each (2 + 2), their product (the
# Fp terms 1 + 4 * 2, the Fp2 terms by Karatsuba 3 * 3: 18), then f by a
# product whose w^5 coefficient is 0 (Karatsuba over Fp6: f_0 g and
# (f_0 + f_1)(g + h) dense, f_1 h with h sparse, 6 + 6 + 5 Fp2 products)
LINES = 2 * 2 + 18
LINES_INTO_F = LINES + 17 * F2_MUL
# the Frobenius maps: c_0's constant is 1; p and p^3 multiply four
# coefficients by Fp2 constants and one by an Fp constant; p^2's five
# constants lie in Fp
FROBENIUS = {1: 4 * F2_MUL + 2, 2: 5 * 2, 3: 4 * F2_MUL + 2}
# the Fp inverse: Fermat's chain; batched over a launch by Montgomery's
# trick it costs 3 multiplies a check and one chain a launch
# (`imads_per_launch`)
INV_CHAIN = {("bn254", "mul"): bin(P - 2)[3:].count("1"),
             ("bn254", "sqr"): (P - 2).bit_length() - 1}
INV_BATCH_MULS = 3
# f12_inv at least: g^2 and h^2, then f6_inv (its cofactors 3 F2_SQR +
# 3 F2_MUL, the norm 3 F2_MUL, the Fp2 inverse 2 + 2 around the Fp
# inverse, the cofactors by it 3 F2_MUL), then g and h by its result
F6_INV = 3 * F2_SQR + 9 * F2_MUL + 4
F12_INV = 2 * F6_SQR + F6_INV + 2 * F6_MUL + INV_BATCH_MULS
# KB8's: four Fp6 products, f6_inv's 12 Fp2 products and 4 around the
# thread's own Fermat chain
F12_INV_ISSUED = 4 * F6_MUL + 12 * F2_MUL + 4 + sum(INV_CHAIN.values())


def _miller_ops(flags) -> int:
    """The dual Miller loop: the first step (f = 1) is only its two
    lines; each later step squares f when flagged and multiplies in both
    lines."""
    flags = [int(v) for v in flags]
    return LINES + sum(flags[1:]) * F12_SQR + \
        (len(flags) - 1) * LINES_INTO_F


def _pow_u_ops(cyc_sqr: int) -> int:
    return (X_ABS.bit_length() - 1) * cyc_sqr + \
        (bin(X_ABS).count("1") - 1) * F12_MUL


def _final_exp_ops(cyc_sqr: int, inv: int) -> int:
    """The easy part (an inversion, two products, Frobenius p^2), then
    the hard part (three |u|-powers, 7 Frobenius maps, 13 products and 4
    cyclotomic squares)."""
    easy = inv + 2 * F12_MUL + FROBENIUS[2]
    hard = 3 * _pow_u_ops(cyc_sqr) + 4 * FROBENIUS[1] + \
        2 * FROBENIUS[2] + FROBENIUS[3] + 13 * F12_MUL + 4 * cyc_sqr
    return easy + hard


def fp_ops_per_check(flags) -> dict:
    """Fp multiplies one check needs at least, keyed like `field.IMADS`:
    the coordinates to Montgomery form (4), the dual Miller loop, the
    final exponentiation with compressed cyclotomic squares and the Fp
    inverse batched (`INV_CHAIN` is added once per launch).  The work
    does not depend on the coordinates."""
    return {("bn254", "mul"): 4 + _miller_ops(flags)
            + _final_exp_ops(F12_CYC_SQR, F12_INV)}


def imads_per_check(flags) -> int:
    """32-bit multiply-adds of one check's field work (`field.IMADS`)."""
    return sum(IMADS[k] * c for k, c in fp_ops_per_check(flags).items())


def imads_per_launch() -> int:
    """32-bit multiply-adds of the one Fermat chain a launch's batched
    Fp inversion needs, on top of the per-check counts."""
    return sum(IMADS[k] * c for k, c in INV_CHAIN.items())


def fp_ops_issued(flags) -> int:
    """Fp multiplies and squares KB8 issues for one check: the least
    work (`fp_ops_per_check`) but for Granger-Scott's cyclotomic squares
    (18 in place of 12) and each thread's own tower inversion and Fermat
    chain."""
    return 4 + _miller_ops(flags) + _final_exp_ops(GS_SQR, F12_INV_ISSUED)


# The tower probe's ops -> (least, issued) Fp multiplies per input, its
# Fermat chain counted in final_exp's issued figure only; mul_by_lines
# takes its lines' A*x as given.
PROBE_FP_OPS = {
    "mul": (F12_MUL, F12_MUL),
    "sqr": (F12_SQR, F12_SQR),
    "cyc_sqr": (F12_CYC_SQR, GS_SQR),
    "mul_by_lines": (LINES_INTO_F - 4, LINES_INTO_F - 4),
    "pow_u": (_pow_u_ops(F12_CYC_SQR), _pow_u_ops(GS_SQR)),
    "final_exp": (_final_exp_ops(F12_CYC_SQR, F12_INV),
                  _final_exp_ops(GS_SQR, F12_INV_ISSUED)),
}
