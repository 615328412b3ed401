"""Pure-Python Ed25519 (RFC 8032) host operations — fallback engine.

Extended homogeneous coordinates, a lazily-built 4-bit fixed-comb table
for the base point, and a per-verify window for the public-key point.
Same performance envelope as _p256: ~1 ms/op, dev-topology grade (the
port's software provider, and so the oracle of the Ed25519 kernels, on
hosts without `cryptography`).
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

P = 2 ** 255 - 19
L = 2 ** 252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, -1, P) % P
_SQRT_M1 = pow(2, (P - 1) // 4, P)

# extended coords (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z
_Ext = Tuple[int, int, int, int]
_ID: _Ext = (0, 1, 1, 0)

_BY = 4 * pow(5, -1, P) % P
_BX = 0


def _recover_x(y: int, sign: int) -> Optional[int]:
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, -1, P) % P
    if x2 == 0:
        if sign:
            return None
        return 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * _SQRT_M1 % P
    if (x * x - x2) % P:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
_BASE: _Ext = (_BX, _BY, 1, _BX * _BY % P)


def _add(p: _Ext, q: _Ext) -> _Ext:
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    a = (Y1 - X1) * (Y2 - X2) % P
    b = (Y1 + X1) * (Y2 + X2) % P
    c = 2 * T1 * T2 * D % P
    d = 2 * Z1 * Z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _double(p: _Ext) -> _Ext:
    return _add(p, p)


def _mult(k: int, pt: _Ext) -> _Ext:
    tbl = [pt]
    for _ in range(14):
        tbl.append(_add(tbl[-1], pt))
    acc = _ID
    nibbles = []
    while k:
        nibbles.append(k & 0xF)
        k >>= 4
    for d in reversed(nibbles):
        acc = _double(_double(_double(_double(acc))))
        if d:
            acc = _add(acc, tbl[d - 1])
    return acc


_BTBL: Optional[list] = None


def _mult_base(k: int) -> _Ext:
    global _BTBL
    if _BTBL is None:
        tbl = []
        base = _BASE
        for _ in range(64):
            row = [base]
            for _ in range(14):
                row.append(_add(row[-1], base))
            tbl.append(row)
            base = _add(row[-1], base)  # 16 * (16^w * B)
        _BTBL = tbl
    acc = _ID
    w = 0
    k %= L
    while k:
        d = k & 0xF
        if d:
            acc = _add(acc, _BTBL[w][d - 1])
        k >>= 4
        w += 1
    return acc


def _compress(p: _Ext) -> bytes:
    X, Y, Z, _ = p
    zi = pow(Z, -1, P)
    x = X * zi % P
    y = Y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decompress(data: bytes) -> Optional[_Ext]:
    if len(data) != 32:
        return None
    n = int.from_bytes(data, "little")
    sign = n >> 255
    y = n & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _h(data: bytes) -> int:
    return int.from_bytes(hashlib.sha512(data).digest(), "little")


def _clamp(seed_hash: bytes) -> int:
    a = int.from_bytes(seed_hash[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def public_from_seed(seed: bytes) -> bytes:
    if len(seed) != 32:
        raise ValueError("Ed25519 seed must be 32 bytes")
    h = hashlib.sha512(seed).digest()
    return _compress(_mult_base(_clamp(h)))


def sign(seed: bytes, msg: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    prefix = h[32:]
    A = _compress(_mult_base(a))
    r = _h(prefix + msg) % L
    R = _compress(_mult_base(r))
    k = _h(R + A + msg) % L
    s = (r + k * a) % L
    return R + s.to_bytes(32, "little")


def verify(pub: bytes, sig: bytes, msg: bytes) -> bool:
    if len(sig) != 64 or len(pub) != 32:
        return False
    A = _decompress(pub)
    R = _decompress(sig[:32])
    if A is None or R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = _h(sig[:32] + pub + msg) % L
    # [s]B == R + [k]A  <=>  [s]B + [k](-A) == R
    nA = (P - A[0], A[1], A[2], P - A[3])
    lhs = _add(_mult_base(s), _mult(k, nA))
    return _compress(lhs) == sig[:32]
