"""Host builder of the Ed25519 niels comb tables, in the port's layout.

Counterpart of `fabric_tpu/ops/ed25519_tables.py` (`decompress_int`,
`on_curve`, `comb_table_for_point`, `basepoint_table`, and the table of
-A that `fabric_tpu/bccsp/jaxtpu.py`'s Ed25519 `DeviceBank` builds).  A
table holds, for window j in [0, 37) and m in [1, 65), the niels triple
of m * 2^(7j) * T at row j*65 + m, and the identity's (1, 1, 0) at row
j*65.  The basepoint's table serves both Ed25519 lanes; a public key's
table, of -A, serves the fixed-key lane (KE6) from the device bank.

Port layout: (2405, 24) uint32, y - x in words 0..7, y + x in 8..15 and
2dxy in 16..23, each the Montgomery form v * 2^256 mod p as
little-endian 32-bit limbs: 96 bytes a row, 230,880 bytes a table.  The
reference stores (2405, 66) f32 rows of 22 12-bit limbs with R = 2^264
for its one-hot matmul lookup; `from_jax_comb_table` converts one into
the other.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .edwards import (BX, BY, COMB_ROWS, COMB_W, COMB_WINDOWS, D, P,
                      ROW_WORDS, ROWS, SQRT_M1)

R_PORT = 1 << 256              # the port's Montgomery radix
R_JAX = 1 << 264               # the reference's (22 limbs x 12 bits)
TABLE_BYTES = ROWS * ROW_WORDS * 4


# -- python-int extended-coordinate arithmetic -------------------------------

def _ext_add(p1, p2):
    X1, Y1, Z1, T1 = p1
    X2, Y2, Z2, T2 = p2
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = 2 * D * T1 % P * T2 % P
    Dv = 2 * Z1 * Z2 % P
    E, F, G, H = B - A, Dv - C, Dv + C, B + A
    return E * F % P, G * H % P, F * G % P, E * H % P


def _ext_dbl(p):
    X1, Y1, Z1, _ = p
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    H = A + B
    E = H - (X1 + Y1) * (X1 + Y1)
    G = A - B
    F = C + G
    return E * F % P, G * H % P, F * G % P, E * H % P


def _batch_to_affine(points):
    """Extended -> affine with one inversion (Montgomery's trick)."""
    zs = [pt[2] for pt in points]
    prefix = [1]
    for z in zs:
        prefix.append(prefix[-1] * z % P)
    inv_all = pow(prefix[-1], P - 2, P)
    out = [None] * len(points)
    for i in range(len(points) - 1, -1, -1):
        z_inv = inv_all * prefix[i] % P
        inv_all = inv_all * zs[i] % P
        X, Y, _, _ = points[i]
        out[i] = (X * z_inv % P, Y * z_inv % P)
    return out


def on_curve(x: int, y: int) -> bool:
    """-x^2 + y^2 == 1 + d x^2 y^2 (twisted Edwards, a = -1)."""
    x2, y2 = x * x % P, y * y % P
    return (y2 - x2 - 1 - D * x2 % P * y2) % P == 0


def decompress_int(pk: bytes) -> Optional[tuple]:
    """RFC 8032 5.1.3 decompression with python ints -> (x, y), or None
    for a wrong length, y >= p, a y with no x, or x = 0 with sign 1."""
    if len(pk) != 32:
        return None
    enc = int.from_bytes(pk, "little")
    sign = (enc >> 255) & 1
    y = enc & ((1 << 255) - 1)
    if y >= P:
        return None
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = u * pow(v, P - 2, P) % P           # x^2
    cand = pow(x, (P + 3) // 8, P)
    if cand * cand % P != x:
        cand = cand * SQRT_M1 % P
        if cand * cand % P != x:
            return None
    if cand == 0 and sign == 1:
        return None
    if cand & 1 != sign:
        cand = (-cand) % P
    return cand, y


def _words(vals) -> np.ndarray:
    """python ints (< 2^256) -> (len, 8) uint32 little-endian limbs."""
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, "<u4").reshape(-1, 8).astype(np.uint32)


def comb_table_for_point(x: int, y: int) -> np.ndarray:
    """(2405, 24) uint32 niels comb table of T = (x, y) in the port
    layout.  Raises ValueError for a point not on the curve."""
    if not (0 <= x < P and 0 <= y < P and on_curve(x, y)):
        raise ValueError("point not on edwards25519")
    ext = []                      # (window, m) in order, m = 1..64
    base = (x, y, 1, x * y % P)
    for _ in range(COMB_WINDOWS):
        acc = base
        ext.append(acc)
        for _ in range(COMB_ROWS - 2):
            acc = _ext_add(acc, base)
            ext.append(acc)
        for _ in range(COMB_W):
            base = _ext_dbl(base)
    d2 = 2 * D % P
    vals = []
    one = R_PORT % P
    aff = iter(_batch_to_affine(ext))
    for _ in range(COMB_WINDOWS):
        vals += [one, one, 0]                        # the identity's row
        for _ in range(1, COMB_ROWS):
            px, py = next(aff)
            vals += [(py - px) * R_PORT % P, (py + px) * R_PORT % P,
                     d2 * px % P * py % P * R_PORT % P]
    return _words(vals).reshape(ROWS, ROW_WORDS)


@functools.lru_cache(maxsize=1)
def basepoint_table() -> np.ndarray:
    """The comb table of the RFC 8032 basepoint B (read-only, built
    once)."""
    tab = comb_table_for_point(BX, BY)
    tab.setflags(write=False)
    return tab


def b_table(device) -> torch.Tensor:
    """B's comb table as a (2405, 24) uint32 tensor on `device`."""
    return torch.from_numpy(basepoint_table().copy()).to(device)


def table_for_pubkey(pubkey: bytes) -> Optional[np.ndarray]:
    """Comb table of -A for a 32-byte Ed25519 public key A (the verify
    equation adds [k](-A)), or None for a key that does not decompress
    (the fixed-key lane's only check of A: such a key never gets a table
    and stays on the generic lane, which rejects it)."""
    aff = decompress_int(bytes(pubkey))
    if aff is None:
        return None
    ax, ay = aff
    return comb_table_for_point((-ax) % P, ay)


def from_jax_comb_table(arr: np.ndarray) -> torch.Tensor:
    """Reference niels table -> port layout (CPU tensor).

    arr: (2405, 66) f32 as `fabric_tpu.ops.ed25519_tables.
    comb_table_for_point` builds it: each row the three coordinates'
    limbs (22 x 12 bits, little-endian) of their Montgomery forms with
    R = 2^264.  Each goes rows -> ints -> out of the 2^264 domain -> into
    the 2^256 domain -> limbs."""
    arr = np.asarray(arr)
    if arr.shape != (ROWS, 66):
        raise ValueError(f"expected shape ({ROWS}, 66), got {arr.shape}")
    limbs = arr.astype(np.int64)
    if (limbs != arr).any() or limbs.min() < 0 or limbs.max() >= 1 << 12:
        raise ValueError("table entries must be 12-bit integer limbs")
    shift = pow(R_JAX, -1, P) * R_PORT % P
    vals = []
    for row in limbs.tolist():
        for c in range(3):
            v = sum(int(b) << (12 * i)
                    for i, b in enumerate(row[22 * c:22 * (c + 1)]))
            vals.append(v % P * shift % P)
    return torch.from_numpy(_words(vals).reshape(ROWS, ROW_WORDS))
