"""Host builder of fixed-base comb tables for ECDSA-P256, in the port's
layout, and the host LRU of per-key tables.

Counterpart of `fabric_tpu/ops/p256_tables.py` (`comb_table_for_point`,
with its python-int Jacobian helpers, and `KeyTableCache`).  The
generator's table serves both lanes; a public key's table serves the
fixed-key lane (KP3), from the device bank of `ops/device_bank.py`.  A
table holds, for window j in [0, 32) and digit k in [0, 256), the affine
point k * 2^(8j) * T at row j*256 + k; rows with k = 0 are zero (the
kernels never read them).

Port layout: (8192, 16) uint32, x in words 0..7 and y in words 8..15,
each the Montgomery form x * 2^256 mod p as little-endian 32-bit limbs —
64 bytes a row, 512 KB a table.  The reference stores (8192, 44) f32 rows
of 22 12-bit limbs with R = 2^264 for its one-hot matmul lookup;
`from_jax_comb_table` converts one into the other.
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
A = P - 3
B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5

COMB_W = 8
COMB_WINDOWS = 32
COMB_ENTRIES = 1 << COMB_W
ROWS = COMB_WINDOWS * COMB_ENTRIES
ROW_WORDS = 16
R_PORT = 1 << 256              # the port's Montgomery radix
R_JAX = 1 << 264               # the reference's (22 limbs x 12 bits)


# -- python-int Jacobian arithmetic (no inversions until the end) ------------

def _jdbl(pt):
    X, Y, Z = pt
    delta = Z * Z % P
    gamma = Y * Y % P
    beta = X * gamma % P
    alpha = 3 * (X - delta) * (X + delta) % P
    X3 = (alpha * alpha - 8 * beta) % P
    Z3 = ((Y + Z) * (Y + Z) - gamma - delta) % P
    Y3 = (alpha * (4 * beta - X3) - 8 * gamma * gamma) % P
    return X3, Y3, Z3


def _jadd(p1, p2):
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if Z1 == 0:
        return p2
    if Z2 == 0:
        return p1
    z1z1 = Z1 * Z1 % P
    z2z2 = Z2 * Z2 % P
    u1 = X1 * z2z2 % P
    u2 = X2 * z1z1 % P
    s1 = Y1 * Z2 * z2z2 % P
    s2 = Y2 * Z1 * z1z1 % P
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    if h == 0:
        if r == 0:
            return _jdbl(p1)
        return (1, 1, 0)
    h2 = h * h % P
    h3 = h * h2 % P
    u1h2 = u1 * h2 % P
    X3 = (r * r - h3 - 2 * u1h2) % P
    Y3 = (r * (u1h2 - X3) - s1 * h3) % P
    Z3 = Z1 * Z2 * h % P
    return X3, Y3, Z3


def _batch_to_affine(points):
    """Jacobian -> affine with one modular inversion (Montgomery's
    trick).  No infinities allowed."""
    zs = [pt[2] for pt in points]
    prefix = [1]
    for z in zs:
        prefix.append(prefix[-1] * z % P)
    inv_all = pow(prefix[-1], P - 2, P)
    out = [None] * len(points)
    for i in range(len(points) - 1, -1, -1):
        z_inv = inv_all * prefix[i] % P
        inv_all = inv_all * zs[i] % P
        z2 = z_inv * z_inv % P
        X, Y, _ = points[i]
        out[i] = (X * z2 % P, Y * z2 % P * z_inv % P)
    return out


def on_curve(qx: int, qy: int) -> bool:
    if not (0 <= qx < P and 0 <= qy < P):
        return False
    return (qy * qy - (qx * qx * qx + A * qx + B)) % P == 0


def _words_le(x: int) -> list:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def comb_table_for_point(qx: int, qy: int) -> np.ndarray:
    """(8192, 16) uint32 comb table of Q = (qx, qy) in the port layout.
    Raises ValueError for a point not on the curve."""
    if not on_curve(qx, qy):
        raise ValueError("point not on P-256")
    jac = []                      # (window, k) in order, k = 1..255
    base = (qx, qy, 1)
    for _ in range(COMB_WINDOWS):
        acc = base
        jac.append(acc)
        for _ in range(COMB_ENTRIES - 2):
            acc = _jadd(acc, base)
            jac.append(acc)
        for _ in range(COMB_W):
            base = _jdbl(base)
    affine = _batch_to_affine(jac)
    rows = np.zeros((ROWS, ROW_WORDS), dtype=np.uint32)
    idx = 0
    for j in range(COMB_WINDOWS):
        for k in range(1, COMB_ENTRIES):
            x, y = affine[idx]
            idx += 1
            rows[j * COMB_ENTRIES + k] = (_words_le(x * R_PORT % P)
                                          + _words_le(y * R_PORT % P))
    return rows


@functools.lru_cache(maxsize=1)
def g_comb_table() -> np.ndarray:
    """The comb table of the generator G (read-only, built once)."""
    tab = comb_table_for_point(GX, GY)
    tab.setflags(write=False)
    return tab


def g_table(device) -> torch.Tensor:
    """G's comb table as a (8192, 16) uint32 tensor on `device`."""
    return torch.from_numpy(g_comb_table().copy()).to(device)


def from_jax_comb_table(arr: np.ndarray) -> torch.Tensor:
    """Reference comb table -> port layout (CPU tensor).

    arr: (8192, 44) f32 as `fabric_tpu.ops.p256_tables.comb_table_for_point`
    builds it, for G or for a public key (the reference's per-key tables
    have G's format) — each row the x and y limbs (22 x 12 bits,
    little-endian) of the Montgomery form with R = 2^264.  Each coordinate goes rows ->
    ints -> out of the 2^264 domain -> into the 2^256 domain -> limbs."""
    arr = np.asarray(arr)
    if arr.shape != (ROWS, 44):
        raise ValueError(f"expected shape ({ROWS}, 44), got {arr.shape}")
    limbs = arr.astype(np.int64)
    if (limbs != arr).any() or limbs.min() < 0 or limbs.max() >= 1 << 12:
        raise ValueError("table entries must be 12-bit integer limbs")
    shift = pow(R_JAX, -1, P) * R_PORT % P
    out = np.zeros((ROWS, ROW_WORDS), dtype=np.uint32)
    for half in (0, 1):
        cols = limbs[:, 22 * half:22 * (half + 1)].tolist()
        for row, col in enumerate(cols):
            v = sum(int(c) << (12 * i) for i, c in enumerate(col))
            out[row, 8 * half:8 * half + 8] = _words_le(v % P * shift % P)
    return torch.from_numpy(out)


def table_for_pubkey(pubkey: bytes) -> Optional[np.ndarray]:
    """Comb table of an uncompressed SEC1 P-256 public key, or None for a
    malformed or off-curve key (the fixed-key lane's only on-curve
    check: such a key never gets a table and stays on the generic lane,
    which rejects it)."""
    if len(pubkey) != 65 or pubkey[0] != 0x04:
        return None
    qx = int.from_bytes(pubkey[1:33], "big")
    qy = int.from_bytes(pubkey[33:65], "big")
    if not on_curve(qx, qy):
        return None
    return comb_table_for_point(qx, qy)


class KeyTableCache:
    """LRU cache of host-side per-key comb tables, keyed by SEC1 pubkey.

    Thread-safe.  A table is (8192, 16) uint32 = 512 KB; 64 keys = 32 MB.
    The provider keeps tables device-resident instead
    (`ops/device_bank.DeviceBank`); this host cache serves tests and
    host-only tooling, as the reference's does.
    """

    def __init__(self, max_keys: int = 64):
        self.max_keys = max_keys
        self._lru: "OrderedDict[bytes, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self.stats = {"hits": 0, "builds": 0, "rejects": 0}

    def __contains__(self, pubkey: bytes) -> bool:
        with self._lock:
            return pubkey in self._lru

    def get(self, pubkey: bytes) -> Optional[np.ndarray]:
        with self._lock:
            tab = self._lru.get(pubkey)
            if tab is not None:
                self._lru.move_to_end(pubkey)
                self.stats["hits"] += 1
            return tab

    def get_or_build(self, pubkey: bytes) -> Optional[np.ndarray]:
        """Build (and cache) the table for an uncompressed SEC1 pubkey;
        returns None for malformed/off-curve keys."""
        tab = self.get(pubkey)
        if tab is not None:
            return tab
        tab = table_for_pubkey(pubkey)
        with self._lock:
            if tab is None:
                self.stats["rejects"] += 1
                return None
            self.stats["builds"] += 1
            self._lru[pubkey] = tab
            while len(self._lru) > self.max_keys:
                self._lru.popitem(last=False)
        return tab
