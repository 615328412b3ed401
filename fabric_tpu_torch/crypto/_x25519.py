"""Pure-Python X25519 Diffie-Hellman (RFC 7748) — fallback engine for
the secure channel's ephemeral key agreement.

Counterpart of `fabric_tpu/crypto/_x25519.py`, the same code on the port's
imports.
"""

from __future__ import annotations

P = 2 ** 255 - 19
_A24 = 121665


def _decode_u(data: bytes) -> int:
    if len(data) != 32:
        raise ValueError("X25519 coordinates are 32 bytes")
    return int.from_bytes(data, "little") & ((1 << 255) - 1)


def _decode_scalar(data: bytes) -> int:
    if len(data) != 32:
        raise ValueError("X25519 scalars are 32 bytes")
    k = int.from_bytes(data, "little")
    k &= (1 << 254) - 8
    k |= 1 << 254
    return k


def x25519(scalar: bytes, u_bytes: bytes) -> bytes:
    k = _decode_scalar(scalar)
    u = _decode_u(u_bytes)
    x1 = u
    x2, z2 = 1, 0
    x3, z3 = u, 1
    swap = 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        if swap ^ kt:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % P
        aa = a * a % P
        b = (x2 - z2) % P
        bb = b * b % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        d = (x3 - z3) % P
        da = d * a % P
        cb = c * b % P
        x3 = (da + cb) % P
        x3 = x3 * x3 % P
        z3 = (da - cb) % P
        z3 = x1 * z3 * z3 % P
        x2 = aa * bb % P
        z2 = e * (aa + _A24 * e) % P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, -1, P) % P
    return out.to_bytes(32, "little")


BASE_U = (9).to_bytes(32, "little")


def public_from_scalar(scalar: bytes) -> bytes:
    return x25519(scalar, BASE_U)
