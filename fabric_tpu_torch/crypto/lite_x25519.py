"""Fallback X25519 API with cryptography-compatible surface (the
subset comm/secure.py uses for ephemeral key agreement).

Counterpart of `fabric_tpu/crypto/lite_x25519.py`, the same code on the port's
imports.
"""

from __future__ import annotations

import secrets

from fabric_tpu_torch.crypto import _x25519


class X25519PublicKey:
    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise ValueError("X25519 public keys are 32 bytes")
        self._raw = bytes(raw)

    @classmethod
    def from_public_bytes(cls, data: bytes) -> "X25519PublicKey":
        return cls(bytes(data))

    def public_bytes_raw(self) -> bytes:
        return self._raw


class X25519PrivateKey:
    def __init__(self, scalar: bytes):
        if len(scalar) != 32:
            raise ValueError("X25519 scalars are 32 bytes")
        self._scalar = bytes(scalar)
        self._pub = X25519PublicKey(_x25519.public_from_scalar(self._scalar))

    @classmethod
    def generate(cls) -> "X25519PrivateKey":
        return cls(secrets.token_bytes(32))

    @classmethod
    def from_private_bytes(cls, data: bytes) -> "X25519PrivateKey":
        return cls(bytes(data))

    def public_key(self) -> X25519PublicKey:
        return self._pub

    def exchange(self, peer_public_key: X25519PublicKey) -> bytes:
        shared = _x25519.x25519(self._scalar, peer_public_key._raw)
        if shared == b"\x00" * 32:
            raise ValueError("X25519 exchange produced the zero point")
        return shared
