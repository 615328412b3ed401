"""Software (host) BCCSP provider — signing and correctness oracle.

Counterpart of `fabric_tpu/bccsp/sw.py`: ECDSA-P256 with low-S
enforcement on sign and verify, plus Ed25519, backed by the port's crypto
shim (`cryptography` when installed, else the pure-Python engines), and
idemix presentations verified on the host (`idemix.msp.verify_item_host`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .. import crypto
from . import provider as prov
from .provider import (VerifyItem, SCHEME_P256, SCHEME_ED25519,
                       SCHEME_IDEMIX)

P256_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
P256_HALF_N = (P256_N - 1) // 2


class SigningKey:
    """A host-side private key (scheme + crypto-shim key object)."""

    def __init__(self, scheme: str, key):
        self.scheme = scheme
        self._key = key

    def public_bytes(self) -> bytes:
        """Provider wire format: SEC1 uncompressed for p256, raw for ed25519."""
        if self.scheme == SCHEME_P256:
            return crypto.p256_public_bytes(self._key)
        return crypto.ed25519_public_bytes(self._key)

    @property
    def key(self):
        return self._key


def low_s(r: int, s: int) -> tuple:
    """Normalize an ECDSA-P256 signature to low-S."""
    if s > P256_HALF_N:
        s = P256_N - s
    return r, s


class SoftwareProvider(prov.Provider):
    name = "sw"

    def __init__(self, require_low_s: bool = True):
        self.require_low_s = require_low_s

    def key_gen(self, scheme: str) -> SigningKey:
        if scheme == SCHEME_P256:
            return SigningKey(scheme, crypto.p256_generate())
        if scheme == SCHEME_ED25519:
            return SigningKey(scheme, crypto.ed25519_generate())
        raise ValueError(f"unsupported scheme {scheme!r}")

    def sign(self, private_key: SigningKey, payload: bytes) -> bytes:
        """p256: payload is the 32B digest; ed25519: payload is the message."""
        if private_key.scheme == SCHEME_P256:
            r, s = low_s(*crypto.p256_sign_digest(private_key.key, payload))
            return crypto.encode_dss_signature(r, s)
        if private_key.scheme == SCHEME_ED25519:
            return crypto.ed25519_sign(private_key.key, payload)
        raise ValueError(f"unsupported scheme {private_key.scheme!r}")

    def _verify_one(self, it: VerifyItem) -> bool:
        try:
            if it.scheme == SCHEME_P256:
                # the same wire checks as the CUDA provider's packer, so
                # the two reject exactly the same malformed inputs
                if len(it.pubkey) != 65 or it.pubkey[0] != 0x04:
                    return False
                if len(it.payload) != 32:
                    return False
                r, s = crypto.decode_dss_signature(it.signature)
                if self.require_low_s and s > P256_HALF_N:
                    return False
                return crypto.p256_verify_digest(
                    it.pubkey, it.signature, it.payload)
            if it.scheme == SCHEME_ED25519:
                return crypto.ed25519_verify(
                    it.pubkey, it.signature, it.payload)
            if it.scheme == SCHEME_IDEMIX:
                from ..idemix.msp import verify_item_host
                return verify_item_host(it)
            return False
        except (crypto.InvalidSignature, ValueError, TypeError):
            return False

    def batch_verify(self, items: Sequence[VerifyItem]) -> np.ndarray:
        return np.array([self._verify_one(it) for it in items], dtype=bool)
